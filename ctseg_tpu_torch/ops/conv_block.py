"""Conv3x3 + InstanceNorm + PReLU: the hand-written CUDA kernels and their
plain versions.

Port of ctseg_tpu/ops/pallas/conv_block.py::fused_conv3x3_in_prelu (the
forward K2, and its float32 prototype ctseg_tpu/ops/pallas/conv_fused.py::
conv3x3_in_prelu) and of conv_block.py::in_prelu_bwd (K2b). The signature
and layouts are the JAX ones: x (N, H, W, Cin), w (3, 3, Cin, Cout), b
(Cout,), alpha (1,); the output is (N, H, W, Cout) in x's dtype.

  - On a CPU tensor it runs the plain PyTorch versions.
  - On a CUDA tensor it launches csrc/conv_block.cu, or raises: it never
    falls back to the plain version and never copies its inputs.

The forward has two routes on the card, chosen by a stated shape rule
(`conv_route`), not by a failure: the tensor-core kernels (`wgmma`:
bfloat16 directly, float32 by the split-TF32 scheme, the statistics started
in the conv's epilogue) take Cin and Cout that are multiples of 8 on
16-byte aligned tensors; every other shape goes to the FP32-pipe kernels,
whose launches are counted apart (`conv3x3_in_prelu.launches_simt`). A build
or launch error of either route raises.

`split_tf32`, `conv3x3_split_tf32_model`, `tile_stats` and
`combine_tile_stats` are plain PyTorch models of what the tensor-core route
computes (the three-product conv, the per-tile statistics and their
combination). Tests hold them to float64; nothing on a main path calls them.

Arithmetic, as in the Pallas kernel: the conv of the stored values (bf16 or
f32) accumulated in float32, + bias, then TWO-pass statistics (mean, then the
centred variance), eps 1e-5, PReLU. Unlike ops/instance_norm.py, which uses
the one-pass E[x^2] - E[x]^2 form: each port matches its own reference.

When autograd needs it, the call goes through an autograd.Function, as the
JAX op's custom VJP: the forward (train=True) also writes xhat in x's dtype
and rsinv (N, Cout) float32; the backward runs K2b (`in_prelu_bwd`) for dy
and dalpha, and takes the conv's dx, dw and db from
torch.ops.aten.convolution_backward on dy (cuDNN on the card), as the JAX
rule takes them from XLA, each only where its input needs a gradient.
Otherwise (serving) the forward writes out only, through the custom op
`ctseg::conv3x3_in_prelu` (ops/custom_ops.py) on every device.
"""

import torch
import torch.nn.functional as F

from ctseg_tpu_torch.ops import _build
from ctseg_tpu_torch.ops import custom_ops  # noqa: F401 (torch.ops.ctseg)

EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_C = 32  # channels per block of the FP32-pipe norm and the backward
TILE_M = 128  # output pixels per block of the tensor-core conv (kTcBM)


def _fwd_plain(x, w, b, alpha):
    """(out, xhat, rsinv): out and xhat (N, H, W, Cout) in x's dtype, rsinv
    (N, Cout) in float32 (float64 for float64 input)."""
    ctype = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(
        x.permute(0, 3, 1, 2).to(ctype),
        w.permute(3, 2, 0, 1).to(ctype),
        b.to(ctype),
        padding=1,
    )
    mean = y.mean(dim=(2, 3), keepdim=True)
    var = torch.square(y - mean).mean(dim=(2, 3), keepdim=True)
    rsinv = torch.rsqrt(var + EPS)
    xhat = (y - mean) * rsinv
    a = alpha.reshape(()).to(ctype)
    out = torch.where(xhat >= 0, xhat, a * xhat).to(x.dtype)
    return (out.permute(0, 2, 3, 1), xhat.to(x.dtype).permute(0, 2, 3, 1),
            rsinv.reshape(y.shape[:2]))


def conv3x3_in_prelu_plain(x, w, b, alpha):
    """Plain PyTorch version: F.conv2d + two-pass InstanceNorm + PReLU.

    The conv runs in float32 (float64 for float64 input) on the upcast
    stored values, like the kernel's float32 accumulation.
    """
    return _fwd_plain(x, w, b, alpha)[0]


def in_prelu_bwd_plain(g, xhat, rsinv, alpha):
    """Plain PyTorch version of K2b: (dy like g, dalpha (1,) in float32, or
    float64 for float64 g).

    g, xhat: (N, H, W, C); rsinv: (N, C).
    """
    ctype = torch.promote_types(g.dtype, torch.float32)
    g32 = g.to(ctype)
    xh = xhat.to(ctype)
    a = alpha.reshape(()).to(ctype)
    gh = torch.where(xh >= 0, g32, a * g32)
    m1 = gh.mean(dim=(1, 2), keepdim=True)
    m2 = (gh * xh).mean(dim=(1, 2), keepdim=True)
    scale = rsinv.to(ctype)[:, None, None, :]
    dy = (scale * (gh - m1 - xh * m2)).to(g.dtype)
    dalpha = (g32 * torch.clamp_max(xh, 0.0)).sum()
    return dy, dalpha.reshape(1)


def conv3x3_backward(dy, x, w, output_mask=(True, True, True)):
    """(dx, dw, db) of conv3x3_same(x, w) + b for the cotangent dy, in the
    JAX layouts: dy (N, H, W, Cout), x (N, H, W, Cin), w (3, 3, Cin, Cout).
    `output_mask` says which of the three to compute; the others come back
    as None (GradCAM wants dx only).

    torch's convolution backward (cuDNN on the card): the conv's own
    gradients are library work in both frameworks.
    """
    dx, dw, db = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2),
        x.permute(0, 3, 1, 2),
        # (Cout, Cin, 3, 3) laid out like the channels_last activations
        w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last),
        [w.shape[3]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        list(output_mask),
    )
    return (None if dx is None else dx.permute(0, 2, 3, 1),
            None if dw is None else dw.permute(2, 3, 1, 0), db)


def split_tf32(v: torch.Tensor):
    """(big, small) of a float32 tensor, as `cvt.rna.tf32.f32` makes them:
    big = v rounded to nearest (ties away from zero) to 10 mantissa bits,
    small = (v - big) rounded the same way. v = big + small up to about
    2^-22 |v|."""
    if v.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {v.dtype}")

    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    big = rna(v)
    return big, rna(v - big)


def conv3x3_split_tf32_model(x, w):
    """conv3x3_same(x, w) as the float32 tensor-core kernel takes it: each
    operand split by `split_tf32`, the product as a_small*b_big +
    a_big*b_small + a_big*b_big (products of tf32 values are exact in
    float32), summed in float32, small terms first. x (N, H, W, Cin), w (3,
    3, Cin, Cout) float32 -> (N, H, W, Cout) float32, no bias."""
    a_big, a_small = split_tf32(x.permute(0, 3, 1, 2))
    b_big, b_small = split_tf32(w.permute(3, 2, 0, 1))
    y = F.conv2d(a_small, b_big, padding=1)
    y = y + F.conv2d(a_big, b_small, padding=1)
    y = y + F.conv2d(a_big, b_big, padding=1)
    return y.permute(0, 2, 3, 1)


def tile_stats(y, tile: int = TILE_M):
    """What the conv's epilogue writes: y (N, S, C) cut along S into tiles
    of `tile` pixels (the last may be ragged) -> (count (tiles,), mean (N,
    tiles, C), m2 (N, tiles, C)) with m2 the tile's centred sum of squares."""
    parts = torch.split(y, tile, dim=1)
    count = torch.tensor([p.shape[1] for p in parts], dtype=y.dtype)
    mean = torch.stack([p.mean(dim=1) for p in parts], dim=1)
    m2 = torch.stack(
        [torch.square(p - p.mean(dim=1, keepdim=True)).sum(dim=1)
         for p in parts], dim=1)
    return count, mean, m2


def combine_tile_stats(count, mean, m2):
    """(mean, var) per (sample, channel) from the tiles' (count, mean, M2),
    combined in tile order by Chan's parallel form, as the finalize kernel
    does: var is the biased two-pass variance up to round-off."""
    na = torch.zeros((), dtype=mean.dtype)
    mu = torch.zeros_like(mean[:, 0])
    acc = torch.zeros_like(mu)
    for t in range(mean.shape[1]):
        nb = count[t]
        total = na + nb
        delta = mean[:, t] - mu
        mu = mu + delta * (nb / total)
        acc = acc + m2[:, t] + delta * delta * (na * nb / total)
        na = total
    return mu, acc / na


def conv_route(cin: int, cout: int, h: int, w: int, aligned: bool = True) -> str:
    """"tc" (tensor cores) or "simt" (FP32 pipes) for a forward on the card.

    The tensor-core kernel copies 16 bytes (4 float32, 8 bfloat16) at a time
    and stores channel pairs: it takes Cin and Cout that are multiples of 8,
    H and W below 32768 (a pixel's row and column share one register) and
    16-byte aligned tensors. Everything else is the FP32-pipe kernel's."""
    ok = cin % 8 == 0 and cout % 8 == 0 and max(h, w) < 32768 and aligned
    return "tc" if ok else "simt"


def conv_grid(n: int, h: int, w: int, cout: int):
    """The tensor-core conv's grid and the statistics workspace's shape:
    ((pixel tiles, channel tiles, N), (N, pixel tiles, Cout, 2)). Pixel tiles
    are cut per sample (TILE_M pixels, the last ragged), so no tile holds
    pixels of two samples; a block takes 128 channels where Cout is a
    multiple of 128, else 64."""
    tiles = -(-(h * w) // TILE_M)
    block_n = 128 if cout % 128 == 0 else 64
    return (tiles, -(-cout // block_n), n), (n, tiles, cout, 2)


def weights_workspace(cin: int, cout: int, itemsize: int):
    """Shape of the tensor-core conv's re-laid weights: (planes, 9, Cin
    rounded up to a pipeline step, Cout). A step is 128 bytes of input
    channels (32 float32, 64 bfloat16); float32 has two planes, the big and
    the small part of the split-TF32 scheme."""
    step = 128 // itemsize
    return (2 if itemsize == 4 else 1, 9, -(-cin // step) * step, cout)


def _check_shapes(x, w, b, alpha) -> None:
    if x.ndim != 4:
        raise ValueError(f"want x (N, H, W, Cin), got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(
            f"want w (3, 3, {cin}, Cout), got shape {tuple(w.shape)}"
        )
    if tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"want b ({w.shape[3]},), got shape {tuple(b.shape)}")
    if alpha.numel() != 1:
        raise ValueError(f"want one shared alpha, got shape {tuple(alpha.shape)}")


def _check_f32(device, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != device:
            raise TypeError(
                f"kernel wants {name} float32 on {device}, got {t.dtype} "
                f"on {t.device}"
            )


def _check_contiguous(device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(
                f"kernel wants {name} contiguous on {device} in the JAX "
                f"layout; got strides {tuple(t.stride())} on {t.device}"
            )


def _forward(x, w, b, alpha, train: bool):
    """(out, xhat, rsinv); xhat and rsinv are None unless `train`."""
    if x.device.type == "cpu":
        out, xhat, rsinv = _fwd_plain(x, w, b, alpha)
        return (out, xhat, rsinv) if train else (out, None, None)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(
            "kernel takes x and w both float32 or both bfloat16, got "
            f"{x.dtype} and {w.dtype}"
        )
    _check_f32(x.device, b=b, alpha=alpha)
    _check_contiguous(x.device, x=x, w=w, b=b)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if x.numel() == 0 or cout == 0 or n * h * wd * max(cin, cout) >= 2**31 \
            or n > 65535:
        raise ValueError(
            f"kernel does not take x {tuple(x.shape)} with Cout {cout}"
        )

    lib = _build.library()
    scratch = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x.device)
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    xhat = torch.empty_like(out) if train else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w))
    if conv_route(cin, cout, h, wd, aligned) == "tc":
        _, stats_shape = conv_grid(n, h, wd, cout)
        stats = torch.empty(stats_shape, dtype=torch.float32, device=x.device)
        mean = torch.empty((n, cout), dtype=torch.float32, device=x.device)
        rsinv = torch.empty((n, cout), dtype=torch.float32, device=x.device)
        # The weights as the conv stages them, laid out anew each call:
        # float32 as their big and small tf32 planes.
        wk = torch.empty(weights_workspace(cin, cout, x.element_size()),
                         dtype=x.dtype, device=x.device)
        err = lib.ctseg_conv3x3_in_prelu_fwd_tc(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), alpha.data_ptr(),
            scratch.data_ptr(), stats.data_ptr(), mean.data_ptr(),
            rsinv.data_ptr(), out.data_ptr(),
            None if xhat is None else xhat.data_ptr(),
            wk.data_ptr(),
            n, h, wd, cin, cout, _DTYPE_CODES[x.dtype], x.device.index, stream,
        )
        lib.check(err, "conv3x3_in_prelu (tensor cores)")
        conv3x3_in_prelu.launches += 1
        return out, xhat, rsinv if train else None
    rsinv = None
    if train:
        rsinv = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    err = lib.ctseg_conv3x3_in_prelu_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), alpha.data_ptr(),
        scratch.data_ptr(), out.data_ptr(),
        None if xhat is None else xhat.data_ptr(),
        None if rsinv is None else rsinv.data_ptr(),
        n, h, wd, cin, cout, _DTYPE_CODES[x.dtype], x.device.index, stream,
    )
    lib.check(err, "conv3x3_in_prelu (FP32 pipes)")
    conv3x3_in_prelu.launches += 1
    conv3x3_in_prelu.launches_simt += 1
    return out, xhat, rsinv


def in_prelu_bwd(g, xhat, rsinv, alpha):
    """K2b: (dy, dalpha) of PReLU(InstanceNorm(y)) from the saved xhat and
    rsinv, for the cotangent g. g, xhat: (N, H, W, C) of one dtype; rsinv:
    (N, C) float32. On CUDA, launches the kernel (dalpha summed from
    per-block partials with torch.sum, a fixed order) or raises."""
    if g.device.type == "cpu":
        return in_prelu_bwd_plain(g, xhat, rsinv, alpha)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    if g.ndim != 4 or xhat.shape != g.shape or xhat.dtype != g.dtype \
            or g.dtype not in _DTYPE_CODES:
        raise TypeError(
            "kernel wants g and xhat (N, H, W, C) of one dtype, float32 or "
            f"bfloat16; got {tuple(g.shape)} {g.dtype} and "
            f"{tuple(xhat.shape)} {xhat.dtype}"
        )
    n, h, wd, c = g.shape
    if tuple(rsinv.shape) != (n, c):
        raise ValueError(f"want rsinv ({n}, {c}), got {tuple(rsinv.shape)}")
    _check_f32(g.device, rsinv=rsinv, alpha=alpha)
    _check_contiguous(g.device, g=g, xhat=xhat, rsinv=rsinv)
    if g.numel() == 0 or g.numel() >= 2**31 or n > 65535:
        raise ValueError(f"kernel does not take shape {tuple(g.shape)}")

    lib = _build.library()
    dy = torch.empty_like(g)
    parts = torch.empty((n, -(-c // _TILE_C)), dtype=torch.float32,
                        device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.ctseg_in_prelu_bwd_saved(
        g.data_ptr(), xhat.data_ptr(), rsinv.data_ptr(), alpha.data_ptr(),
        dy.data_ptr(), parts.data_ptr(), n, h * wd, c,
        _DTYPE_CODES[g.dtype], g.device.index, stream,
    )
    lib.check(err, "in_prelu_bwd")
    in_prelu_bwd.launches += 1
    return dy, parts.sum().reshape(1)


class _ConvINPReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, alpha):
        out, xhat, rsinv = _forward(x, w, b, alpha, train=True)
        ctx.save_for_backward(x, w, alpha, xhat, rsinv)
        ctx.b_dtype = b.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, alpha, xhat, rsinv = ctx.saved_tensors
        # The cotangent of a view may be strided; the kernel reads NHWC rows.
        dy, dalpha = in_prelu_bwd(g.contiguous(), xhat, rsinv, alpha)
        dx, dw, db = conv3x3_backward(dy.to(x.dtype), x, w,
                                      ctx.needs_input_grad[:3])
        return (dx, dw, None if db is None else db.to(ctx.b_dtype),
                dalpha.to(alpha.dtype))


def conv3x3_in_prelu(x, w, b, alpha):
    """PReLU(InstanceNorm(conv3x3_same(x, w) + b)), NHWC."""
    _check_shapes(x, w, b, alpha)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w, b, alpha)
    ):
        return _ConvINPReLU.apply(x, w, b, alpha)
    return torch.ops.ctseg.conv3x3_in_prelu(x, w, b, alpha)


conv3x3_in_prelu.launches = 0  # K2 launches since the last reset, any route
conv3x3_in_prelu.launches_simt = 0  # those that took the FP32-pipe route
in_prelu_bwd.launches = 0  # K2b launches since the last reset
