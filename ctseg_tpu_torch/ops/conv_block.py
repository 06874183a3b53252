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

Arithmetic, as in the Pallas kernel: the conv of the stored values (bf16 or
f32) accumulated in float32, + bias, then TWO-pass statistics (mean, then the
centred variance), eps 1e-5, PReLU. Unlike ops/instance_norm.py, which uses
the one-pass E[x^2] - E[x]^2 form: each port matches its own reference.

When autograd needs it, the call goes through an autograd.Function, as the
JAX op's custom VJP: the forward (train=True) also writes xhat in x's dtype
and rsinv (N, Cout) float32; the backward runs K2b (`in_prelu_bwd`) for dy
and dalpha, and takes the conv's dx, dw and db from
torch.ops.aten.convolution_backward on dy (cuDNN on the card), as the JAX
rule takes them from XLA.
"""

import torch
import torch.nn.functional as F

from ctseg_tpu_torch.ops import _build

EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_C = 32  # channels per block of the norm and backward kernels


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


def conv3x3_backward(dy, x, w):
    """(dx, dw, db) of conv3x3_same(x, w) + b for the cotangent dy, in the
    JAX layouts: dy (N, H, W, Cout), x (N, H, W, Cin), w (3, 3, Cin, Cout).

    torch's convolution backward (cuDNN on the card): the conv's own
    gradients are library work in both frameworks.
    """
    dx, dw, db = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2),
        x.permute(0, 3, 1, 2),
        # (Cout, Cin, 3, 3) laid out like the channels_last activations
        w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last),
        [w.shape[3]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [True, True, True],
    )
    return dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0), db


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
    xhat = rsinv = None
    if train:
        xhat = torch.empty_like(out)
        rsinv = torch.empty((n, cout), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ctseg_conv3x3_in_prelu_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), alpha.data_ptr(),
        scratch.data_ptr(), out.data_ptr(),
        None if xhat is None else xhat.data_ptr(),
        None if rsinv is None else rsinv.data_ptr(),
        n, h, wd, cin, cout, _DTYPE_CODES[x.dtype], x.device.index, stream,
    )
    lib.check(err, "conv3x3_in_prelu")
    conv3x3_in_prelu.launches += 1
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
        dx, dw, db = conv3x3_backward(dy.to(x.dtype), x, w)
        return dx, dw, db.to(ctx.b_dtype), dalpha.to(alpha.dtype)


def conv3x3_in_prelu(x, w, b, alpha):
    """PReLU(InstanceNorm(conv3x3_same(x, w) + b)), NHWC."""
    _check_shapes(x, w, b, alpha)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w, b, alpha)
    ):
        return _ConvINPReLU.apply(x, w, b, alpha)
    return _forward(x, w, b, alpha, train=False)[0]


conv3x3_in_prelu.launches = 0  # K2 launches since the last reset
in_prelu_bwd.launches = 0  # K2b launches since the last reset
