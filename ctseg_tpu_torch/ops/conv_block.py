"""Conv3x3 + InstanceNorm + PReLU: the hand-written CUDA kernel and its plain
version.

Port of ctseg_tpu/ops/pallas/conv_block.py::fused_conv3x3_in_prelu (the
forward, train=False) and of its float32 prototype
ctseg_tpu/ops/pallas/conv_fused.py::conv3x3_in_prelu. The signature and
layouts are the JAX ones: x (N, H, W, Cin), w (3, 3, Cin, Cout), b (Cout,),
alpha (1,); the output is (N, H, W, Cout) in x's dtype.

  - On a CPU tensor it runs `conv3x3_in_prelu_plain`.
  - On a CUDA tensor it launches csrc/conv_block.cu, or raises: it never
    falls back to the plain version and never copies its inputs.

Arithmetic, as in the Pallas kernel: the conv of the stored values (bf16 or
f32) accumulated in float32, + bias, then TWO-pass statistics (mean, then the
centred variance), eps 1e-5, PReLU. Unlike ops/instance_norm.py, which uses
the one-pass E[x^2] - E[x]^2 form: each port matches its own reference.
Forward-only, like ops/instance_norm.py.
"""

import torch
import torch.nn.functional as F

from ctseg_tpu_torch.ops import _build

EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_in_prelu_plain(x, w, b, alpha):
    """Plain PyTorch version: F.conv2d + two-pass InstanceNorm + PReLU.

    The conv runs in float32 (float64 for float64 input) on the upcast
    stored values, like the kernel's float32 accumulation.
    """
    ctype = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(
        x.permute(0, 3, 1, 2).to(ctype),
        w.permute(3, 2, 0, 1).to(ctype),
        b.to(ctype),
        padding=1,
    )
    mean = y.mean(dim=(2, 3), keepdim=True)
    var = torch.square(y - mean).mean(dim=(2, 3), keepdim=True)
    xhat = (y - mean) * torch.rsqrt(var + EPS)
    a = alpha.reshape(()).to(ctype)
    out = torch.where(xhat >= 0, xhat, a * xhat).to(x.dtype)
    return out.permute(0, 2, 3, 1)


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


def conv3x3_in_prelu(x, w, b, alpha):
    """PReLU(InstanceNorm(conv3x3_same(x, w) + b)), NHWC."""
    _check_shapes(x, w, b, alpha)
    if x.device.type == "cpu":
        return conv3x3_in_prelu_plain(x, w, b, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(
            "kernel takes x and w both float32 or both bfloat16, got "
            f"{x.dtype} and {w.dtype}"
        )
    for name, t in (("b", b), ("alpha", alpha)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError(
                f"kernel wants {name} float32 on {x.device}, got {t.dtype} "
                f"on {t.device}"
            )
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"kernel wants {name} contiguous on {x.device} in the JAX "
                f"layout; got strides {tuple(t.stride())} on {t.device}"
            )
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w, b, alpha)
    ):
        raise RuntimeError(
            "the CUDA kernel is forward-only: run under torch.inference_mode()"
        )
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ctseg_conv3x3_in_prelu_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), alpha.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), n, h, wd, cin, cout,
        _DTYPE_CODES[x.dtype], x.device.index, stream,
    )
    lib.check(err, "conv3x3_in_prelu")
    conv3x3_in_prelu.launches += 1
    return out


conv3x3_in_prelu.launches = 0  # kernel launches since the last reset
