"""InstanceNorm + PReLU: the hand-written CUDA kernel and its plain version.

Port of ctseg_tpu/ops/pallas/instance_norm.py::fused_instance_norm_prelu
(forward). `instance_norm_prelu(x, alpha)` takes x as (N, *spatial, C), the
JAX layout, which is the NHWC view `t.permute(0, 2, 3, 1)` of a
channels_last activation, with no copy.

  - On a CPU tensor it runs `instance_norm_prelu_plain`.
  - On a CUDA tensor it launches csrc/instance_norm.cu, or raises: it never
    falls back to the plain version and never copies its input.

Statistics are the one-pass form of the Pallas kernel and of
models/layers.py::instance_norm_prelu: E[x] and E[x^2] in float32 (float64
for float64 input), var = E[x^2] - E[x]^2 clamped at 0, eps 1e-5. The kernel
is forward-only: serving runs under torch.inference_mode(), and the
backward comes with the training slice.
"""

import torch

from ctseg_tpu_torch.ops import _build

EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def instance_norm_prelu_plain(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, *spatial, C) -> same shape and dtype."""
    ctype = torch.promote_types(x.dtype, torch.float32)
    axes = tuple(range(1, x.ndim - 1))
    x32 = x.to(ctype)
    mean = x32.mean(dim=axes, keepdim=True)
    mean_sq = (x32 * x32).mean(dim=axes, keepdim=True)
    var = torch.clamp_min(mean_sq - mean * mean, 0.0)
    xhat = (x32 - mean) * torch.rsqrt(var + EPS)
    a = alpha.reshape(()).to(ctype)
    return torch.where(xhat >= 0, xhat, a * xhat).to(x.dtype)


def _check_shapes(x: torch.Tensor, alpha: torch.Tensor) -> None:
    if x.ndim < 3:
        raise ValueError(f"want (N, *spatial, C), got shape {tuple(x.shape)}")
    if alpha.numel() != 1:
        raise ValueError(f"want one shared alpha, got shape {tuple(alpha.shape)}")


def instance_norm_prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU(InstanceNorm(x)) over (N, *spatial, C); output in x's dtype."""
    _check_shapes(x, alpha)
    if x.device.type == "cpu":
        return instance_norm_prelu_plain(x, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            "kernel wants x contiguous in (N, *spatial, C) order (the NHWC "
            "view of a channels_last tensor); got strides "
            f"{tuple(x.stride())}"
        )
    if alpha.dtype != torch.float32 or alpha.device != x.device:
        raise TypeError(
            f"kernel wants alpha float32 on {x.device}, got {alpha.dtype} "
            f"on {alpha.device}"
        )
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad):
        raise RuntimeError(
            "the CUDA kernel is forward-only: run under torch.inference_mode()"
        )
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // max(n * c, 1)
    if x.numel() == 0 or x.numel() >= 2**31 or n > 65535:
        raise ValueError(f"kernel does not take shape {tuple(x.shape)}")

    lib = _build.library()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ctseg_in_prelu_fwd(
        x.data_ptr(), y.data_ptr(), alpha.data_ptr(), n, s, c,
        _DTYPE_CODES[x.dtype], x.device.index, stream,
    )
    lib.check(err, "instance_norm_prelu")
    instance_norm_prelu.launches += 1
    return y


instance_norm_prelu.launches = 0  # kernel launches since the last reset
