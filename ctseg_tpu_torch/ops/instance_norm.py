"""InstanceNorm + PReLU: the hand-written CUDA kernels and their plain versions.

Port of ctseg_tpu/ops/pallas/instance_norm.py::fused_instance_norm_prelu,
forward (K1) and backward (K1b, its `_bwd_rule`). `instance_norm_prelu(x,
alpha)` takes x as (N, *spatial, C), the JAX layout, which is the NHWC view
`t.permute(0, 2, 3, 1)` of a channels_last activation, with no copy.

  - On a CPU tensor it runs the plain PyTorch versions.
  - On a CUDA tensor it launches csrc/instance_norm.cu, or raises: it never
    falls back to the plain version and never copies its input.

Statistics are the one-pass form of the Pallas kernel and of
models/layers.py::instance_norm_prelu: E[x] and E[x^2] in float32 (float64
for float64 input), var = E[x^2] - E[x]^2 clamped at 0, eps 1e-5.

When autograd needs it (grad enabled and x or alpha requiring grad), the
call goes through an autograd.Function: the forward also writes the
per-(sample, channel) mean and var (the residuals of the Pallas `_fwd_rule`)
and saves them with x; the backward (`instance_norm_prelu_bwd`) recomputes
xhat from them. Otherwise (serving, under inference_mode or no_grad) the
forward writes y only.
"""

import torch

from ctseg_tpu_torch.ops import _build

EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_C = 32  # channels per CUDA block (csrc/instance_norm.cu kTileC)


def _fwd_plain(x: torch.Tensor, alpha: torch.Tensor):
    """(y, mean, var): y like x; mean, var (N, C) in float32 (float64 for
    float64 input)."""
    ctype = torch.promote_types(x.dtype, torch.float32)
    axes = tuple(range(1, x.ndim - 1))
    x32 = x.to(ctype)
    mean = x32.mean(dim=axes, keepdim=True)
    mean_sq = (x32 * x32).mean(dim=axes, keepdim=True)
    var = torch.clamp_min(mean_sq - mean * mean, 0.0)
    xhat = (x32 - mean) * torch.rsqrt(var + EPS)
    a = alpha.reshape(()).to(ctype)
    y = torch.where(xhat >= 0, xhat, a * xhat).to(x.dtype)
    n, c = x.shape[0], x.shape[-1]
    return y, mean.reshape(n, c), var.reshape(n, c)


def instance_norm_prelu_plain(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, *spatial, C) -> same shape and dtype."""
    return _fwd_plain(x, alpha)[0]


def instance_norm_prelu_bwd_plain(x, g, mean, var, alpha):
    """Plain PyTorch version of K1b: (dx like x, dalpha (1,) like alpha).

    x, g: (N, *spatial, C); mean, var: (N, C) from the forward.
    """
    ctype = torch.promote_types(x.dtype, torch.float32)
    axes = tuple(range(1, x.ndim - 1))
    stat_shape = (x.shape[0],) + (1,) * len(axes) + (x.shape[-1],)
    inv = torch.rsqrt(var.to(ctype).reshape(stat_shape) + EPS)
    xhat = (x.to(ctype) - mean.to(ctype).reshape(stat_shape)) * inv
    g32 = g.to(ctype)
    a = alpha.reshape(()).to(ctype)
    gh = torch.where(xhat >= 0, g32, a * g32)
    m1 = gh.mean(dim=axes, keepdim=True)
    m2 = (gh * xhat).mean(dim=axes, keepdim=True)
    dx = (inv * (gh - m1 - xhat * m2)).to(x.dtype)
    dalpha = (g32 * torch.clamp_max(xhat, 0.0)).sum()
    return dx, dalpha.reshape(1).to(alpha.dtype)


def _check_shapes(x: torch.Tensor, alpha: torch.Tensor) -> None:
    if x.ndim < 3:
        raise ValueError(f"want (N, *spatial, C), got shape {tuple(x.shape)}")
    if alpha.numel() != 1:
        raise ValueError(f"want one shared alpha, got shape {tuple(alpha.shape)}")


def _check_cuda(x: torch.Tensor, alpha: torch.Tensor, **others) -> tuple:
    """Raise on what the kernels do not take; returns (n, s, c)."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    for name, t in {"x": x, **others}.items():
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"kernel wants {name} contiguous on {x.device} in (N, "
                "*spatial, C) order (the NHWC view of a channels_last tensor);"
                f" got strides {tuple(t.stride())} on {t.device}"
            )
    if alpha.dtype != torch.float32 or alpha.device != x.device:
        raise TypeError(
            f"kernel wants alpha float32 on {x.device}, got {alpha.dtype} "
            f"on {alpha.device}"
        )
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // max(n * c, 1)
    if x.numel() == 0 or x.numel() >= 2**31 or n > 65535:
        raise ValueError(f"kernel does not take shape {tuple(x.shape)}")
    return n, s, c


def _forward(x: torch.Tensor, alpha: torch.Tensor, train: bool):
    """(y, mean, var); mean and var are None unless `train`."""
    if x.device.type == "cpu":
        y, mean, var = _fwd_plain(x, alpha)
        return (y, mean, var) if train else (y, None, None)
    n, s, c = _check_cuda(x, alpha)
    lib = _build.library()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mean = var = None
    if train:
        mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
        var = torch.empty((n, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ctseg_in_prelu_fwd(
        x.data_ptr(), y.data_ptr(), alpha.data_ptr(),
        None if mean is None else mean.data_ptr(),
        None if var is None else var.data_ptr(), n, s, c,
        _DTYPE_CODES[x.dtype], x.device.index, stream,
    )
    lib.check(err, "instance_norm_prelu")
    instance_norm_prelu.launches += 1
    return y, mean, var


def instance_norm_prelu_bwd(x, g, mean, var, alpha):
    """K1b: (dx, dalpha) of PReLU(InstanceNorm(x)) for the cotangent g.

    x, g: (N, *spatial, C) of one dtype; mean, var: (N, C) from the training
    forward. On CUDA, launches the kernel (dalpha summed from per-block
    partials with torch.sum, a fixed order) or raises.
    """
    _check_shapes(x, alpha)
    if x.device.type == "cpu":
        return instance_norm_prelu_bwd_plain(x, g, mean, var, alpha)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise TypeError(
            f"want g like x {tuple(x.shape)} {x.dtype}, got "
            f"{tuple(g.shape)} {g.dtype}"
        )
    for name, t in (("mean", mean), ("var", var)):
        if t.dtype != torch.float32 or t.shape != (x.shape[0], x.shape[-1]):
            raise TypeError(
                f"kernel wants {name} (N, C) float32, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
    n, s, c = _check_cuda(x, alpha, g=g, mean=mean, var=var)
    lib = _build.library()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    parts = torch.empty((n, -(-c // _TILE_C)), dtype=torch.float32,
                        device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ctseg_in_prelu_bwd(
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), var.data_ptr(),
        alpha.data_ptr(), dx.data_ptr(), parts.data_ptr(), n, s, c,
        _DTYPE_CODES[x.dtype], x.device.index, stream,
    )
    lib.check(err, "instance_norm_prelu_bwd")
    instance_norm_prelu_bwd.launches += 1
    return dx, parts.sum().reshape(1)


class _InstanceNormPReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        y, mean, var = _forward(x, alpha, train=True)
        ctx.save_for_backward(x, mean, var, alpha)
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, var, alpha = ctx.saved_tensors
        # The cotangent of a view (a slice of a skip concatenation, a
        # permute) may be strided; the kernel reads (N, *spatial, C) rows.
        return instance_norm_prelu_bwd(x, g.contiguous(), mean, var, alpha)


def instance_norm_prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU(InstanceNorm(x)) over (N, *spatial, C); output in x's dtype."""
    _check_shapes(x, alpha)
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad):
        return _InstanceNormPReLU.apply(x, alpha)
    return _forward(x, alpha, train=False)[0]


instance_norm_prelu.launches = 0  # K1 launches since the last reset
instance_norm_prelu_bwd.launches = 0  # K1b launches since the last reset
