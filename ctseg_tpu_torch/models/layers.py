"""Building blocks of the UNet (port of ctseg_tpu/models/layers.py).

MONAI's `Convolution` / `ResidualUnit` as the reference configures them
(capstone/training/base_trainer.py:72-79): Conv -> InstanceNorm(affine=False,
eps=1e-5) -> PReLU(one shared slope, init 0.25). Module names follow MONAI's
so state_dict keys do (`conv`, `act`, `conv.unit{i}`, `residual`); the norm
has no parameters and is folded into the kernels below.

One code path serves 2D and 3D, as in the reference: a module is built for
`spatial_dims` 2 or 3 (its parameters' shapes depend on it) and each call
takes the rank from its input. Activations are (N, C, *spatial) tensors
stored channels_last (channels_last_3d in 3D), so `_nhwc(t)` is the
(N, *spatial, C)-contiguous view the kernels take, with no copy. Every IN+PReLU site calls
ops.instance_norm.instance_norm_prelu, and every 2D stride-1 3x3
Conv+IN+PReLU unit calls ops.conv_block.conv3x3_in_prelu;
strided, transposed, shortcut and 1x1 convs, and the 3D stride-1 units'
convs, stay torch convs followed by the norm kernel (the JAX package
leaves them to XLA; its fused conv kernel is 2D only,
ops/pallas/conv_block.py:91). Where the JAX units route a conv to
ops/shallow_grad.py (a shallow stride-1 3D conv, a k=3 s=2 transposed conv
into few channels) and a gradient is taken, the port's units call the
same forward with the shallow weight gradient, ops/shallow_grad.py, on a
depth slab as on the whole volume (the depth gate read on the global
depth).

Depth sharding: every unit's forward takes `space`, a
parallel/collectives.py::DepthShard when x is this rank's depth slab of a
3D activation (models/unet.py decides per level). Then every conv whose
kernel spans depth (the stride-1 and strided convs, the transposed convs,
the residual shortcut) runs on the slab extended by its halo rows
(`DepthShard.conv`, `conv_transpose`), and the norm is K1's split form
(ops/instance_norm.py::instance_norm_prelu_split) with statistics summed
over the slabs. Without `space` nothing changes.

Parameters stay float32 (float64 in the float64 tests) and the units
compute in their input's dtype, as the JAX model's dtype/param_dtype split
does: conv weights and biases are cast to it at the call, while the
kernels take the PReLU slope and the fused unit's bias in float32 (their
statistics and bias add are float32).
"""

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctseg_tpu_torch.ops.conv_block import conv3x3_in_prelu
from ctseg_tpu_torch.ops.shallow_grad import (
    conv_smallc,
    conv_transpose_smallc,
    smallc_supported,
)
from ctseg_tpu_torch.ops.instance_norm import (
    instance_norm_prelu,
    instance_norm_prelu_split,
)


def _same_padding(kernel_size: int) -> int:
    return (kernel_size - 1) // 2


_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_CONV_FN = {4: F.conv2d, 5: F.conv3d}
_CONV_T_FN = {4: F.conv_transpose2d, 5: F.conv_transpose3d}


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """x (N, C, *spatial) stored channels_last for its rank."""
    fmt = torch.channels_last_3d if x.ndim == 5 else torch.channels_last
    return x.contiguous(memory_format=fmt)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """(N, C, *spatial) -> its (N, *spatial, C) view; free for x stored
    channels_last."""
    return channels_last(x).permute(0, *range(2, x.ndim), 1)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, y.ndim - 1, *range(1, y.ndim - 1))


def conv(conv: nn.Module, x: torch.Tensor, space=None,
         fn=None) -> torch.Tensor:
    """`conv(x)` computed in x's dtype, the parameters cast at the call; on
    a depth slab (`space`) with its halo. `fn` takes F.conv3d's arguments
    (default: the library conv of x's rank)."""
    fn = fn or _CONV_FN[x.ndim]
    w, b = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
    if space is None:
        return fn(x, w, b, conv.stride, conv.padding)
    return space.conv(fn, x, w, b, conv.stride, conv.padding,
                      conv.kernel_size[-1])


def _takes_grad(x: torch.Tensor, module: nn.Module) -> bool:
    """Whether autograd records a call of `module` on x."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))


def _norm(y: torch.Tensor, alpha: torch.Tensor, space) -> torch.Tensor:
    """IN + PReLU of an (N, *spatial, C) view; over every slab on a depth
    slab."""
    if space is None:
        return instance_norm_prelu(y, alpha)
    return instance_norm_prelu_split(y, alpha, space.group, space.n)


class ConvUnit(nn.Module):
    """Conv -> InstanceNorm -> PReLU (or conv only), MONAI `Convolution`.

    Strided convs use symmetric padding (k-1)//2, like torch and the JAX
    unit. The 2D stride-1 3x3 unit runs as one conv3x3_in_prelu call, which
    takes the weight as (3, 3, Cin, Cout): the MONAI-shaped (Cout, Cin, 3, 3)
    parameter is permuted into that layout per call, one pass over the
    weight beside the conv's 2*9*Cin*Cout flops per output pixel.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 conv_only: bool = False, spatial_dims: int = 2):
        super().__init__()
        self.conv = _CONV[spatial_dims](
            in_channels, out_channels, kernel_size, stride=stride,
            padding=_same_padding(kernel_size),
        )
        self.act = None if conv_only else nn.PReLU(init=0.25)
        self.stride = stride
        self.fused = (not conv_only and stride == 1 and kernel_size == 3
                      and spatial_dims == 2)

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        if self.fused:
            w = self.conv.weight.to(x.dtype).permute(2, 3, 1, 0).contiguous()
            return _nchw(conv3x3_in_prelu(
                _nhwc(x), w, self.conv.bias, self.act.weight
            ))
        y = self._conv(x, space)
        if self.act is None:
            return y
        return _nchw(_norm(_nhwc(y), self.act.weight, space))

    def _conv(self, x: torch.Tensor, space) -> torch.Tensor:
        """The conv; where the JAX unit routes it to conv_smallc (a shallow
        stride-1 3D conv, ops/shallow_grad.py) and a gradient is taken, the
        same forward with the shallow weight gradient. The depth gate reads
        the global depth, as the JAX unit sees it on its spatial mesh: a
        slab's times the slabs."""
        c = self.conv
        depth = None if x.ndim != 5 else \
            x.shape[-1] * (1 if space is None else space.n)
        routed = smallc_supported(
            c.in_channels, c.out_channels, c.stride[0], c.kernel_size[0],
            ndim=x.ndim - 2, depth=depth) and _takes_grad(x, c)
        return conv(c, x, space, conv_smallc if routed else None)


class ConvTransposeUnit(nn.Module):
    """Transposed conv (out = in * stride) -> InstanceNorm -> PReLU.

    torch ConvTranspose(k, s, padding=(k-1)//2, output_padding=s-1), the
    convention the JAX unit mirrors.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 2,
                 conv_only: bool = False, spatial_dims: int = 2):
        super().__init__()
        self.conv = _CONV_T[spatial_dims](
            in_channels, out_channels, kernel_size, stride=stride,
            padding=_same_padding(kernel_size), output_padding=stride - 1,
        )
        self.act = None if conv_only else nn.PReLU(init=0.25)

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        c = self.conv
        w, b = c.weight.to(x.dtype), c.bias.to(x.dtype)
        routed = smallc_supported(
            c.in_channels, c.out_channels, c.stride[0], c.kernel_size[0],
            transpose=True, ndim=x.ndim - 2) and _takes_grad(x, c)
        # The top decoder level's transposed conv: the same forward, the
        # shallow weight gradient (ops/shallow_grad.py), on a slab too.
        if routed and space is None:
            y = conv_transpose_smallc(x, w, b, c.stride[0], c.kernel_size[0])
        elif routed:
            y = space.conv_transpose_smallc(conv_transpose_smallc, x, w, b,
                                            c.stride[0], c.kernel_size[0])
        elif space is None:
            y = _CONV_T_FN[x.ndim](x, w, b, c.stride, c.padding,
                                   c.output_padding)
        else:
            y = space.conv_transpose(_CONV_T_FN[x.ndim], x, w, b, c.stride,
                                     c.padding, c.output_padding,
                                     c.kernel_size[-1])
        if self.act is None:
            return y
        return _nchw(_norm(_nhwc(y), self.act.weight, space))


class ResidualUnit(nn.Module):
    """MONAI `ResidualUnit`: `subunits` ConvUnits plus a shortcut.

    The first subunit carries the stride and the channel change. The
    shortcut is the identity when shapes match, else a conv with kernel
    `kernel_size` when strided or 1x1 when only the channels change.
    `last_conv_only` drops norm+act from the final subunit.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, subunits: int = 2,
                 last_conv_only: bool = False, spatial_dims: int = 2):
        super().__init__()
        subunits = max(1, subunits)
        self.stride = stride
        self.conv = nn.Sequential()
        cin, s = in_channels, stride
        for su in range(subunits):
            self.conv.add_module(f"unit{su}", ConvUnit(
                cin, out_channels, kernel_size, stride=s,
                conv_only=last_conv_only and su == subunits - 1,
                spatial_dims=spatial_dims,
            ))
            cin, s = out_channels, 1
        self.residual: nn.Module = nn.Identity()
        if stride != 1 or in_channels != out_channels:
            rkernel = kernel_size if stride != 1 else 1
            self.residual = _CONV[spatial_dims](
                in_channels, out_channels, rkernel, stride=stride,
                padding=_same_padding(rkernel),
            )

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        res = x if isinstance(self.residual, nn.Identity) \
            else conv(self.residual, x, space)
        out = x
        for unit in self.conv:
            out = unit(out, space)
        return res + out


def reset_parameters(model: nn.Module,
                     generator: Optional[torch.Generator] = None) -> nn.Module:
    """Torch-default init drawn from `generator`, in place.

    Conv and ConvTranspose weights and biases ~ U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) with torch's fan_in (weight.size(1) * k*k, which for a
    ConvTranspose is its OUT channels), i.e. kaiming_uniform(a=sqrt(5));
    PReLU slopes 0.25.
    """
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.conv._ConvNd):
                fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)
    return model
