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
(N, *spatial, C)-contiguous view the kernels take, with no copy (in
float32 training, a 3D transposed conv into at most SHALLOW_CHANNELS
channels runs contiguous: see ConvTransposeUnit). Every IN+PReLU site calls
ops.instance_norm.instance_norm_prelu, and every 2D stride-1 3x3
Conv+IN+PReLU unit calls ops.conv_block.conv3x3_in_prelu;
strided, transposed, shortcut and 1x1 convs, and the 3D stride-1 units'
convs, stay torch convs followed by the norm kernel (the JAX package
leaves them to XLA; its fused conv kernel is 2D only,
ops/pallas/conv_block.py:91).

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
from ctseg_tpu_torch.ops.instance_norm import instance_norm_prelu


def _same_padding(kernel_size: int) -> int:
    return (kernel_size - 1) // 2


_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_CONV_FN = {4: F.conv2d, 5: F.conv3d}
_CONV_T_FN = {4: F.conv_transpose2d, 5: F.conv_transpose3d}
# Out channels up to which a float32 3D transposed conv runs on contiguous
# input in training.
SHALLOW_CHANNELS = 16


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


def conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`conv(x)` computed in x's dtype, the parameters cast at the call."""
    return _CONV_FN[x.ndim](x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                            conv.stride, conv.padding)


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
        self.fused = (not conv_only and stride == 1 and kernel_size == 3
                      and spatial_dims == 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act is None:
            return conv(self.conv, x)
        if self.fused:
            w = self.conv.weight.to(x.dtype).permute(2, 3, 1, 0).contiguous()
            return _nchw(conv3x3_in_prelu(
                _nhwc(x), w, self.conv.bias, self.act.weight
            ))
        return _nchw(instance_norm_prelu(
            _nhwc(conv(self.conv, x)), self.act.weight
        ))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made (N, C, *spatial)-contiguous: the
    layout cuDNN picks for a conv's backward follows its output gradient as
    much as its input."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        # cuDNN's FP32 weight gradient of a 3D transposed conv into few
        # channels is about 8x slower on channels_last_3d tensors than on
        # contiguous ones (csrc/tools/probe_conv3d_fp32.py --sites): when a
        # gradient is taken in float32, such a conv runs on (N, C,
        # D...)-contiguous input and output gradient (bfloat16 is faster
        # channels_last_3d). `_nhwc` takes its output back to
        # channels_last_3d for the norm kernel.
        shallow = (x.ndim == 5 and c.out_channels <= SHALLOW_CHANNELS
                   and x.dtype == torch.float32 and torch.is_grad_enabled())
        if shallow:
            x = x.contiguous()
        y = _CONV_T_FN[x.ndim](
            x, c.weight.to(x.dtype), c.bias.to(x.dtype), c.stride, c.padding,
            c.output_padding,
        )
        if shallow:
            y = _ContiguousGrad.apply(y)
        if self.act is None:
            return y
        return _nchw(instance_norm_prelu(_nhwc(y), self.act.weight))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if isinstance(self.residual, nn.Identity) \
            else conv(self.residual, x)
        return res + self.conv(x)


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
