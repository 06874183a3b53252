"""Building blocks of the UNet (port of ctseg_tpu/models/layers.py, 2D).

MONAI's `Convolution` / `ResidualUnit` as the reference configures them
(capstone/training/base_trainer.py:72-79): Conv -> InstanceNorm(affine=False,
eps=1e-5) -> PReLU(one shared slope, init 0.25). Module names follow MONAI's
so state_dict keys do (`conv`, `act`, `conv.unit{i}`, `residual`); the norm
has no parameters and is folded into the kernels below.

Activations are NCHW tensors stored channels_last, so `_nhwc(t)` is the
(N, H, W, C)-contiguous view the kernels take, with no copy. Every
IN+PReLU site calls ops.instance_norm.instance_norm_prelu, and every
stride-1 3x3 Conv+IN+PReLU unit calls ops.conv_block.conv3x3_in_prelu;
strided, transposed, shortcut and 1x1 convs stay torch convs (the JAX
package leaves them to XLA).

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


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> its (N, H, W, C) view; free for channels_last x."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 3, 1, 2)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv(x)` computed in x's dtype, the parameters cast at the call."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    conv.stride, conv.padding)


class ConvUnit(nn.Module):
    """Conv -> InstanceNorm -> PReLU (or conv only), MONAI `Convolution`.

    Strided convs use symmetric padding (k-1)//2, like torch and the JAX
    unit. The stride-1 3x3 unit runs as one conv3x3_in_prelu call, which
    takes the weight as (3, 3, Cin, Cout): the MONAI-shaped (Cout, Cin, 3, 3)
    parameter is permuted into that layout per call, one pass over the
    weight beside the conv's 2*9*Cin*Cout flops per output pixel.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 conv_only: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(
            in_channels, out_channels, kernel_size, stride=stride,
            padding=_same_padding(kernel_size),
        )
        self.act = None if conv_only else nn.PReLU(init=0.25)
        self.fused = not conv_only and stride == 1 and kernel_size == 3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act is None:
            return conv2d(self.conv, x)
        if self.fused:
            w = self.conv.weight.to(x.dtype).permute(2, 3, 1, 0).contiguous()
            return _nchw(conv3x3_in_prelu(
                _nhwc(x), w, self.conv.bias, self.act.weight
            ))
        return _nchw(instance_norm_prelu(
            _nhwc(conv2d(self.conv, x)), self.act.weight
        ))


class ConvTransposeUnit(nn.Module):
    """Transposed conv (out = in * stride) -> InstanceNorm -> PReLU.

    torch ConvTranspose(k, s, padding=(k-1)//2, output_padding=s-1), the
    convention the JAX unit mirrors.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 2,
                 conv_only: bool = False):
        super().__init__()
        self.conv = nn.ConvTranspose2d(
            in_channels, out_channels, kernel_size, stride=stride,
            padding=_same_padding(kernel_size), output_padding=stride - 1,
        )
        self.act = None if conv_only else nn.PReLU(init=0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = F.conv_transpose2d(
            x, c.weight.to(x.dtype), c.bias.to(x.dtype), c.stride, c.padding,
            c.output_padding,
        )
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
                 last_conv_only: bool = False):
        super().__init__()
        subunits = max(1, subunits)
        self.conv = nn.Sequential()
        cin, s = in_channels, stride
        for su in range(subunits):
            self.conv.add_module(f"unit{su}", ConvUnit(
                cin, out_channels, kernel_size, stride=s,
                conv_only=last_conv_only and su == subunits - 1,
            ))
            cin, s = out_channels, 1
        self.residual: nn.Module = nn.Identity()
        if stride != 1 or in_channels != out_channels:
            rkernel = kernel_size if stride != 1 else 1
            self.residual = nn.Conv2d(
                in_channels, out_channels, rkernel, stride=stride,
                padding=_same_padding(rkernel),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if isinstance(self.residual, nn.Identity) \
            else conv2d(self.residual, x)
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
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)
    return model
