"""Residual UNet with MONAI's module tree (port of ctseg_tpu/models/unet.py, 2D).

The reference trains `monai.networks.nets.UNet` (capstone/models/__init__.py:3,
configured at capstone/training/base_trainer.py:64-79). This builds the same
recursion, so state_dict keys are MONAI's and a reference Lightning `.ckpt`
loads with `load_state_dict`:

  unet.model.0                         down layer, level 0
  unet.model.1.submodule.0             down layer, level 1 ...
  unet.model.(1.submodule.)*D          bottom layer
  unet.model.(1.submodule.)*i.2        up layer, level i
  conv1x1                              the optional 3->1 input conv

  - num_res_units = 0: plain Conv->IN->PReLU units.
  - num_res_units > 0: ResidualUnits with that many subunits on the encoder
    and bottom; each decoder level appends a 1-subunit ResidualUnit after
    the transposed conv, conv-only at the top level.
  - Skip connections concatenate [skip, upsampled] along channels.

Inputs and outputs are NCHW tensors; keep them channels_last (see
models/layers.py).
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ctseg_tpu_torch.models.layers import (
    ConvTransposeUnit,
    ConvUnit,
    ResidualUnit,
    conv2d,
    reset_parameters,
)


class _SkipConnection(nn.Module):
    """cat([x, submodule(x)], dim=1), MONAI's SkipConnection."""

    def __init__(self, submodule: nn.Module):
        super().__init__()
        self.submodule = submodule

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, self.submodule(x)], dim=1)


class UNet(nn.Module):
    def __init__(
        self,
        in_channels: int,
        out_channels: int = 10,
        channels: Sequence[int] = (64, 128, 256, 512, 1024),
        strides: Sequence[int] = (2, 2, 2, 2),
        num_res_units: int = 0,
        kernel_size: int = 3,
        up_kernel_size: int = 3,
    ):
        super().__init__()
        if len(channels) != len(strides) + 1:
            raise ValueError("need one more channel spec than strides")
        self.num_res_units = num_res_units
        self.kernel_size = kernel_size
        self.up_kernel_size = up_kernel_size

        def block(inc, outc, chans, strds, is_top):
            c, s = chans[0], strds[0]
            if len(chans) > 2:
                sub = block(c, c, chans[1:], strds[1:], False)
                upc = 2 * c
            else:
                sub = self._down(c, chans[1], 1)
                upc = c + chans[1]
            return nn.Sequential(
                self._down(inc, c, s),
                _SkipConnection(sub),
                self._up(upc, outc, s, is_top),
            )

        self.model = block(
            in_channels, out_channels, list(channels), list(strides), True
        )

    def _down(self, inc: int, outc: int, stride: int) -> nn.Module:
        if self.num_res_units > 0:
            return ResidualUnit(inc, outc, self.kernel_size, stride,
                                subunits=self.num_res_units)
        return ConvUnit(inc, outc, self.kernel_size, stride)

    def _up(self, inc: int, outc: int, stride: int, is_top: bool) -> nn.Module:
        conv = ConvTransposeUnit(
            inc, outc, self.up_kernel_size, stride,
            conv_only=is_top and self.num_res_units == 0,
        )
        if self.num_res_units == 0:
            return conv
        ru = ResidualUnit(outc, outc, self.kernel_size, 1, subunits=1,
                          last_conv_only=is_top)
        return nn.Sequential(conv, ru)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class SegmentationModel(nn.Module):
    """UNet plus the optional 1x1 input-downsampling conv (in -> 1 channel)
    the reference's BaseUNet2D applies first when `downsample` is set
    (capstone/training/base_trainer.py:53,81-85).

    The parameters are made on the CPU, drawn from `generator` (a CPU
    torch.Generator) when one is given, then moved to `device`. `dtype` is
    the compute dtype: the input is cast to it and every unit computes in
    it, while the parameters stay float32 (float64 for a float64 model), as
    the JAX model keeps param_dtype apart from dtype.
    """

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 10,
        channels: Sequence[int] = (64, 128, 256, 512, 1024),
        strides: Optional[Sequence[int]] = None,
        num_res_units: int = 0,
        downsample: bool = False,
        device=None,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        channels = tuple(channels)
        strides = tuple(strides or (2,) * (len(channels) - 1))
        self.conv1x1 = nn.Conv2d(in_channels, 1, 1) if downsample else None
        self.unet = UNet(
            1 if downsample else in_channels, out_channels, channels, strides,
            num_res_units,
        )
        if generator is not None:
            reset_parameters(self, generator)
        self.compute_dtype = dtype or torch.float32
        param_dtype = (torch.float64 if self.compute_dtype == torch.float64
                       else torch.float32)
        self.to(device=device, dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) images -> (N, out_channels, H, W) logits in the
        compute dtype."""
        x = x.to(self.compute_dtype)
        if self.conv1x1 is not None:
            x = conv2d(self.conv1x1, x)
        return self.unet(x)
