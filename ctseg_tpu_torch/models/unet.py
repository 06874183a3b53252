"""Residual UNet with MONAI's module tree (port of ctseg_tpu/models/unet.py).

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

Inputs and outputs are (N, C, *spatial) tensors, 2D (N, C, H, W) or 3D
(N, C, H, W, D) as `spatial_dims` says; keep them channels_last (see
models/layers.py). The reference's TPU layout switches (`packed_depth`,
`packed_up_fwd`, `polyphase_up`) have no counterpart.

Depth sharding (`spatial_mesh`, a ('data', 'space') parallel/mesh.py::Mesh;
the JAX UNet.spatial_mesh): a 3D input is this rank's depth slab, and so is
the output. Each level keeps the JAX `_constrain_depth` rule: its
activation stays sharded while its depth d divides into n slabs of at least
`min_depth_per_shard` (2) rows, and its units then run on the slab with
conv halos and the split norm (models/layers.py). Below that the level's
input is all-gathered (with its gradient), the level computes replicated,
and where a level above is sharded again its output is sliced back to the
slab. The GSPMD fence itself has no counterpart: what it guarded, the halo
exchanges and the gather, is explicit here.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ctseg_tpu_torch.parallel.collectives import depth_shard
from ctseg_tpu_torch.models.layers import (
    ConvTransposeUnit,
    ConvUnit,
    ResidualUnit,
    conv,
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
        spatial_dims: int = 2,
    ):
        super().__init__()
        if len(channels) != len(strides) + 1:
            raise ValueError("need one more channel spec than strides")
        self.spatial_mesh = None  # see the module's docstring
        self.min_depth_per_shard = 2
        self.spatial_dims = spatial_dims
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
                                subunits=self.num_res_units,
                                spatial_dims=self.spatial_dims)
        return ConvUnit(inc, outc, self.kernel_size, stride,
                        spatial_dims=self.spatial_dims)

    def _up(self, inc: int, outc: int, stride: int, is_top: bool) -> nn.Module:
        conv = ConvTransposeUnit(
            inc, outc, self.up_kernel_size, stride,
            conv_only=is_top and self.num_res_units == 0,
            spatial_dims=self.spatial_dims,
        )
        if self.num_res_units == 0:
            return conv
        ru = ResidualUnit(outc, outc, self.kernel_size, 1, subunits=1,
                          last_conv_only=is_top,
                          spatial_dims=self.spatial_dims)
        return nn.Sequential(conv, ru)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = depth_shard(self.spatial_mesh, self.min_depth_per_shard)
        if shard is None or x.ndim != 5:
            return self.model(x)
        y, sharded = self._block(self.model, x, True, x.shape[-1] * shard.n,
                                 shard)
        return y if sharded else shard.slab(y)

    def _block(self, block: nn.Sequential, x, sharded: bool, d: int, shard):
        """One level of the recursion on x of global depth d: (output, whether
        it is a slab). Both halves of the skip concatenation come out in
        their level's layout."""
        down, skip, up = block
        d_mid = d // down.stride
        x, sharded = _apply(down, x, sharded, d_mid, shard)
        sub = skip.submodule
        if isinstance(sub, nn.Sequential):
            inner, _ = self._block(sub, x, sharded, d_mid, shard)
        else:  # the bottom unit
            inner, _ = _apply(sub, x, sharded, d_mid, shard)
        return _apply(up, torch.cat([x, inner], dim=1), sharded, d, shard)


def _apply(module: nn.Module, x, sharded: bool, d_out: int, shard):
    """`module` on x (a slab when `sharded`) into a level of global depth
    d_out: on the slab with halos while both levels are sharded, else
    replicated on the gathered depth, sliced back where d_out is sharded."""
    keep = shard.sharded(d_out)
    if sharded and keep:
        return _call(module, x, shard), True
    if sharded:
        x = shard.gather(x)
    y = _call(module, x, None)
    return (shard.slab(y), True) if keep else (y, False)


def _call(module: nn.Module, x, space):
    for m in (module if isinstance(module, nn.Sequential) else (module,)):
        x = m(x, space)
    return x


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
        spatial_dims: int = 2,
        device=None,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        channels = tuple(channels)
        strides = tuple(strides or (2,) * (len(channels) - 1))
        conv1x1 = {2: nn.Conv2d, 3: nn.Conv3d}[spatial_dims]
        self.conv1x1 = conv1x1(in_channels, 1, 1) if downsample else None
        self.spatial_dims = spatial_dims
        self.unet = UNet(
            1 if downsample else in_channels, out_channels, channels, strides,
            num_res_units, spatial_dims=spatial_dims,
        )
        if generator is not None:
            reset_parameters(self, generator)
        self.compute_dtype = dtype or torch.float32
        param_dtype = (torch.float64 if self.compute_dtype == torch.float64
                       else torch.float32)
        self.to(device=device, dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, *spatial) images -> (N, out_channels, *spatial) logits in
        the compute dtype."""
        x = x.to(self.compute_dtype)
        if self.conv1x1 is not None:
            x = conv(self.conv1x1, x)
        return self.unet(x)
