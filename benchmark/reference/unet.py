"""The plain reference of the benchmark's models: MONAI's residual UNet as
the reference trainer configures it (capstone/training/base_trainer.py:
64-79; capstone/volumetric/base_trainer.py:58-72), in plain PyTorch.

Conv -> InstanceNorm(affine=False, eps=1e-5) -> PReLU(one slope) units,
`num_res_units` subunits a residual unit with a strided k^d or a 1x1
shortcut, skip connections concatenating [skip, upsampled], each decoder
level a transposed conv then a 1-subunit residual unit, conv-only at the
top. The module tree gives MONAI's state_dict keys under `unet.`, so one
dict of weights loads into this model and into the program's.

Everything is plain torch: F.conv*, F.instance_norm, F.prelu, contiguous
NC* tensors. It imports nothing of the program.
"""

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}


class Unit(nn.Module):
    """Conv (or transposed conv) -> InstanceNorm -> PReLU, or conv only."""

    def __init__(self, dims, cin, cout, stride, k, conv_only=False,
                 transposed=False):
        super().__init__()
        p = (k - 1) // 2
        if transposed:
            self.conv = _CONV_T[dims](cin, cout, k, stride=stride, padding=p,
                                      output_padding=stride - 1)
        else:
            self.conv = _CONV[dims](cin, cout, k, stride=stride, padding=p)
        self.act = None if conv_only else nn.PReLU(init=0.25)

    def forward(self, x):
        y = self.conv(x)
        if self.act is None:
            return y
        return F.prelu(F.instance_norm(y, eps=1e-5), self.act.weight)


class Residual(nn.Module):
    def __init__(self, dims, cin, cout, stride, k, subunits,
                 last_conv_only=False):
        super().__init__()
        self.conv = nn.Sequential()
        c, s = cin, stride
        for i in range(max(1, subunits)):
            self.conv.add_module(f"unit{i}", Unit(
                dims, c, cout, s, k,
                conv_only=last_conv_only and i == max(1, subunits) - 1))
            c, s = cout, 1
        self.residual = nn.Identity()
        if stride != 1 or cin != cout:
            rk = k if stride != 1 else 1
            self.residual = _CONV[dims](cin, cout, rk, stride=stride,
                                        padding=(rk - 1) // 2)

    def forward(self, x):
        return self.residual(x) + self.conv(x)


class Skip(nn.Module):
    def __init__(self, submodule):
        super().__init__()
        self.submodule = submodule

    def forward(self, x):
        return torch.cat([x, self.submodule(x)], dim=1)


class UNet(nn.Module):
    def __init__(self, dims, cin, cout, channels, strides, res_units, k=3):
        super().__init__()

        def down(i, o, s):
            if res_units > 0:
                return Residual(dims, i, o, s, k, res_units)
            return Unit(dims, i, o, s, k)

        def up(i, o, s, top):
            t = Unit(dims, i, o, s, k, conv_only=top and res_units == 0,
                     transposed=True)
            if res_units == 0:
                return t
            return nn.Sequential(t, Residual(dims, o, o, 1, k, 1,
                                             last_conv_only=top))

        def block(i, o, chans, strds, top):
            c, s = chans[0], strds[0]
            if len(chans) > 2:
                sub, upc = block(c, c, chans[1:], strds[1:], False), 2 * c
            else:
                sub, upc = down(c, chans[1], 1), c + chans[1]
            return nn.Sequential(down(i, c, s), Skip(sub), up(upc, o, s, top))

        self.model = block(cin, cout, list(channels), list(strides), True)

    def forward(self, x):
        return self.model(x)


class Model(nn.Module):
    """The configuration's model: its state_dict keys are `unet.<MONAI
    key>`."""

    def __init__(self, config: Dict):
        super().__init__()
        self.unet = UNet(config["spatial_dims"], config["in_channels"],
                         config["out_channels"], config["filters"],
                         config["strides"], config["num_res_units"],
                         config["kernel_size"])

    def forward(self, x):
        return self.unet(x)


def parameter_shapes(config: Dict) -> Dict[str, torch.Size]:
    """name -> shape of every parameter, without allocating any."""
    with torch.device("meta"):
        model = Model(config)
    return {k: v.shape for k, v in model.named_parameters()}


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights from `seed`, on `device`, in one draw:
    conv weights and biases U(-b, b) with b = 1/sqrt(fan_in) (torch's
    default, fan_in from the weight's second dim times the kernel's
    positions, so a transposed conv's is its output channels), PReLU slopes
    0.25. float32, the type the parameters are kept in."""
    shapes = parameter_shapes(config)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(s.numel() for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    convs = {k.rsplit(".", 1)[0] for k, s in shapes.items()
             if k.endswith(".weight") and len(s) > 2}
    for name, shape in shapes.items():
        n = shape.numel()
        owner, leaf = name.rsplit(".", 1)
        if owner in convs:
            w = shapes[owner + ".weight"]
            fan_in = w[1] * torch.Size(w[2:]).numel()
            out[name] = (flat[at:at + n] * fan_in ** -0.5).view(shape)
        else:  # a PReLU slope
            out[name] = torch.full(shape, 0.25, device=device)
        at += n
    return out
