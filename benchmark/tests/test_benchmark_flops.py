"""The frozen FLOP count (benchmark/flops.py) against configurations
worked out by hand, and against the port's own modules."""

import math

import pytest
import torch

from benchmark.flops import config_flops, unet_forward_flops


def test_plain_unet_by_hand():
    # 1 -> 2 channels, one stride-2 level, 4x4 input, 3 classes, batch 1:
    # the strided conv 2*9*(2*2)*1*2 = 144, the bottom 2*9*4*2*4 = 576,
    # the transposed conv from 2x2, (2 + 4) -> 3: 2*9*4*6*3 = 1296.
    f = unet_forward_flops(1, (2, 4), (2,), 0, (4, 4), 3, 1)
    assert f == {"forward": 144 + 576 + 1296, "input_convs": 144}


def test_residual_unet_by_hand():
    # One subunit: the strided unit and its strided k^2 shortcut (144
    # each), the bottom unit (576) and its 1x1 shortcut 2*1*4*2*4 = 64, the
    # transposed conv (1296) and the decoder's unit 2*9*16*3*3 = 2592.
    f = unet_forward_flops(1, (2, 4), (2,), 1, (4, 4), 3, 1)
    assert f["forward"] == 144 + 144 + 576 + 64 + 1296 + 2592
    assert f["input_convs"] == 288


def test_train_step_leaves_out_the_images_gradient():
    config = {"in_channels": 1, "filters": [2, 4], "strides": [2],
              "num_res_units": 0, "input_shape": [4, 4], "out_channels": 3,
              "kernel_size": 3}
    f = config_flops(config, 2)
    assert f["forward"] == 2 * 2016
    assert f["train_step"] == 3 * 2 * 2016 - 2 * 144


def _counted(model, x):
    """Conv FLOPs of one forward of the port's model, from each conv
    module's weight and the shapes its units see."""
    from torch.nn.modules.conv import _ConvNd, _ConvTransposeNd

    total = [0.0]

    def flops(conv, xin, yout):
        taps = math.prod(conv.weight.shape[2:])
        cin, cout = xin.shape[1], yout.shape[1]
        at = xin if isinstance(conv, _ConvTransposeNd) else yout
        return 2.0 * taps * cin * cout * math.prod(at.shape[2:]) * at.shape[0]

    def unit(module, args, out):
        total[0] += flops(module.conv, args[0], out)

    def residual(module, args, out):
        if isinstance(module.residual, _ConvNd):
            total[0] += flops(module.residual, args[0], out)

    hooks = []
    for m in model.modules():
        if isinstance(getattr(m, "conv", None), _ConvNd):
            hooks.append(m.register_forward_hook(unit))
        if isinstance(getattr(m, "residual", None), _ConvNd):
            hooks.append(m.register_forward_hook(residual))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return total[0]


@pytest.mark.parametrize("dims,res_units", [(2, 2), (2, 1), (2, 0), (3, 2)])
def test_counts_the_ports_modules(dims, res_units):
    from ctseg_tpu_torch.models.unet import SegmentationModel

    shape = (16, 16) if dims == 2 else (16, 16, 16)
    cin = 3 if dims == 2 else 1
    model = SegmentationModel(cin, 10, (4, 8, 16), num_res_units=res_units,
                              spatial_dims=dims, device="cpu")
    x = torch.randn((2, cin) + shape)
    want = unet_forward_flops(cin, (4, 8, 16), (2, 2), res_units, shape, 10, 2)
    assert _counted(model, x) == want["forward"]
