"""Analytic conv FLOPs of the UNet (MONAI's residual UNet as the reference
configures it), counted from the configuration's sizes alone.

A conv with a k^d kernel producing P output positions from Cin to Cout
channels takes 2 * k^d * P * Cin * Cout FLOPs; a transposed conv takes the
same per *input* position (each scatters k^d taps). Instance norm, PReLU,
the losses and the optimizer are left out: they are a fraction of a percent
of the convs', so the shares built on this count are slightly low, never
high.

A training step is the forward, the gradient of every weight (as many FLOPs
again) and the gradient of every conv's input, except for the convs that
read the images themselves: nothing asks for the images' gradient.
"""

import math
from typing import Dict, Sequence


def _conv(spatial_out, cin, cout, kpow, batch):
    return 2.0 * kpow * math.prod(spatial_out) * cin * cout * batch


def unet_forward_flops(in_channels: int, channels: Sequence[int],
                       strides: Sequence[int], num_res_units: int,
                       input_shape: Sequence[int], out_channels: int,
                       batch: int, k: int = 3) -> Dict[str, float]:
    """{"forward": FLOPs of one forward, "input_convs": the share of it in
    the convs that read the images} for a batch of `input_shape` inputs."""
    nd = len(input_shape)
    kpow = k ** nd
    depth = len(strides)
    total = 0.0
    spatial = tuple(input_shape)
    inc = in_channels
    enc_spatial = []
    input_convs = 0.0
    for i in range(depth):
        s_out = tuple(max(s // strides[i], 1) for s in spatial)
        first = _conv(s_out, inc, channels[i], kpow, batch)
        total += first
        if i == 0:
            input_convs += first
        if num_res_units > 0:
            for _ in range(num_res_units - 1):
                total += _conv(s_out, channels[i], channels[i], kpow, batch)
            # the strided shortcut, a k^d conv from the level's input
            total += first
            if i == 0:
                input_convs += first
        enc_spatial.append(s_out)
        inc, spatial = channels[i], s_out
    # the bottom, stride 1
    total += _conv(spatial, channels[depth - 1], channels[depth], kpow, batch)
    if num_res_units > 0:
        for _ in range(num_res_units - 1):
            total += _conv(spatial, channels[depth], channels[depth], kpow,
                           batch)
        # the 1x1 shortcut for the channel change
        total += _conv(spatial, channels[depth - 1], channels[depth], 1, batch)
    # the decoder: a transposed conv, then a 1-subunit residual unit
    up_in = channels[depth]
    for i in reversed(range(depth)):
        cin = channels[i] + up_in  # the skip concatenation
        cout = out_channels if i == 0 else channels[i - 1]
        total += _conv(enc_spatial[i], cin, cout, kpow, batch)
        s_out = tuple(s * strides[i] for s in enc_spatial[i])
        if num_res_units > 0:
            total += _conv(s_out, cout, cout, kpow, batch)
        up_in = cout
    return {"forward": total, "input_convs": input_convs}


def config_flops(config: Dict, batch: int) -> Dict[str, float]:
    """{"forward", "train_step"} FLOPs of a benchmark configuration
    (configs/*.json) at `batch`."""
    f = unet_forward_flops(config["in_channels"], config["filters"],
                           config["strides"], config["num_res_units"],
                           config["input_shape"], config["out_channels"],
                           batch, config["kernel_size"])
    return {"forward": f["forward"],
            "train_step": 3.0 * f["forward"] - f["input_convs"]}
