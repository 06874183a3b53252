"""K1f, InstanceNorm+PReLU after every conv unit that K2f does not take
(ops/instance_norm.py::instance_norm_prelu, csrc/instance_norm.cu): 8
elementwise operations an element, x read and y written once."""

import math

FRAGMENTS = ("in_prelu_fwd_",)
COUNTER = ("ctseg_tpu_torch.ops.instance_norm", "instance_norm_prelu")


def work(site):
    if site["op"] != "conv_unit" or not site["act"]:
        return None
    if (site["dims"] == 2 and not site["transposed"] and site["k"] == 3
            and site["stride"] == 1):
        return None  # K2f's
    out = math.prod(site["y"])
    eb = site["itemsize"]
    return 0, 8 * out, eb * 2 * out, eb
