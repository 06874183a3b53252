"""K1b, the backward of K1f (ops/instance_norm.py::instance_norm_prelu_bwd,
csrc/instance_norm.cu): 14 elementwise operations an element, x and g read,
dx written once."""

import math

FRAGMENTS = ("in_prelu_bwd_partials_kernel", "in_prelu_bwd_dx_kernel",
             "in_prelu_bwd_cluster_kernel", "in_prelu_bwd_means_kernel")
COUNTER = ("ctseg_tpu_torch.ops.instance_norm", "instance_norm_prelu_bwd")


def work(site):
    if site["op"] != "conv_unit" or not site["act"] or not site["grad"]:
        return None
    if (site["dims"] == 2 and not site["transposed"] and site["k"] == 3
            and site["stride"] == 1):
        return None  # K2b's
    out = math.prod(site["y"])
    eb = site["itemsize"]
    return 0, 14 * out, eb * 3 * out, eb
