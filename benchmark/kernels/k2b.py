"""K2b, the backward of K2f's norm and PReLU (ops/conv_block.py::
in_prelu_bwd, K1b's kernels reading the saved xhat, csrc/instance_norm.cu):
12 elementwise operations an element, g and xhat read, dy written."""

FRAGMENTS = ("in_prelu_bwd_saved_",)
COUNTER = ("ctseg_tpu_torch.ops.conv_block", "in_prelu_bwd")


def work(site):
    if not (site["op"] == "conv_unit" and site["grad"] and site["dims"] == 2
            and not site["transposed"] and site["k"] == 3
            and site["stride"] == 1 and site["act"]):
        return None
    out = site["y"][0] * site["y"][1] * site["y"][2] * site["y"][3]
    eb = site["itemsize"]
    return 0, 12 * out, eb * 3 * out, eb
