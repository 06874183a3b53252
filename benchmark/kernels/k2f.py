"""K2f, the 2D stride-1 3x3 Conv+InstanceNorm+PReLU unit
(ops/conv_block.py::conv3x3_in_prelu, csrc/conv_block.cu): the conv's
products, 8 elementwise operations an output (the statistics, normalise,
PReLU), x, the weight and y moved once, and in training the saved xhat
written too."""

FRAGMENTS = ("conv3x3_wgmma_kernel", "prepare_weights_kernel",
             "conv_stats_finalize_kernel", "in_prelu_apply_kernel",
             "conv3x3_bias_kernel", "in_prelu_two_pass_kernel")
COUNTER = ("ctseg_tpu_torch.ops.conv_block", "conv3x3_in_prelu")


def takes(site):
    return (site["op"] == "conv_unit" and site["dims"] == 2
            and not site["transposed"] and site["k"] == 3
            and site["stride"] == 1 and site["act"])


def work(site):
    if not takes(site):
        return None
    n, cin = site["x"][0], site["x"][1]
    cout, hw = site["y"][1], site["y"][2] * site["y"][3]
    out = n * hw * cout
    eb = site["itemsize"]
    moved = n * hw * cin + 9 * cin * cout + out * (2 if site["grad"] else 1)
    return 2 * 9 * cin * cout * n * hw, 8 * out, eb * moved, eb
