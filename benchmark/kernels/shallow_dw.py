"""The stride-1 3D conv's weight gradient where a side has at most 16
channels and the input at most 64 slices deep (ops/shallow_grad.py::
shallow_dw, csrc/shallow_dw.cu): 2 k^3 Cin Cout products an output voxel,
x and dy read once, dW and db written once in float32."""

import math

FRAGMENTS = ("shallow_dw_kernel", "shallow_dw_finalize")
COUNTER = ("ctseg_tpu_torch.ops.shallow_grad", "shallow_dw")


def work(site):
    if not (site["op"] == "conv_unit" and site["grad"] and site["dims"] == 3
            and not site["transposed"] and site["stride"] == 1
            and site["k"] % 2 == 1
            and min(site["x"][1], site["y"][1]) <= 16
            and site["x"][-1] <= 64):
        return None
    k, cin, cout = site["k"], site["x"][1], site["y"][1]
    n, vox = site["y"][0], math.prod(site["y"][2:])
    eb = site["itemsize"]
    moved = eb * n * vox * (cin + cout) + 4 * (k ** 3 * cin * cout + cout)
    return 2 * k ** 3 * cin * cout * n * vox, 0, moved, eb
