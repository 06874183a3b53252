"""The k=3, s=2 transposed conv's weight gradient where a side has at most
16 channels (ops/shallow_grad.py::shallow_dwt, csrc/shallow_dwt.cu): 2 k^d
Cin Cout products an input voxel (each scatters k^d taps), x and dy read
once, dW and db written once in float32."""

import math

FRAGMENTS = ("shallow_dwt_kernel", "shallow_dwt_finalize")
COUNTER = ("ctseg_tpu_torch.ops.shallow_grad", "shallow_dwt")


def work(site):
    if not (site["op"] == "conv_unit" and site["grad"] and site["transposed"]
            and site["k"] == 3 and site["stride"] == 2
            and min(site["x"][1], site["y"][1]) <= 16):
        return None
    d, cin, cout = site["dims"], site["x"][1], site["y"][1]
    n = site["x"][0]
    xin, yout = math.prod(site["x"][2:]), math.prod(site["y"][2:])
    eb = site["itemsize"]
    moved = eb * n * (xin * cin + yout * cout) + 4 * (3 ** d * cin * cout
                                                     + cout)
    return 2 * 3 ** d * cin * cout * n * xin, 0, moved, eb
