"""K4, the degree-2 train transform of the images (ops/preprocess.py::
window_normalize_degree2, csrc/preprocess.cu): 15 elementwise operations
an output pixel (three windows' clip, shift and division, normalise), the
crop read once and the three channels written once, float32."""

FRAGMENTS = ("window_normalize_kernel",)
COUNTER = ("ctseg_tpu_torch.ops.preprocess", "window_normalize_degree2")


def work(site):
    if site["op"] != "degree2_transform":
        return None
    pixels = site["n"] * site["size"] ** 2
    return 0, 15 * pixels, 4 * (pixels + 3 * pixels), 4
