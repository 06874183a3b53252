"""Resizing for the test transform (the serving slice of
ctseg_tpu/transforms/augment.py; the random train augmentations wait).

`jax.image.resize(..., "linear")` is antialiased triangle-filter resampling
with half-pixel centres: F.interpolate(mode="bilinear", antialias=True,
align_corners=False) computes the same weights (equal to 1e-15 in float64,
for down- and upscaling alike). `jax.image.resize(..., "nearest")` is
F.interpolate's "nearest-exact"; plain "nearest" picks other pixels.

Images are batched channel-last (N, H, W, C), labels (N, H, W).
"""

from typing import Tuple

import torch
import torch.nn.functional as F


def resize(image: torch.Tensor, size: Tuple[int, int], method: str = "linear"):
    """Resize (N, H, W[, C]) to (N, size[0], size[1][, C])."""
    if method not in ("linear", "nearest"):
        raise ValueError(f"unknown resize method {method!r}")
    nhwc = image if image.ndim == 4 else image[..., None]
    nchw = nhwc.permute(0, 3, 1, 2)
    if method == "linear":
        out = F.interpolate(
            nchw, size=tuple(size), mode="bilinear", antialias=True,
            align_corners=False,
        )
    else:
        out = F.interpolate(nchw, size=tuple(size), mode="nearest-exact")
    out = out.permute(0, 2, 3, 1)
    return out if image.ndim == 4 else out[..., 0]


def resize_image_and_label(image, label, size):
    """Bilinear for the image, nearest for the label (Albumentations Resize)."""
    img = resize(image, size, "linear")
    lab = resize(label.to(torch.float32), size, "nearest").to(label.dtype)
    return img, lab
