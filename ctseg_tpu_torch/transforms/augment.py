"""Resizing and the degree-2 augmentations (port of
ctseg_tpu/transforms/augment.py: resize, random_crop, random_rotate90,
horizontal_flip; the elastic and grid warps of degrees 0, 3, 4 wait).

`jax.image.resize(..., "linear")` is antialiased triangle-filter resampling
with half-pixel centres: F.interpolate(mode="bilinear", antialias=True,
align_corners=False) computes the same weights (equal to 1e-15 in float64,
for down- and upscaling alike). `jax.image.resize(..., "nearest")` is
F.interpolate's "nearest-exact"; plain "nearest" picks other pixels.

The random augmentations split drawing from applying. `draw_degree2` draws
per-sample (top, left, k, flip) from an explicit torch.Generator, with the
distributions of the JAX calls (augment.py:69-71, 82, 92-93): a uniform crop
offset, k ~ U{0..3} applied with p = 0.5, a W flip with p = 0.5. The apply
functions are plain torch, batched, and are the plain versions of K4's index
map (ops/preprocess.py); tests feed them the draws JAX makes.

Images are batched channel-last (N, H, W, C) or (N, H, W), labels (N, H, W).
"""

from typing import NamedTuple, Optional, Tuple

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


class Degree2Draws(NamedTuple):
    """Per-sample parameters of the degree-2 moves, each (N,) int32."""

    top: torch.Tensor   # crop row offset, in [0, H - S]
    left: torch.Tensor  # crop column offset, in [0, W - S]
    k: torch.Tensor     # quarter turns of rot90, in 0..3
    flip: torch.Tensor  # 1 to flip W after the rotation


def draw_degree2(generator: Optional[torch.Generator], n: int, h: int, w: int,
                 size: int, device=None) -> Degree2Draws:
    """Draw crop, rot90 and flip parameters for n slices of (h, w) cropped to
    (size, size), on the generator's device (or `device`)."""
    if h < size or w < size:
        raise ValueError(f"cannot crop ({h}, {w}) slices to {size}")
    device = generator.device if generator is not None else device
    kw = {"generator": generator, "device": device}
    i32 = torch.int32
    top = torch.randint(0, h - size + 1, (n,), dtype=i32, **kw)
    left = torch.randint(0, w - size + 1, (n,), dtype=i32, **kw)
    rotate = torch.rand((n,), **kw) < 0.5
    k = torch.where(rotate, torch.randint(0, 4, (n,), dtype=i32, **kw), 0)
    flip = (torch.rand((n,), **kw) < 0.5).to(i32)
    return Degree2Draws(top, left, k.to(i32), flip)


def crop(x: torch.Tensor, top: torch.Tensor, left: torch.Tensor, size: int):
    """x[n, top[n]:top[n]+size, left[n]:left[n]+size] for every n (A.RandomCrop)."""
    ar = torch.arange(size, device=x.device)
    rows = top.long()[:, None] + ar  # (N, S)
    cols = left.long()[:, None] + ar
    n = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[n, rows[:, :, None], cols[:, None, :]]


def rotate90(x: torch.Tensor, k: torch.Tensor):
    """np.rot90(x[n], k[n], axes=(0, 1)) for every n (A.RandomRotate90)."""
    if x.shape[1] != x.shape[2]:
        raise ValueError("rot90 needs square inputs")
    mask_shape = (-1,) + (1,) * (x.ndim - 1)
    out = x
    for q in (1, 2, 3):
        sel = (k == q).reshape(mask_shape)
        out = torch.where(sel, torch.rot90(x, q, dims=(1, 2)), out)
    return out


def hflip(x: torch.Tensor, flip: torch.Tensor):
    """Flip the W axis of the samples whose `flip` is 1 (A.HorizontalFlip)."""
    sel = flip.bool().reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(sel, torch.flip(x, dims=(2,)), x)


def apply_degree2(x: torch.Tensor, draws: Degree2Draws, size: int):
    """Crop, rot90, then flip: the order of pipelines._degree_2."""
    x = crop(x, draws.top, draws.left, size)
    return hflip(rotate90(x, draws.k), draws.flip)
