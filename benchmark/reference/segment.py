"""The plain reference of one scan's segmentation by a 2D slice model, from
the reference's contracts (capstone/utils/miccai.py:193-227,
capstone/transforms/predefined.py):

  - the anatomical head-and-neck box: slices [ceil(0.32 D), ceil(0.99 D)),
    rows 120:400, columns 55:335 of a 512 x 512 scan;
  - the test transform: three HU windows, a bilinear (antialiased) resize
    of the 280 x 280 crop to the model's input, per-channel
    normalisation;
  - the model's logits (reference/unet.py), and their nearest resize back
    to the crop's size, where the label map is read off.

`label_gap` judges a served label map by what it says: at every voxel in
the box, how far the served label's logit lies below the reference's best;
outside the box every label must be 0. Imports nothing of the program.
"""

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.train import MEAN, STD, WINDOWS, window

BOX_Z = (0.32, 0.99)
BOX_ROWS = (120, 400)
BOX_COLS = (55, 335)


def box(depth: int) -> Tuple[slice, slice, slice]:
    return (slice(math.ceil(BOX_Z[0] * depth), math.ceil(BOX_Z[1] * depth)),
            slice(*BOX_ROWS), slice(*BOX_COLS))


def test_transform(slices: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W) HU -> (B, 3, S, S)."""
    img = torch.stack([window(slices, w) for w in WINDOWS], 1)
    img = F.interpolate(img, size=tuple(size), mode="bilinear",
                        antialias=True, align_corners=False)
    mean = torch.tensor(MEAN, device=img.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=img.device).view(1, 3, 1, 1)
    return ((img - mean) / std).contiguous()


@torch.no_grad()
def crop_logits(model, scan: np.ndarray, size, device, block: int = 16,
                tf32: bool = False) -> torch.Tensor:
    """(D', C, h, w) float32 logits of the box's slices, at the crop's
    size, in blocks of `block` slices; TF32 off unless `tf32` (the
    control)."""
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        region = torch.from_numpy(np.ascontiguousarray(
            scan[box(scan.shape[0])], np.float32)).to(device)
        out = []
        for lo in range(0, region.shape[0], block):
            logits = model(test_transform(region[lo:lo + block], size))
            out.append(F.interpolate(logits.float(),
                                     size=tuple(region.shape[1:]),
                                     mode="nearest-exact"))
        return torch.cat(out)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


@torch.no_grad()
def label_gap(served: np.ndarray, logits: torch.Tensor) -> Tuple[float, int]:
    """(the widest gap, in logits, by which a served label's logit lies
    below the reference's best inside the box; the number of voxels
    outside the box that are not 0)."""
    z, r, c = box(served.shape[0])
    inside = torch.from_numpy(np.ascontiguousarray(served[z, r, c])).to(
        logits.device).long()
    best = logits.max(1).values
    got = logits.gather(1, inside[:, None])[:, 0]
    gap = float((best - got).max())
    outside = int(np.count_nonzero(served)) - int(
        np.count_nonzero(served[z, r, c]))
    return gap, outside


@torch.no_grad()
def argmax_labels(scan_shape, logits: torch.Tensor) -> np.ndarray:
    """A label map read off logits of the box (the control's answer)."""
    out = np.zeros(scan_shape, np.uint8)
    out[box(scan_shape[0])] = logits.argmax(1).to(torch.uint8).cpu().numpy()
    return out
