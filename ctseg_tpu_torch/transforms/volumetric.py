"""The 3D transforms (port of ctseg_tpu/volumetric/trainer3d.py:22-50).

Resize mode: volumes arrive resized and only the channel axis is added
(raw HU: the reference's "windowed_degree_0" applies no windowing,
volumetric/predefined.py:4-7). Patch mode: the soft-tissue window, then
random H and W flips.

The transforms take the batch written out: (images (N, H, W, D) HU, labels
(N, H, W, D), draws) -> (images (N, H, W, D, 1), labels). The patch
transform's draws (`FlipDraws`) come from `draw_flips`, with the
reference's distributions (a flip of H, then of W, each with p = 0.5,
trainer3d.py:42-45).
"""

from typing import NamedTuple, Optional

import torch

from ctseg_tpu_torch.transforms.windowing import soft_tissue_window


class FlipDraws(NamedTuple):
    """Per-sample flips of the patch transform, each (N,) bool."""

    h: torch.Tensor  # flip the H axis
    w: torch.Tensor  # then the W axis


def draw_flips(generator: Optional[torch.Generator], shape,
               device=None) -> FlipDraws:
    """The flips for a batch of `shape` (N, ...), on the generator's device
    (or `device`)."""
    device = generator.device if generator is not None else device
    kw = {"generator": generator, "device": device}
    n = shape[0]
    return FlipDraws(torch.rand((n,), **kw) < 0.5,
                     torch.rand((n,), **kw) < 0.5)


def _identity_transform(images, labels, draws=None):
    """Resize mode: only the channel axis is added."""
    return images[..., None], labels


def _flip(x: torch.Tensor, sel: torch.Tensor, dim: int) -> torch.Tensor:
    sel = sel.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(sel, torch.flip(x, dims=(dim,)), x)


def _windowed_patch_transform(images, labels, draws: FlipDraws):
    """Patch mode: the soft-tissue window, then the drawn H and W flips."""
    img = soft_tissue_window(images)
    img, lab = _flip(img, draws.h, 1), _flip(labels, draws.h, 1)
    return _flip(img, draws.w, 2), _flip(lab, draws.w, 2)


_windowed_patch_transform.draw = draw_flips


def volumetric_transform(mode: Optional[str]):
    """The train and test transform of a 3D config's `volumetric_mode`."""
    return _windowed_patch_transform if mode == "patch" \
        else _identity_transform
