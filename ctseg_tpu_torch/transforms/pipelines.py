"""Predefined transform pipelines (port of ctseg_tpu/transforms/pipelines.py).

The test side, which every degree shares: HU windows + Resize(256) +
Normalize, three windows for degrees >= 1 and the single soft-tissue window
for degree 0. The train side of degree 2: windows + RandomCrop(256) +
RandomRotate90 + HorizontalFlip + Normalize, as one K4 launch on the card
(ops/preprocess.py); the labels take the same moves by plain indexing. The
batch dimension is written out: a test transform maps raw-HU slices
(N, H, W) [+ labels (N, H, W)] to (N, S, S, C) [+ (N, S, S)]; a train
transform also takes the per-sample draws (transforms/augment.draw_degree2).
The train sides of degrees 0, 1, 3 and 4 wait (ROADMAP.md).
"""

import functools
from typing import Callable, Optional, Tuple

import torch

from ctseg_tpu_torch.constants import STACKED_WINDOW_MEAN, STACKED_WINDOW_STD
from ctseg_tpu_torch.ops.preprocess import window_normalize_degree2
from ctseg_tpu_torch.transforms import augment
from ctseg_tpu_torch.transforms.windowing import (
    normalize,
    soft_tissue_window,
    windowed_channels,
)

DEFAULT_SIZE = (256, 256)
_SOFT_MEAN = (STACKED_WINDOW_MEAN[1],)
_SOFT_STD = (STACKED_WINDOW_STD[1],)
_DEGREES = (0, 1, 2, 3, 4)

# (images_NHW, labels_NHW or None) -> (images_NSSC, labels_NSS or None)
TransformFn = Callable[
    [torch.Tensor, Optional[torch.Tensor]],
    Tuple[torch.Tensor, Optional[torch.Tensor]],
]
# (images_NHW, labels_NHW, draws) -> (images_NSS3, labels_NSS)
TrainTransformFn = Callable[
    [torch.Tensor, torch.Tensor, augment.Degree2Draws],
    Tuple[torch.Tensor, torch.Tensor],
]


def _test_transform(images, labels=None, size=DEFAULT_SIZE,
                    single_channel=False):
    if single_channel:
        img = soft_tissue_window(images)
    else:
        img = windowed_channels(images)
    if labels is None:
        img, lab = augment.resize(img, size, "linear"), None
    else:
        img, lab = augment.resize_image_and_label(img, labels, size)
    if single_channel:
        return normalize(img, _SOFT_MEAN, _SOFT_STD), lab
    return normalize(img), lab


def _degree_2(images, labels, draws, size=DEFAULT_SIZE):
    if size[0] != size[1]:
        raise ValueError(f"degree 2 crops square patches, got size {size}")
    img = window_normalize_degree2(images, draws, size[0])
    return img, augment.apply_degree2(labels, draws, size[0])


def transform_in_channels(degree: int) -> int:
    """Channel count produced by a degree (reference base_trainer.py:64-69)."""
    return 1 if degree == 0 else 3


def get_transform(degree: int, train: bool,
                  size: Tuple[int, int] = DEFAULT_SIZE):
    """A TransformFn (test) or a TrainTransformFn (train, degree 2)."""
    if degree not in _DEGREES:
        raise ValueError(f"invalid transform degree: {degree}")
    if train:
        if degree != 2:
            raise NotImplementedError(
                f"the degree-{degree} train transform waits for its slice "
                "(ROADMAP.md, modules to port, item 3: the train transforms "
                "of degrees 0, 1, 3 and 4)"
            )
        return functools.partial(_degree_2, size=tuple(size))
    return functools.partial(
        _test_transform, size=tuple(size), single_channel=(degree == 0)
    )
