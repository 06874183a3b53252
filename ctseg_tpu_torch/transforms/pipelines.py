"""Predefined transform pipelines, degrees 0-4 (port of
ctseg_tpu/transforms/pipelines.py).

The test side, which every degree shares: HU windows + Resize(256) +
Normalize, three windows for degrees >= 1 and the single soft-tissue window
for degree 0. The train sides, in the reference's order
(pipelines.py:57-91):

  degree 1: the test side (no draws)
  degree 2: windows + RandomCrop(256) + RandomRotate90 + HFlip + Normalize,
            one K4 launch on the card (ops/preprocess.py); the labels take
            the same moves by plain indexing
  degree 3: degree 2 with ElasticTransform after the crop
  degree 4: windows + RandomCrop(256) + OneOf(Elastic, GridDistortion) +
            Normalize
  degree 0: degree 4 on the single soft-tissue window

Degrees 3, 4 and 0 crop the raw slices before windowing them: the windows
are elementwise and the crop only moves pixels, so the result is the
reference's bit for bit on a quarter of a 512x512 slice's pixels. The warps
stay after the windows (clip then interpolate is not interpolate then
clip). The batch dimension is written out: a test transform maps raw-HU
slices (N, H, W) [+ labels (N, H, W)] to (N, S, S, C) [+ (N, S, S)]; a train
transform also takes the per-sample draws, which its `draw(generator,
shape, device)` attribute makes (transforms/augment.py).
"""

import functools
from typing import Any, Callable, Optional, Tuple

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

# (images_NHW, labels_NHW or None) -> (images_NSSC, labels_NSS or None)
TransformFn = Callable[
    [torch.Tensor, Optional[torch.Tensor]],
    Tuple[torch.Tensor, Optional[torch.Tensor]],
]
# (images_NHW, labels_NHW, draws) -> (images_NSSC, labels_NSS)
TrainTransformFn = Callable[
    [torch.Tensor, torch.Tensor, Any],
    Tuple[torch.Tensor, torch.Tensor],
]


def _window(images, single_channel: bool):
    if single_channel:
        return soft_tissue_window(images)
    return windowed_channels(images)


def _normalize(image, single_channel: bool):
    if single_channel:
        return normalize(image, _SOFT_MEAN, _SOFT_STD)
    return normalize(image)


def _test_transform(images, labels=None, size=DEFAULT_SIZE,
                    single_channel=False):
    img = _window(images, single_channel)
    if labels is None:
        img, lab = augment.resize(img, size, "linear"), None
    else:
        img, lab = augment.resize_image_and_label(img, labels, size)
    return _normalize(img, single_channel), lab


def _degree_1(images, labels, draws=None, size=DEFAULT_SIZE):
    return _test_transform(images, labels, size)


def _degree_2(images, labels, draws, size=DEFAULT_SIZE):
    if size[0] != size[1]:
        raise ValueError(f"degree 2 crops square patches, got size {size}")
    img = window_normalize_degree2(images, draws, size[0])
    return img, augment.apply_degree2(labels, draws, size[0])


def _crop_and_window(images, labels, draws, size, single_channel):
    if size[0] != size[1]:
        raise ValueError(f"the train transforms crop square patches, got "
                         f"size {size}")
    images = augment.crop(images, draws.top, draws.left, size[0])
    labels = augment.crop(labels, draws.top, draws.left, size[0])
    return _window(images, single_channel), labels


def _degree_3(images, labels, draws, size=DEFAULT_SIZE):
    img, lab = _crop_and_window(images, labels, draws, size, False)
    img, lab = augment.elastic_transform(img, lab, draws.elastic)
    img = augment.hflip(augment.rotate90(img, draws.k), draws.flip)
    lab = augment.hflip(augment.rotate90(lab, draws.k), draws.flip)
    return _normalize(img, False), lab


def _degree_4(images, labels, draws, size=DEFAULT_SIZE,
              single_channel=False):
    img, lab = _crop_and_window(images, labels, draws, size, single_channel)
    coords = (augment.elastic_coords(draws.elastic, size[0], size[1]),
              augment.grid_coords(draws.grid, size[0], size[1]))
    img, lab = augment.one_of(img, lab, draws.choice, coords)
    return _normalize(img, single_channel), lab


def _degree_0(images, labels, draws, size=DEFAULT_SIZE):
    return _degree_4(images, labels, draws, size, single_channel=True)


def _no_draws(generator, n, h, w, size, device=None):
    """Degree 1 draws nothing: its train side is its test side."""
    return None


_TRAIN = {
    0: (_degree_0, augment.draw_degree0),
    1: (_degree_1, _no_draws),
    2: (_degree_2, augment.draw_degree2),
    3: (_degree_3, augment.draw_degree3),
    4: (_degree_4, augment.draw_degree4),
}


def _draw_batch(draw, size, generator, shape, device=None):
    """A degree's draws for a raw batch of `shape` (N, H, W)."""
    n, h, w = shape
    return draw(generator, n, h, w, size, device=device)


def transform_in_channels(degree: int) -> int:
    """Channel count produced by a degree (reference base_trainer.py:64-69)."""
    return 1 if degree == 0 else 3


def get_transform(degree: int, train: bool,
                  size: Tuple[int, int] = DEFAULT_SIZE):
    """A TransformFn (test) or a TrainTransformFn (train) whose `draw`
    attribute draws its parameters."""
    if degree not in _TRAIN:
        raise ValueError(f"invalid transform degree: {degree}")
    size = tuple(size)
    if train:
        fn, draw = _TRAIN[degree]
        transform = functools.partial(fn, size=size)
        transform.draw = functools.partial(_draw_batch, draw, size[0])
        return transform
    return functools.partial(
        _test_transform, size=size, single_channel=(degree == 0)
    )
