"""CT Hounsfield-unit windowing on tensors (port of
ctseg_tpu/transforms/windowing.py).

apply_window clips to [level - width//2, level + width//2] and (optionally)
shifts to [0, 1] dividing by (max - min + 1e-8) (reference
transforms_2d.py:97-107); windowed_channels stacks several windows (by
default brain, soft tissue, bone) as a trailing channel axis.
Shape-polymorphic over leading dims.
"""

import functools
from typing import Sequence, Tuple, Union

import torch

from ctseg_tpu_torch.constants import (
    STACKED_WINDOW_MEAN,
    STACKED_WINDOW_STD,
    WINDOW_ORDER,
    WINDOWING_CONFIG,
)


@functools.lru_cache(maxsize=None)
def _cached_constant(values, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _constant(values: Union[float, Tuple[float, ...]], dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """Kept per device: a copy to the card per call would wait for the
    stream. Made anew while `torch.export` traces (the trace's tensors are
    fake and become the graph's constants; the cache keeps real ones)."""
    if torch.compiler.is_compiling():
        return torch.tensor(values, dtype=dtype, device=device)
    return _cached_constant(values, dtype, device)


def apply_window(
    image: torch.Tensor, window_width: int, window_level: int,
    shift: bool = True,
) -> torch.Tensor:
    """Clip to a HU window; with `shift`, rescale it to [0, 1].

    The divisor is a tensor on the image's device: torch's CUDA division by
    a Python scalar multiplies by its reciprocal (one rounding more), while
    this is the true division of the CPU path and of K4 (ops/preprocess.py).
    """
    min_ = window_level - (window_width // 2)
    max_ = window_level + (window_width // 2)
    clipped = torch.clamp(image, min_, max_)
    if not shift:
        return clipped
    den = _constant(max_ - min_ + 1e-8, image.dtype, image.device)
    return (clipped - min_) / den


def windowed_channels(
    image: torch.Tensor,
    windows: Sequence[str] = WINDOW_ORDER,
    shift: bool = True,
) -> torch.Tensor:
    """(..., H, W) raw HU -> (..., H, W, len(windows)), by default brain,
    soft tissue, bone."""
    chans = [apply_window(image, *WINDOWING_CONFIG[w], shift=shift)
             for w in windows]
    return torch.stack(chans, dim=-1)


def soft_tissue_window(image: torch.Tensor, shift: bool = True) -> torch.Tensor:
    """Single soft-tissue window with a trailing channel axis of 1."""
    return apply_window(image, *WINDOWING_CONFIG["soft_tissue"],
                        shift=shift)[..., None]


def normalize(
    image: torch.Tensor,
    mean: Tuple[float, ...] = STACKED_WINDOW_MEAN,
    std: Tuple[float, ...] = STACKED_WINDOW_STD,
) -> torch.Tensor:
    """Per-channel standardization over the trailing channel axis."""
    mean = _constant(tuple(mean), image.dtype, image.device)
    std = _constant(tuple(std), image.dtype, image.device)
    if mean.shape[0] != image.shape[-1] or std.shape[0] != image.shape[-1]:
        raise ValueError(
            f"mean/std have {mean.shape[0]}/{std.shape[0]} entries for "
            f"{image.shape[-1]} channels"
        )
    return (image - mean) / std
