"""PDDCA volumes and the anatomical crop box (numpy, host-side).

The serving slice of ctseg_tpu/utils/miccai.py: `Volume` (from_nrrd,
as_numpy, header) and `CropBox`. Arrays are channel-first (C, D, H, W);
NRRD files store (H, W, D) (reference miccai.py:286-296), and the crop box
keeps x/y absolute pixel bounds and ceil-rounded z fractions of the slice
count (reference miccai.py:193-227).
"""

import dataclasses
import math
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ctseg_tpu_torch.constants import (
    CROP_BOUNDARY_X,
    CROP_BOUNDARY_Y,
    CROP_BOUNDARY_Z,
)
from ctseg_tpu_torch.utils import nrrd_io

PathLike = Union[str, Path]


def load_nrrd_as_array(path: PathLike) -> Tuple[np.ndarray, Dict]:
    """NRRD file -> ((C, D, H, W) array, raw header)."""
    img, header = nrrd_io.read(path)
    if img.ndim == 3:
        img = img[..., np.newaxis]  # (H, W, D, C)
    return np.transpose(img, (3, 2, 0, 1)), header


@dataclasses.dataclass(frozen=True)
class CropBox:
    """Half-open (lo, hi) bounds per axis of a (C, D, H, W) volume."""

    z: Tuple[int, int]
    x: Tuple[int, int]
    y: Tuple[int, int]

    def __post_init__(self):
        for axis, (lo, hi) in (("z", self.z), ("x", self.x), ("y", self.y)):
            if lo >= hi:
                raise ValueError(
                    f"empty {axis} crop range: [{lo}, {hi}) selects nothing"
                )

    @classmethod
    def anatomical(
        cls,
        num_slides: int,
        boundary_x: Tuple[int, int] = CROP_BOUNDARY_X,
        boundary_y: Tuple[int, int] = CROP_BOUNDARY_Y,
        boundary_z: Tuple[float, float] = CROP_BOUNDARY_Z,
    ) -> "CropBox":
        """The head-and-neck box: x/y in absolute pixels, z as ceil-rounded
        fractions of the slice count."""
        z = (
            math.ceil(boundary_z[0] * num_slides),
            math.ceil(boundary_z[1] * num_slides),
        )
        return cls(z=z, x=tuple(boundary_x), y=tuple(boundary_y))

    def apply(self, data: np.ndarray) -> np.ndarray:
        return data[
            :, self.z[0] : self.z[1], self.x[0] : self.x[1], self.y[0] : self.y[1]
        ]


@dataclasses.dataclass
class Volume:
    """One image volume as a (C=1, D, H, W) array."""

    data: np.ndarray
    path: Optional[str] = None
    header: Optional[Dict] = None

    def __post_init__(self):
        self.data = np.asarray(self.data)
        if self.data.ndim != 4 or self.data.shape[0] != 1:
            raise ValueError(
                "Volume wants a (C=1, D, H, W) array, got shape "
                f"{self.data.shape}"
            )

    @classmethod
    def from_nrrd(cls, path: PathLike) -> "Volume":
        data, header = load_nrrd_as_array(path)
        return cls(data=data, path=str(path), header=header)

    def __repr__(self):
        return f"Volume(shape={self.data.shape}, path={self.path})"

    def as_numpy(self, reverse_dims: bool = False) -> np.ndarray:
        if reverse_dims:
            return np.transpose(self.data, (2, 3, 1, 0))  # (H, W, D, C)
        return self.data
