"""PDDCA domain model: volumes, patients, collections (numpy, host-side) (a
copy of ctseg_tpu/utils/miccai.py: the port never imports the JAX package;
tests/test_torch_data_prep.py pins the code of the two copies equal,
docstrings aside).

Covers the reference's data-domain capability (capstone/utils/miccai.py:
Volume/Patient/PatientCollection and the NRRD ingest contract) with this
framework's own structure: immutable dataclasses, a shared `CropBox` value
object for the anatomical crop, functional (non-mutating) volume ops, and
lazy landmark parsing. Host arrays are channel-first (C, D, H, W); device
work happens later in the device pipeline, never here.

Numeric contracts kept bit-identical to the reference (and pinned by
tests/test_data.py): NRRD (H, W, D) -> (C, D, H, W) axis order
(miccai.py:286-296), z-first spacing from the header diagonal
(miccai.py:77-82), and the empirically derived crop box — x/y absolute
pixel bounds, z ceil-rounded fractions of the slice count
(miccai.py:193-227, derived in notebooks/miccai_batch_exploration.ipynb).
"""

import dataclasses
import functools
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ctseg_tpu_torch.constants import (
    CROP_BOUNDARY_X,
    CROP_BOUNDARY_Y,
    CROP_BOUNDARY_Z,
    STRUCTURES,
)
from ctseg_tpu_torch.utils import nrrd_io
from ctseg_tpu_torch.utils.attrdict import AttrDict

PathLike = Union[str, Path]

# Slicer fiducial CSV column order (*.fcsv files shipped with PDDCA).
LANDMARK_COLS: List[str] = [
    "id", "x", "y", "z", "ow", "ox", "oy", "oz",
    "vis", "sel", "lock", "label", "desc", "associatedNodeID",
]


def load_nrrd_as_array(path: PathLike) -> Tuple[np.ndarray, Dict]:
    """NRRD file -> ((C, D, H, W) array, raw header).

    PDDCA stores (H, W, D); a singleton channel axis is added and axes are
    reordered channel-first/z-first (the layout every downstream consumer
    assumes; reference contract miccai.py:286-296).
    """
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
        fractions of the slice count (reference miccai.py:193-227)."""
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
    """One image or binary-mask volume as a (C, D, H, W) array.

    Construct from an array directly or via `Volume.from_nrrd`; `crop`
    returns a new Volume rather than mutating (volumes flow through the
    conversion pipeline as values).
    """

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

    @property
    def spacing(self) -> Optional[np.ndarray]:
        """Voxel spacing, z-first to match the (C, D, H, W) layout.

        The header's space-directions diagonal is per RAW file axis —
        (H, W, D) order (load_nrrd_as_array) — so the permutation here must
        mirror the data transpose exactly: (s_D, s_H, s_W). A plain reversal
        would swap the in-plane spacings (invisible on isotropic-in-plane
        scans like PDDCA, wrong in mm on anisotropic ones); the reference's
        `spacing` (miccai.py:77-82) is display-only so its order was never
        load-bearing, ours feeds the mm HD95.
        """
        if self.header is not None and "space directions" in self.header:
            diag = np.asarray(self.header["space directions"]).diagonal()
            return diag[[2, 0, 1]]
        return None

    def crop(self, box: CropBox) -> "Volume":
        return Volume(data=box.apply(self.data), path=self.path, header=self.header)

    def as_numpy(self, reverse_dims: bool = False) -> np.ndarray:
        if reverse_dims:
            return np.transpose(self.data, (2, 3, 1, 0))  # (H, W, D, C)
        return self.data

    def as_grid(
        self, nrow: int = 4, pad_value: float = 1.0, reverse_dims: bool = True
    ) -> np.ndarray:
        """Tile the D slices into one (nH, nW[, C]) gallery image (the
        notebook browser's contact sheet; reference miccai.py:111-123)."""
        data = np.asarray(self.data, dtype=np.float64)  # (1, D, H, W)
        d, h, w = data.shape[1:]
        rows = -(-d // nrow)
        pad = 2
        grid = np.full((rows * (h + pad) + pad, nrow * (w + pad) + pad), pad_value)
        for i in range(d):
            r, c = divmod(i, nrow)
            top, left = r * (h + pad) + pad, c * (w + pad) + pad
            grid[top : top + h, left : left + w] = data[0, i]
        return grid[..., None] if reverse_dims else grid[None]


def _parse_fcsv(path: PathLike) -> List[Dict]:
    """Parse a Slicer .fcsv fiducial file into row dicts (comments skipped)."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            rows.append(dict(zip(LANDMARK_COLS, line.split(","))))
    return rows


class Patient:
    """One PDDCA patient directory: img.nrrd + structures/*.nrrd + *.fcsv.

    Eagerly loads the CT image and every present structure mask (keyed by
    the canonical STRUCTURES order, None where a structure was not
    annotated); landmark parsing is deferred until first access.
    """

    def __init__(self, patient_dir: PathLike):
        directory = Path(patient_dir)
        self._dir = directory
        self.image = Volume.from_nrrd(directory / "img.nrrd")
        self.structures = AttrDict()
        structures_dir = directory / "structures"
        available = (
            {p.stem: p for p in structures_dir.iterdir()}
            if structures_dir.is_dir()
            else {}
        )
        for name in STRUCTURES:
            path = available.get(name)
            self.structures[name] = Volume.from_nrrd(path) if path else None

    def __repr__(self):
        return f"Patient({self._dir})"

    @property
    def patient_dir(self) -> str:
        return str(self._dir)

    @property
    def num_slides(self) -> int:
        return self.image.data.shape[1]

    @functools.cached_property
    def landmarks(self) -> Optional[List[Dict]]:
        fcsv = sorted(self._dir.glob("*.fcsv"))
        return _parse_fcsv(fcsv[0]) if fcsv else None

    def present_structures(self) -> List[str]:
        return [s for s in STRUCTURES if self.structures[s] is not None]

    def crop_data(
        self,
        boundary_x: Tuple[int, int] = CROP_BOUNDARY_X,
        boundary_y: Tuple[int, int] = CROP_BOUNDARY_Y,
        boundary_z: Tuple[float, float] = CROP_BOUNDARY_Z,
    ) -> CropBox:
        """Crop the image and every structure to the anatomical box; the
        same CropBox is applied to all volumes and returned."""
        box = CropBox.anatomical(self.num_slides, boundary_x, boundary_y, boundary_z)
        self.image = self.image.crop(box)
        for name in self.present_structures():
            self.structures[name] = self.structures[name].crop(box)
        return box

    def combine_segmentation_masks(self, names: Sequence[str]) -> np.ndarray:
        """Logical-OR overlay of the selected structure masks, (C, D, H, W)."""
        unknown = [n for n in names if n not in STRUCTURES]
        if unknown:
            raise ValueError(f"unknown structures: {unknown}; pick from {STRUCTURES}")
        if len(names) < 2:
            raise ValueError("combining masks needs at least 2 structures")
        stacks = [
            self.structures[n].data.astype(bool)
            for n in names
            if self.structures[n] is not None
        ]
        if not stacks:
            # PDDCA patients routinely miss structures (that is what
            # mask_indicator records); an empty overlay is all background.
            return np.zeros(self.image.data.shape, np.uint8)
        return functools.reduce(np.logical_or, stacks).astype(np.uint8)


class PatientCollection:
    """All `0522c*` patient directories under a path, with a map helper."""

    def __init__(self, path: PathLike):
        self._path = Path(path)
        self._patient_paths = {
            d.name: d.as_posix() for d in sorted(self._path.glob("0522c*"))
        }
        if not self._patient_paths:
            raise FileNotFoundError(
                f"no PDDCA patient directories (0522c*) under {self._path}"
            )

    def __len__(self):
        return len(self._patient_paths)

    @property
    def patient_paths(self) -> Dict[str, str]:
        return self._patient_paths

    def apply_function(
        self, func: Callable, disable_progress: bool = False, **kwargs
    ) -> Dict:
        """{patient_id: func(Patient, **kwargs)} over the collection."""
        try:
            from tqdm import tqdm

            items = tqdm(self.patient_paths.items(), disable=disable_progress)
        except ImportError:
            items = self.patient_paths.items()
        return {name: func(Patient(path), **kwargs) for name, path in items}
