"""Synthetic PDDCA-like patients (a copy of ctseg_tpu/testing/synth.py's
`make_patient`, so the port's smoke runs and tests make scans without JAX).

Generates a patient directory with the exact on-disk layout the real dataset
has (img.nrrd + structures/*.nrrd + optional landmarks .fcsv), with small
ellipsoid "organs" so segmentation sees non-degenerate masks.
"""

from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ctseg_tpu_torch.constants import STRUCTURES
from ctseg_tpu_torch.utils import nrrd_io


def make_patient(
    directory: Union[str, Path],
    shape: Tuple[int, int, int] = (48, 96, 96),  # (D, H, W)
    structures: Optional[Sequence[str]] = None,
    seed: int = 0,
    with_landmarks: bool = True,
) -> Path:
    """Create one synthetic patient dir. `structures` defaults to all 9."""
    directory = Path(directory)
    (directory / "structures").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    d, h, w = shape

    # CT-like HU volume: soft-tissue background, air pockets, bone blobs.
    img = rng.normal(40.0, 30.0, size=(d, h, w)).astype(np.float32)
    img[:, : h // 8] = -1000.0  # air
    zz, yy, xx = np.mgrid[0:d, 0:h, 0:w]

    chosen = list(structures if structures is not None else STRUCTURES)
    for i, structure in enumerate(STRUCTURES):
        if structure not in chosen:
            continue
        # Each structure has a characteristic location (3x3 grid anchor +
        # jitter) and density, so the class map is learnable. Anchors stay
        # inside the default anatomical crop box of a 512 grid.
        ay = 0.30 + 0.17 * (i % 3)
        ax = 0.30 + 0.15 * (i // 3)
        cz = d // 2 + rng.integers(-d // 8, d // 8 + 1)
        cy = int(ay * h) + rng.integers(-h // 12, h // 12 + 1)
        cx = int(ax * w) + rng.integers(-w // 12, w // 12 + 1)
        rz = rng.integers(2, max(3, d // 6))
        ry = rng.integers(h // 16 + 2, h // 9 + 3)
        rx = rng.integers(w // 16 + 2, w // 9 + 3)
        mask = (
            ((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        ) <= 1.0
        # class-specific density, kept inside the soft-tissue window
        img[mask] = img[mask] + 35.0 + 13.0 * i
        # NRRD files store (H, W, D) like the real dataset.
        nrrd_io.write(
            directory / "structures" / f"{structure}.nrrd",
            np.transpose(mask.astype(np.uint8), (1, 2, 0)),
            header={"space directions": np.diag([1.1, 1.1, 3.0])},
        )

    nrrd_io.write(
        directory / "img.nrrd",
        np.transpose(img, (1, 2, 0)).astype(np.int16),
        header={"space directions": np.diag([1.1, 1.1, 3.0])},
    )

    if with_landmarks:
        lines = ["# Markups fiducial file"]
        for j in range(3):
            lines.append(
                f"vtkMRMLMarkupsFiducialNode_{j},{rng.random():.2f},"
                f"{rng.random():.2f},{rng.random():.2f},0,0,0,1,1,1,0,F-{j},,"
            )
        (directory / "landmarks.fcsv").write_text("\n".join(lines))
    return directory
