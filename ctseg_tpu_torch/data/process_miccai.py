"""Convert raw PDDCA patient volumes to training-ready data (a copy of
ctseg_tpu/data/process_miccai.py: the port never imports the JAX package;
tests/test_torch_data_prep.py pins the code of the two copies equal,
docstrings aside).

Capability parity with reference capstone/data/process_miccai.py (per-slice /
per-volume npz with {image, masks, mask_indicator}, empty slices dropped,
default anatomical crop) plus the packed format: after conversion each split
is packed into one dense npz (`PackedDataset2D/3D`) that the device pipeline
(data/pipeline.py) copies to the card once.

Usage:
    python -m ctseg_tpu_torch.data.process_miccai convert_2d [--root_dir --save_dir --no_crop]
    python -m ctseg_tpu_torch.data.process_miccai convert_3d [...]
    python -m ctseg_tpu_torch.data.process_miccai pack_2d   [--save_dir]
"""

from argparse import ArgumentParser
from pathlib import Path
from typing import Optional

import numpy as np

from ctseg_tpu_torch.constants import NUM_STRUCTURES, STRUCTURES
from ctseg_tpu_torch.data.datasets import pack_slices, pack_volumes
from ctseg_tpu_torch.paths import DEFAULT_DATA_STORAGE
from ctseg_tpu_torch.utils import miccai


def _patient_to_2d(patient: miccai.Patient, save_location: Path, crop: bool = True):
    if crop:
        patient.crop_data()
    patient_id = Path(patient.patient_dir).stem
    vol = patient.image.as_numpy()  # (1, D, H, W)

    # In-plane (row, col) voxel spacing from the NRRD header: the patient
    # spacing is z-first (z, y, x) matching (D, H, W) (reference
    # capstone/utils/miccai.py:77-82), so a (H, W) slice keeps spacing[1:].
    # The reference's per-slice npz contract drops it; carrying it lets 2D
    # HD95 report millimetres like the 3D path.
    extra = {}
    spacing = patient.image.spacing
    if spacing is not None:
        extra["spacing"] = np.asarray(spacing, np.float32)[1:]

    for index in range(patient.num_slides):
        slide = vol[:, index]  # (1, H, W)
        mask_indicator = np.ones(NUM_STRUCTURES)
        all_zeros = np.zeros_like(slide[0], dtype="uint8")
        region_slides = []
        for i, structure in enumerate(STRUCTURES):
            region_volume = patient.structures[structure]
            if region_volume is not None:
                region_slides.append(region_volume.as_numpy()[0, index])
            else:
                region_slides.append(all_zeros)
                mask_indicator[i] = 0
        masks = np.stack(region_slides)  # (9, H, W)

        # Slices with no structure present carry no training signal — drop
        # (reference process_miccai.py:86).
        if masks.sum() > 0:
            np.savez(
                (save_location / f"{patient_id}_{index}.npz").as_posix(),
                image=slide,
                masks=masks,
                mask_indicator=mask_indicator,
                **extra,
            )


def _patient_to_3d(patient: miccai.Patient, save_location: Path, crop: bool = True):
    if crop:
        patient.crop_data()
    patient_id = Path(patient.patient_dir).stem
    vol = patient.image.as_numpy()  # (1, D, H, W)

    mask_indicator = np.ones(NUM_STRUCTURES)
    all_zeros = np.zeros_like(vol[0], dtype="uint8")
    region_slides = []
    for i, structure in enumerate(STRUCTURES):
        region_volume = patient.structures[structure]
        if region_volume is not None:
            region_slides.append(region_volume.as_numpy()[0])
        else:
            region_slides.append(all_zeros)
            mask_indicator[i] = 0
    masks = np.stack(region_slides)  # (9, D, H, W)

    if masks.sum() > 0:
        extra = {}
        # Voxel spacing from the NRRD header, z-first like the volume
        # layout — the reference's npz contract drops it (capstone/data/
        # process_miccai.py:95-131), leaving surface metrics in voxel
        # units; carrying it lets HD95 report millimetres downstream.
        spacing = patient.image.spacing
        if spacing is not None:
            extra["spacing"] = np.asarray(spacing, np.float32)
        np.savez(
            (save_location / f"{patient_id}.npz").as_posix(),
            image=vol,
            masks=masks,
            mask_indicator=mask_indicator,
            **extra,
        )


def _convert(fn, read_dir, save_dir, split: Optional[str], crop: bool):
    read_location = Path(read_dir)
    save_location = Path(save_dir)
    if split is not None:
        read_location = read_location / split
        save_location = save_location / split
    save_location.mkdir(parents=True, exist_ok=True)
    collection = miccai.PatientCollection(read_location.as_posix())
    collection.apply_function(fn, save_location=save_location, crop=crop)


def convert_to_2d(read_dir, save_dir, split=None, crop=True):
    _convert(_patient_to_2d, read_dir, save_dir, split, crop)


def convert_to_3d(read_dir, save_dir, split=None, crop=True):
    _convert(_patient_to_3d, read_dir, save_dir, split, crop)


def pack_2d(npz_root, out_root=None):
    """Pack per-slice npz splits into dense per-split files."""
    npz_root = Path(npz_root)
    out_root = Path(out_root) if out_root else npz_root
    for split in ("train", "valid", "test"):
        if (npz_root / split).is_dir():
            ds = pack_slices(npz_root / split)
            ds.save(out_root / f"{split}_packed.npz")
            print(f"packed {split}: {len(ds)} slices of {ds.spatial_shape}")


def pack_3d(npz_root, out_root=None):
    npz_root = Path(npz_root)
    out_root = Path(out_root) if out_root else npz_root
    for split in ("train", "valid", "test"):
        if (npz_root / split).is_dir():
            ds = pack_volumes(npz_root / split)
            ds.save(out_root / f"{split}_packed.npz")
            print(f"packed {split}: {len(ds)} volumes")


def main():
    parser = ArgumentParser(description="Process MICCAI")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("convert_2d", "convert_3d", "pack_2d", "pack_3d"):
        p = sub.add_parser(name)
        p.add_argument("--root_dir", type=str, default=None)
        p.add_argument("--save_dir", type=str, default=None)
        p.add_argument("--no_crop", action="store_true", default=False)
    args = parser.parse_args()

    storage = Path(DEFAULT_DATA_STORAGE)
    if args.command in ("convert_2d", "convert_3d"):
        root = args.root_dir or (storage / "miccai").as_posix()
        suffix = "miccai_2d" if args.command == "convert_2d" else "miccai_3d"
        save = args.save_dir or (storage / suffix).as_posix()
        fn = convert_to_2d if args.command == "convert_2d" else convert_to_3d
        for split in ("train", "valid", "test"):
            fn(root, save, split, not args.no_crop)
    elif args.command == "pack_2d":
        pack_2d(args.root_dir or (storage / "miccai_2d"), args.save_dir)
    elif args.command == "pack_3d":
        pack_3d(args.root_dir or (storage / "miccai_3d"), args.save_dir)


if __name__ == "__main__":
    main()
