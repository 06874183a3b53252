"""Single-scan segmentation (port of ctseg_tpu/inference/predict.py, 2D).

A checkpoint's slice model segments one scan, a patient directory or a
whole split, and writes, per patient:

  <out>/<patient>/segmentation.nrrd      label map 0..9 (PDDCA axis order,
                                         the input header's space carried over)
  <out>/<patient>/structures/<name>.nrrd binary mask per structure

Slices run through the checkpoint's test transform (windowing + resize +
normalize), the model, argmax, and a nearest resize back to the native
in-plane size. With crop (the default) prediction happens inside the
anatomical head-and-neck box and is pasted into a background volume. 3D
checkpoints wait for the port's 3D slice.

Usage:
  python -m ctseg_tpu_torch.inference.predict --checkpoint model.ckpt \\
      --input <patient dir or img.nrrd or split dir> --out predictions/
"""

from argparse import ArgumentParser
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ctseg_tpu_torch.constants import NUM_CLASSES, STRUCTURES
from ctseg_tpu_torch.ops.masks import squash_predictions
from ctseg_tpu_torch.training.config import (
    TrainConfig,
    load_checkpoint,
    model_dtype,
)
from ctseg_tpu_torch.transforms.pipelines import TransformFn, get_transform
from ctseg_tpu_torch.utils import nrrd_io
from ctseg_tpu_torch.utils.miccai import CropBox, Volume


def predict_labels_2d(
    model: torch.nn.Module,
    transform: TransformFn,
    volume: np.ndarray,
    device,
    batch_size: int = 32,
    dtype: torch.dtype = torch.float32,
) -> np.ndarray:
    """(D, H, W) raw HU -> (D, H, W) uint8 label map via the slice model.

    Slices are cast to float32 before the transform, as the JAX path does;
    the transformed batch then takes the compute `dtype` (the config's, not
    the parameters', which stay float32 under bfloat16 compute). The last
    batch is simply shorter (eager PyTorch keeps no per-shape program cache).
    """
    d, h, w = volume.shape
    out = np.zeros((d, h, w), np.uint8)
    with torch.inference_mode():
        for lo in range(0, d, batch_size):
            chunk = np.asarray(volume[lo : lo + batch_size], np.float32)
            slices = torch.from_numpy(chunk).to(device)
            imgs, _ = transform(slices)  # (B, S, S, C)
            x = imgs.to(dtype).permute(0, 3, 1, 2)
            x = x.contiguous(memory_format=torch.channels_last)
            preds = squash_predictions(model(x), dim=1)  # (B, S, S)
            full = F.interpolate(
                preds[:, None].to(torch.float32), size=(h, w),
                mode="nearest-exact",
            )[:, 0]
            out[lo : lo + batch_size] = full.to(torch.uint8).cpu().numpy()
    return out


def predict_scan(
    model: torch.nn.Module,
    config: TrainConfig,
    volume: Volume,
    device,
    crop: bool = True,
    batch_size: int = 32,
) -> np.ndarray:
    """Segment one scan -> (D, H, W) uint8 label map at native resolution."""
    if config.spatial_dims != 2:
        raise NotImplementedError(
            "3D checkpoints wait for the port's 3D slice (ROADMAP.md, "
            "modules to port: 3D)"
        )
    data = volume.as_numpy()[0]  # (D, H, W)
    box = CropBox.anatomical(data.shape[0]) if crop else None
    region = box.apply(data[None])[0] if box else data

    transform = get_transform(
        config.transform_degree, train=False, size=(config.input_size,) * 2
    )
    labels = predict_labels_2d(model, transform, region, device, batch_size,
                               dtype=model_dtype(config))
    if box is None:
        return labels
    full = np.zeros(data.shape, np.uint8)
    full[box.z[0] : box.z[1], box.x[0] : box.x[1], box.y[0] : box.y[1]] = labels
    return full


def write_artifacts(
    out_dir: Path, labels: np.ndarray, header: Optional[dict],
    structures: bool = True,
) -> None:
    """Write segmentation.nrrd (+ per-structure masks) in PDDCA axis order.

    `labels` is (D, H, W); files store (H, W, D) like the inputs, carrying
    the source header's space metadata so spacing survives the round trip.
    """
    out_dir.mkdir(parents=True, exist_ok=True)
    hwd = np.transpose(labels, (1, 2, 0))  # (H, W, D)
    keep = {
        k: v
        for k, v in (header or {}).items()
        if k in ("space", "space directions", "space origin", "space units")
    }
    nrrd_io.write(out_dir / "segmentation.nrrd", hwd.astype(np.uint8), keep)
    if structures:
        sdir = out_dir / "structures"
        sdir.mkdir(exist_ok=True)
        for i, name in enumerate(STRUCTURES, start=1):
            nrrd_io.write(
                sdir / f"{name}.nrrd", (hwd == i).astype(np.uint8), keep
            )


def _scan_paths(input_path: Path):
    """Yield (patient_name, img.nrrd path) for a file, patient dir, or a
    directory of patient dirs."""
    if input_path.is_file():
        yield input_path.parent.name or input_path.stem, input_path
        return
    direct = input_path / "img.nrrd"
    if direct.exists():
        yield input_path.name, direct
        return
    found = False
    for patient in sorted(input_path.iterdir()):
        img = patient / "img.nrrd"
        if img.exists():
            found = True
            yield patient.name, img
    if not found:
        raise FileNotFoundError(
            f"no img.nrrd under {input_path} (expected a scan file, a "
            "patient directory, or a directory of patient directories)"
        )


def main():
    parser = ArgumentParser(description="Segment CT scans with a checkpoint")
    parser.add_argument(
        "--checkpoint", required=True,
        help="a port checkpoint or a reference Lightning .ckpt file",
    )
    parser.add_argument(
        "--input", required=True,
        help="img.nrrd, a patient dir, or a dir of patient dirs",
    )
    parser.add_argument("--out", default="predictions")
    parser.add_argument("--device", default="cuda")
    parser.add_argument(
        "--no_crop", action="store_true",
        help="segment the full volume instead of the anatomical box",
    )
    parser.add_argument("--no_structures", action="store_true",
                        help="write only the label map")
    args = parser.parse_args()

    config, model = load_checkpoint(args.checkpoint, args.device)
    for name, img_path in _scan_paths(Path(args.input)):
        volume = Volume.from_nrrd(img_path)
        labels = predict_scan(
            model, config, volume, args.device, crop=not args.no_crop
        )
        write_artifacts(
            Path(args.out) / name, labels, volume.header,
            structures=not args.no_structures,
        )
        counts = np.bincount(labels.ravel(), minlength=NUM_CLASSES)[1:]
        voxels = {s: int(n) for s, n in zip(STRUCTURES, counts)}
        print(f"{name}: wrote {Path(args.out) / name} voxels={voxels}")


if __name__ == "__main__":
    main()
