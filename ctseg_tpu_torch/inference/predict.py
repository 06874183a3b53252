"""Single-scan segmentation (port of ctseg_tpu/inference/predict.py).

A checkpoint's slice model segments one scan, a patient directory or a
whole split, and writes, per patient:

  <out>/<patient>/segmentation.nrrd      label map 0..9 (PDDCA axis order,
                                         the input header's space carried over)
  <out>/<patient>/structures/<name>.nrrd binary mask per structure

A 2D checkpoint's slices run through its test transform (windowing +
resize + normalize), the model, argmax, and a nearest resize back to the
native in-plane size. A 3D checkpoint (its config's `spatial_dims`) runs
native-resolution sliding-window inference with Gaussian blending
(inference/sliding_window.py). With crop (the default) prediction happens
inside the anatomical head-and-neck box and is pasted into a background
volume.

A 2D scan is pipelined with the device: each batch of slices is staged in
the scan's own dtype in a host buffer (page-locked on a CUDA device, kept
from scan to scan by `ScanBuffers`), copied to the device without waiting,
cast to float32 there and segmented; once every batch is launched the host
makes the fresh output map, then waits once for the whole scan's labels.
Under a profiler a scan is the span `ctseg.scan`, its parts
`ctseg.scan.crop` (the box; the output map), per batch `.cast` (its
staging), `.h2d` (its copy in and cast) and `.forward`, then `.store` (the
one wait `ctseg.sync` and the copy out) and `.paste` (utils/profiling.py).

Usage:
  python -m ctseg_tpu_torch.inference.predict --checkpoint model.ckpt \\
      --input <patient dir or img.nrrd or split dir> --out predictions/
"""

import math
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ctseg_tpu_torch.constants import NUM_CLASSES, STRUCTURES
from ctseg_tpu_torch.inference.sliding_window import (
    AIR_HU,
    volume_labels,
    volume_to_device,
)
from ctseg_tpu_torch.models.released import (
    add_released_args,
    resolve_checkpoint_arg,
)
from ctseg_tpu_torch.ops.masks import squash_predictions
from ctseg_tpu_torch.training.config import (
    TrainConfig,
    load_checkpoint,
    model_dtype,
)
from ctseg_tpu_torch.transforms.pipelines import TransformFn, get_transform
from ctseg_tpu_torch.utils import nrrd_io
from ctseg_tpu_torch.utils.miccai import CropBox, Volume
from ctseg_tpu_torch.utils.profiling import span, to_host


def slice_labels(
    model: torch.nn.Module,
    transform: TransformFn,
    slices: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, H, W) float32 raw HU on the model's device -> (B, H, W) uint8:
    the test transform, the model in the compute `dtype` (the config's, not
    the parameters', which stay float32 under bfloat16 compute), argmax,
    and a nearest resize back to (H, W). The per-batch computation of
    `predict_labels_2d` and of the exported slice model
    (inference/export.py)."""
    imgs, _ = transform(slices)  # (B, S, S, C)
    x = imgs.to(dtype).permute(0, 3, 1, 2)
    x = x.contiguous(memory_format=torch.channels_last)
    preds = squash_predictions(model(x), dim=1)  # (B, S, S)
    full = F.interpolate(
        preds[:, None].to(torch.float32), size=tuple(slices.shape[1:]),
        mode="nearest-exact",
    )[:, 0]
    return full.to(torch.uint8)


# Scan dtypes staged as they are: float32 holds each of their values
# exactly, so the cast on the device gives numpy's float32 cast bit for bit.
# Any other dtype (or byte order) is cast to float32 on the host as it is
# staged.
_STAGED = {np.dtype(t): getattr(torch, t)
           for t in ("int8", "uint8", "int16", "float16", "float32")}


class ScanBuffers:
    """Host buffers of the 2D scan path, kept from scan to scan: the
    region's slices on their way to the device, in the scan's own dtype,
    and the box's labels on their way back. Page-locked when the device is
    CUDA, so both copies run without a bounce through pageable memory; each
    grows to the largest scan seen.

    One scan at a time may use them. Reuse is safe because every scan ends
    in one blocking copy of its labels to the host on the stream that
    copied its slices in (`to_host`): when the next scan fills a buffer, no
    copy of the last one still reads or writes it."""

    def __init__(self, device):
        self.pinned = torch.device(device).type == "cuda"
        self._held = {}

    def take(self, role: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A host tensor of `shape` and `dtype` for `role`, its contents
        left from the last scan."""
        n = math.prod(shape)
        held = self._held.get((role, dtype))
        if held is None or held.numel() < n:
            held = torch.empty(n, dtype=dtype, pin_memory=self.pinned)
            self._held[(role, dtype)] = held
        return held[:n].view(tuple(shape))


def _labels_2d(model, transform, region, device, batch_size, dtype,
               buffers: ScanBuffers, shape, box: Optional[CropBox]):
    """The fresh (D, H, W) uint8 map of `shape` holding the labels of the
    raw HU `region`, which `box` cut from it (None: the region is the map).

    Every batch is staged in `buffers`, copied in (without a wait on a CUDA
    device), cast to float32 on the device and segmented into one device
    map before the host waits, once, for that map."""
    device = torch.device(device)
    d, h, w = region.shape
    staged = buffers.take("slices", region.shape,
                          _STAGED.get(region.dtype, torch.float32))
    host = staged.numpy()
    non_blocking = device.type == "cuda"
    with torch.inference_mode():
        labels = torch.empty((d, h, w), dtype=torch.uint8, device=device)
        for lo in range(0, d, batch_size):
            hi = min(lo + batch_size, d)
            with span("ctseg.scan.cast"):
                np.copyto(host[lo:hi], region[lo:hi], casting="unsafe")
            with span("ctseg.scan.h2d"):
                slices = staged[lo:hi].to(device, non_blocking=non_blocking)
                slices = slices.to(torch.float32)
            with span("ctseg.scan.forward"):
                labels[lo:hi] = slice_labels(model, transform, slices, dtype)
    # While the device runs: the fresh map, its pages faulted in.
    with span("ctseg.scan.crop"):
        full = np.empty(shape, np.uint8)
        full.fill(0)
    with span("ctseg.scan.store"):
        if box is None:
            to_host(labels, out=torch.from_numpy(full))
            return full
        boxed = to_host(labels, out=buffers.take(
            "labels", labels.shape, torch.uint8)).numpy()
    with span("ctseg.scan.paste"):
        full[box.z[0] : box.z[1], box.x[0] : box.x[1],
             box.y[0] : box.y[1]] = boxed
    return full


def predict_labels_2d(
    model: torch.nn.Module,
    transform: TransformFn,
    volume: np.ndarray,
    device,
    batch_size: int = 32,
    dtype: torch.dtype = torch.float32,
) -> np.ndarray:
    """(D, H, W) raw HU -> (D, H, W) uint8 label map via the slice model.

    Slices are cast to float32 before the transform, as the JAX path does,
    then `slice_labels` runs per batch. The last batch is simply shorter
    (eager PyTorch keeps no per-shape program cache).
    """
    return _labels_2d(model, transform, volume, device, batch_size, dtype,
                      ScanBuffers(device), volume.shape, None)


def predict_labels_3d(
    model: torch.nn.Module,
    config: TrainConfig,
    volume: np.ndarray,
    device="cuda",
    patch_size: Tuple[int, int, int] = (128, 128, 48),
    overlap: float = 0.5,
    batch_size: int = 4,
) -> np.ndarray:
    """(D, H, W) raw HU -> (D, H, W) uint8 via sliding-window blending.

    An axis shorter than the patch is padded with air (-1024 HU) up to it;
    the volume stays in its own dtype until it is on the device. Patch-mode
    checkpoints see the soft-tissue window they trained on, resize-mode
    ones raw HU, as in the reference.
    """
    d, h, w = volume.shape
    image = volume_to_device(volume, patch_size, AIR_HU, device)
    labels = volume_labels(model, image, patch_size, overlap, batch_size,
                           window=config.volumetric_mode == "patch")
    return to_host(labels[:h, :w, :d].movedim(-1, 0).to(torch.uint8)).numpy()


def predict_scan(
    model: torch.nn.Module,
    config: TrainConfig,
    volume: Volume,
    device,
    crop: bool = True,
    batch_size: int = 32,
    patch_size: Tuple[int, int, int] = (128, 128, 48),
    overlap: float = 0.5,
    buffers: Optional[ScanBuffers] = None,
) -> np.ndarray:
    """Segment one scan -> (D, H, W) uint8 label map at native resolution,
    a fresh array each call. `batch_size` counts a 2D model's slices; a 3D
    model takes windows of `patch_size` with `overlap`, 4 at a time.
    `buffers` (a caller's, kept between scans) stage a 2D scan; without
    them the call makes its own."""
    data = volume.as_numpy()[0]  # (D, H, W)
    with span("ctseg.scan", {"depth": data.shape[0]}):
        with span("ctseg.scan.crop"):
            box = CropBox.anatomical(data.shape[0]) if crop else None
            region = box.apply(data[None])[0] if box else data

        if config.spatial_dims != 3:
            transform = get_transform(
                config.transform_degree, train=False,
                size=(config.input_size,) * 2
            )
            return _labels_2d(model, transform, region, device, batch_size,
                              model_dtype(config),
                              buffers or ScanBuffers(device), data.shape, box)
        labels = predict_labels_3d(model, config, region, device,
                                   patch_size=patch_size, overlap=overlap)
        if box is None:
            return labels
        with span("ctseg.scan.paste"):
            full = np.zeros(data.shape, np.uint8)
            full[box.z[0] : box.z[1], box.x[0] : box.x[1],
                 box.y[0] : box.y[1]] = labels
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


def main(argv=None):
    parser = ArgumentParser(description="Segment CT scans with a checkpoint")
    parser.add_argument(
        "--checkpoint", default=None,
        help="a port checkpoint or a reference Lightning .ckpt file",
    )
    add_released_args(parser)
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
    parser.add_argument("--patch_size", type=int, nargs=3,
                        default=(128, 128, 48), help="3D checkpoints only")
    parser.add_argument("--overlap", type=float, default=0.5,
                        help="3D checkpoints only")
    parser.add_argument("--no_structures", action="store_true",
                        help="write only the label map")
    args = parser.parse_args(argv)

    config, model = load_checkpoint(resolve_checkpoint_arg(args), args.device)
    for name, img_path in _scan_paths(Path(args.input)):
        volume = Volume.from_nrrd(img_path)
        labels = predict_scan(
            model, config, volume, args.device, crop=not args.no_crop,
            patch_size=tuple(args.patch_size), overlap=args.overlap,
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
