"""Evaluation: per-structure Dice and HD95 reports from a checkpoint (port
of ctseg_tpu/inference/evaluate.py).

Covers the reference's `trainer.test(...)` path (base_trainer.py:246) and
adds HD95. A 2D checkpoint is evaluated slice by slice (`evaluate_2d`), a
3D one on whole volumes by sliding-window blending
(`evaluate_3d_sliding_window`), as its config's `spatial_dims` says. The
result prints as a table and is written as JSON; its keys are the JAX
package's, so one report reads both.

    python -m ctseg_tpu_torch.inference.evaluate --checkpoint CKPT \\
        [--data_dir DIR] [--split test] [--hd95] [--out results.json] \\
        [--patch_size 128 128 48 --overlap 0.5 --throughput]  # 3D
"""

import json
import time
from argparse import ArgumentParser
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ctseg_tpu_torch.constants import NUM_CLASSES, STRUCTURES
from ctseg_tpu_torch.data.datasets import PackedDataset2D, PackedDataset3D
from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
from ctseg_tpu_torch.inference.sliding_window import (
    AIR_HU,
    volume_labels,
    volume_logits,
    volume_to_device,
)
from ctseg_tpu_torch.metrics.dice import dice_per_sample_class, masked_mean_batch
from ctseg_tpu_torch.metrics.hd95 import hd95_per_structure_device
from ctseg_tpu_torch.models.released import (
    add_released_args,
    resolve_checkpoint_arg,
)
from ctseg_tpu_torch.models.unet import SegmentationModel
from ctseg_tpu_torch.paths import DEFAULT_DATA_STORAGE
from ctseg_tpu_torch.training.config import TrainConfig
from ctseg_tpu_torch.training.trainer import Trainer


@torch.no_grad()
def evaluate_2d(
    trainer: Trainer,
    model: SegmentationModel,
    dataset: PackedDataset2D,
    batch_size: Optional[int] = None,
    with_hd95: bool = False,
) -> Dict:
    """Slice-wise evaluation on the trainer's device, with dataset-level (not
    step-averaged) Dice.

    Unlike the training loop's logging (the reference's step-averaged
    Lightning semantics), this accumulates per-(sample, class) Dice over
    the whole split before the masked reduction: the aggregate for final
    reporting. Every slice is evaluated exactly once: the trailing partial
    batch is padded and its padded rows are masked out of `valid`.

    With `with_hd95` and per-slice spacings in the split, HD95 is in
    millimetres: each batch carries its samples' indices, so each slice is
    measured with its own header spacing, scaled by raw/model size per axis
    (the metric runs on the model's grid, after the test transform's
    resize). Without spacings it is in voxels. Everything accumulates on
    the device and is fetched once at the end.
    """
    if len(dataset) == 0:
        raise ValueError("evaluate_2d: empty dataset")
    batch_size = min(batch_size or 64, len(dataset))
    pipe = DevicePipeline2D(dataset, batch_size, trainer.device)
    use_spacing = with_hd95 and pipe.spacings is not None
    if use_spacing:
        h, w = dataset.spatial_shape
        size = trainer.config.input_size
        spacings = pipe.spacings * torch.tensor(
            [h / size, w / size], dtype=torch.float32, device=trainer.device)
    model = model.eval()

    all_dice, all_valid, all_rows, hd_rows, hd_valid_rows = [], [], [], [], []
    t0 = time.perf_counter()
    for idx, row_valid in pipe.padded_indices():
        images_raw, labels_raw, indicators = pipe.gather(idx)
        images, labels = trainer.test_transform(images_raw, labels_raw)
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        # the trainer's own eval step: with exclude_missing the logits of a
        # sample's missing structures are zeroed before the argmax
        preds = trainer._predictions(model(x).to(trainer._metric_dtype),
                                     indicators)
        dice, valid = dice_per_sample_class(preds, labels)
        all_dice.append(dice)
        all_valid.append(valid & row_valid[:, None])
        all_rows.append(row_valid)
        if with_hd95:
            hd, hd_valid = hd95_per_structure_device(
                preds, labels, NUM_CLASSES,
                spacing=spacings[idx] if use_spacing else None,
                spatial_dims=2)
            hd_rows.append(hd)
            hd_valid_rows.append(hd_valid & row_valid[:, None])
    per_class, _ = masked_mean_batch(torch.cat(all_dice), torch.cat(all_valid))
    fetch = [per_class.double(),
             torch.sum(torch.cat(all_rows)).double()[None]]
    if with_hd95:
        hd_mean, hd_n = masked_mean_batch(torch.cat(hd_rows),
                                          torch.cat(hd_valid_rows))
        fetch += [hd_mean.double(), hd_n.double()]
    fetched = torch.cat(fetch).cpu().tolist()  # the one wait for the device
    elapsed = time.perf_counter() - t0
    s = len(STRUCTURES)
    per_class, n_slices = fetched[:s], int(fetched[s])

    result = {
        "mean_dice": sum(per_class) / s,
        "per_structure_dice": dict(zip(STRUCTURES, per_class)),
        "slices_per_sec": n_slices / max(elapsed, 1e-9),
        "num_slices": n_slices,
    }
    if with_hd95:
        # (value, valid) aggregation like the Dice's; None marks a
        # structure with no sample whose prediction and target both exist.
        hd_mean, hd_n = fetched[s + 1:2 * s + 1], fetched[2 * s + 1:]
        result["per_structure_hd95"] = {
            name: (v if n > 0 else None)
            for name, v, n in zip(STRUCTURES, hd_mean, hd_n)
        }
        result["hd95_unit"] = "mm" if use_spacing else "voxel"
    return result


class _Stager:
    """Host arrays to the device ahead of their use. On the card: pinned
    memory and a non_blocking copy on a side stream, which the compute
    stream waits for when it takes the tensors; on the CPU, plain tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def put(self, host: torch.Tensor) -> torch.Tensor:
        if self.stream is None:
            return host
        host = host.pin_memory()
        with torch.cuda.stream(self.stream):
            return host.to(self.device, non_blocking=True)

    def take(self, tensors):
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            for t in tensors:
                t.record_stream(current)
        return tensors


@torch.no_grad()
def sliding_window_throughput(
    model: SegmentationModel,
    config: TrainConfig,
    dataset: PackedDataset3D,
    patch_size: Sequence[int] = (128, 128, 48),
    overlap: float = 0.5,
    batch_size: int = 4,
    reps: int = 3,
    device="cuda",
) -> Dict:
    """Steady-state whole-volume inference throughput on the device: every
    volume is copied once, then `reps` passes of the sliding window
    (windowing, blending and argmax; no metrics) are timed. The result's
    `compiled_programs` counts the distinct window grids (the reference
    compiles one program per grid bucket; nothing is compiled here)."""
    if len(dataset.images) == 0:
        raise ValueError("sliding_window_throughput: empty dataset")
    patch_size = tuple(int(p) for p in patch_size)
    window = config.volumetric_mode == "patch"
    model = model.eval()
    vols = [volume_to_device(img, patch_size, AIR_HU, device)
            for img in dataset.images]
    grids = {tuple(v.shape) for v in vols}

    def one_pass():
        for v in vols:
            out = volume_labels(model, v, patch_size, overlap, batch_size,
                                window)
        return out

    int(one_pass().flatten()[0])  # the first pass, and a wait
    t0 = time.perf_counter()
    for _ in range(reps):
        out = one_pass()
    int(out.flatten()[0])
    elapsed = time.perf_counter() - t0
    n = reps * len(vols)
    return {
        "vols_per_min": n / max(elapsed / 60.0, 1e-9),
        "ms_per_volume": elapsed / n * 1000.0,
        "num_volumes": len(vols),
        "compiled_programs": len(grids),
        "reps": reps,
    }


@torch.no_grad()
def evaluate_3d_sliding_window(
    model: SegmentationModel,
    config: TrainConfig,
    dataset: PackedDataset3D,
    patch_size: Sequence[int] = (128, 128, 48),
    overlap: float = 0.5,
    batch_size: int = 4,
    with_hd95: bool = False,
    device="cuda",
) -> Dict:
    """Whole-volume 3D evaluation of a 3D model (on `device`) by
    sliding-window Gaussian blending.

    Per volume: the soft-tissue window for a patch-mode config, as its
    trainer saw it (a resize-mode config sees raw HU, as in predict), the
    blended logits over the volume's own window grid (an axis shorter
    than the patch padded with air, or 0 without the window, and cut off
    again), with exclude_missing the logits of the structures missing from
    its annotations zeroed before the argmax, then per-structure Dice on
    the whole volume and, with `with_hd95`, HD95: in millimetres when the
    split carries per-volume spacings (z-first (D, H, W), reordered to the
    maps' (H, W, D)), else in voxels (`hd95_unit`).

    Volumes stay in their packed dtype (int16) on the host until the copy;
    the next volume is copied while this one computes. Everything
    accumulates on the device and is fetched once. `compiled_programs` in
    the result is the number of distinct window grids: the reference
    compiles one program per grid bucket, and eager PyTorch compiles none.
    """
    if len(dataset.images) == 0:
        raise ValueError("evaluate_3d_sliding_window: empty dataset")
    patch_size = tuple(int(p) for p in patch_size)
    device = torch.device(device)
    spacings = getattr(dataset, "spacings", None)
    use_spacing = with_hd95 and spacings is not None
    window = config.volumetric_mode == "patch"
    img_fill = AIR_HU if window else 0.0
    model = model.eval()
    indicators = torch.as_tensor(np.stack(dataset.indicators),
                                 dtype=torch.float32, device=device)
    if use_spacing:
        hwd = torch.as_tensor(np.stack(spacings), dtype=torch.float32,
                              device=device)[:, [1, 2, 0]]
    stager = _Stager(device)

    def stage(i):
        return (volume_to_device(dataset.images[i], patch_size, img_fill,
                                 put=stager.put),
                volume_to_device(dataset.labels[i], patch_size, 0,
                                 put=stager.put))

    grids = set()
    dice_rows, valid_rows, hd_rows, hd_valid_rows = [], [], [], []
    t0 = time.perf_counter()
    staged = stage(0)
    for i in range(len(dataset.images)):
        image, label = stager.take(staged)
        if i + 1 < len(dataset.images):
            staged = stage(i + 1)
        grids.add(tuple(image.shape))
        d, h, w = dataset.images[i].shape
        logits = volume_logits(model, image, patch_size, overlap, batch_size,
                               window)
        logits = logits[:h, :w, :d]
        if config.exclude_missing:
            # as the trainer's eval step: a structure missing from this
            # volume's annotations cannot win the argmax
            logits = torch.cat([logits[..., :1],
                                logits[..., 1:] * indicators[i]], dim=-1)
        preds = torch.argmax(logits, dim=-1)
        target = label[:h, :w, :d]
        dice, valid = dice_per_sample_class(preds[None], target[None])
        dice_rows.append(dice)
        valid_rows.append(valid)
        if with_hd95:
            hd, hd_ok = hd95_per_structure_device(
                preds, target, NUM_CLASSES,
                spacing=hwd[i] if use_spacing else None, spatial_dims=3)
            hd_rows.append(hd[None])
            hd_valid_rows.append(hd_ok[None])
    per_class, _ = masked_mean_batch(torch.cat(dice_rows),
                                     torch.cat(valid_rows))
    fetch = [per_class.double()]
    if with_hd95:
        hd_mean, hd_n = masked_mean_batch(torch.cat(hd_rows),
                                          torch.cat(hd_valid_rows))
        fetch += [hd_mean.double(), hd_n.double()]
    fetched = torch.cat(fetch).cpu().tolist()  # the one wait for the device
    elapsed = time.perf_counter() - t0
    s = len(STRUCTURES)
    per_class = fetched[:s]
    result = {
        "mean_dice": sum(per_class) / s,
        "per_structure_dice": dict(zip(STRUCTURES, per_class)),
        "vols_per_min": len(dataset.images) / max(elapsed / 60.0, 1e-9),
        "num_volumes": len(dataset.images),
        "compiled_programs": len(grids),
    }
    if with_hd95:
        hd_mean, hd_n = fetched[s:2 * s], fetched[2 * s:]
        result["per_structure_hd95"] = {
            name: (v if n > 0 else None)
            for name, v, n in zip(STRUCTURES, hd_mean, hd_n)
        }
        result["hd95_unit"] = "mm" if use_spacing else "voxel"
    return result


def format_table(result: Dict) -> str:
    hd_hdr = ""
    if "per_structure_hd95" in result:
        # Always label the unit: a bare HD95 column reads as millimetres,
        # which is wrong for packed data without voxel spacing.
        unit = {"mm": "mm", "voxel": "vox"}.get(
            result.get("hd95_unit", "voxel"), "vox"
        )
        hd_hdr = f" {f'HD95({unit})':>10}"
    lines = [f"{'Structure':<18} {'Dice':>8}" + hd_hdr]
    for s in STRUCTURES:
        row = f"{s:<18} {result['per_structure_dice'][s] * 100:>8.2f}"
        if "per_structure_hd95" in result:
            v = result["per_structure_hd95"][s]
            row += f" {v:>10.2f}" if v is not None else f" {'n/a':>10}"
        lines.append(row)
    lines.append(f"{'Mean':<18} {result['mean_dice'] * 100:>8.2f}")
    return "\n".join(lines)


def main(argv=None):
    parser = ArgumentParser(
        description="Evaluate a checkpoint on a packed split: per-structure "
        "Dice (+HD95). 2D checkpoints run the slice pipeline, 3D ones "
        "whole-volume sliding-window evaluation (from the checkpoint's "
        "config, like predict)."
    )
    parser.add_argument(
        "--checkpoint", default=None,
        help="a port checkpoint or a reference Lightning .ckpt file",
    )
    add_released_args(parser)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--hd95", action="store_true", default=False)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--patch_size", type=int, nargs=3, default=(128, 128, 48),
        help="3D checkpoints: sliding-window patch size")
    parser.add_argument("--overlap", type=float, default=0.5,
                        help="3D checkpoints: sliding-window overlap")
    parser.add_argument(
        "--throughput", action="store_true", default=False,
        help="3D checkpoints: also report the steady-state vols/min with the "
        "volumes on the device (metrics excluded)")
    args = parser.parse_args(argv)

    trainer, state = Trainer.restore(resolve_checkpoint_arg(args),
                                     args.device)
    if trainer.config.spatial_dims == 3:
        data_dir = Path(args.data_dir
                        or (Path(DEFAULT_DATA_STORAGE) / "miccai_3d"))
        dataset = PackedDataset3D.load(data_dir / f"{args.split}_packed.npz")
        patch = tuple(args.patch_size)
        result = evaluate_3d_sliding_window(
            state.model, trainer.config, dataset, patch_size=patch,
            overlap=args.overlap, with_hd95=args.hd95, device=args.device)
        if args.throughput:
            result["throughput"] = sliding_window_throughput(
                state.model, trainer.config, dataset, patch_size=patch,
                overlap=args.overlap, device=args.device)
    else:
        data_dir = Path(args.data_dir
                        or (Path(DEFAULT_DATA_STORAGE) / "miccai_2d"))
        dataset = PackedDataset2D.load(data_dir / f"{args.split}_packed.npz")
        result = evaluate_2d(trainer, state.model, dataset,
                             batch_size=args.batch_size, with_hd95=args.hd95)
    print(format_table(result))
    if "vols_per_min" in result:
        print(f"vols/min (copies included): {result['vols_per_min']:.2f}")
    if "throughput" in result:
        print("vols/min (steady state, volumes on the device): "
              f"{result['throughput']['vols_per_min']:.2f}")
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
