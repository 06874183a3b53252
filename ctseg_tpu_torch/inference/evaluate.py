"""Evaluation: per-structure Dice and HD95 reports from a 2D checkpoint (port
of ctseg_tpu/inference/evaluate.py's slice path).

Covers the reference's `trainer.test(...)` path (base_trainer.py:246) and
adds HD95. The result prints as a table and is written as JSON.

    python -m ctseg_tpu_torch.inference.evaluate --checkpoint CKPT \\
        [--data_dir DIR] [--split test] [--hd95] [--out results.json]

Whole-volume sliding-window evaluation of 3D checkpoints waits for the
port's 3D slice (ROADMAP.md, modules to port: 3D).
"""

import json
import time
from argparse import ArgumentParser
from pathlib import Path
from typing import Dict, Optional

import torch

from ctseg_tpu_torch.constants import NUM_CLASSES, STRUCTURES
from ctseg_tpu_torch.data.datasets import PackedDataset2D
from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
from ctseg_tpu_torch.metrics.dice import dice_per_sample_class, masked_mean_batch
from ctseg_tpu_torch.metrics.hd95 import hd95_per_structure_device
from ctseg_tpu_torch.models.unet import SegmentationModel
from ctseg_tpu_torch.paths import DEFAULT_DATA_STORAGE
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
        description="Evaluate a 2D checkpoint on a packed split: "
        "per-structure Dice (+HD95)."
    )
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="a port checkpoint or a reference Lightning "
                        ".ckpt file")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--hd95", action="store_true", default=False)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    # A 3D checkpoint raises here, naming the ROADMAP's 3D item.
    trainer, state = Trainer.restore(args.checkpoint, args.device)
    data_dir = Path(args.data_dir or (Path(DEFAULT_DATA_STORAGE) / "miccai_2d"))
    dataset = PackedDataset2D.load(data_dir / f"{args.split}_packed.npz")
    result = evaluate_2d(trainer, state.model, dataset,
                         batch_size=args.batch_size, with_hd95=args.hd95)
    print(format_table(result))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
