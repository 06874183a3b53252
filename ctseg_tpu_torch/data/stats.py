"""Dataset statistics: reproducible derivations of the published constants
(a copy of ctseg_tpu/data/stats.py: the port never imports the JAX package;
tests/test_torch_data_prep.py pins the code of the two copies equal,
docstrings aside).

The reference derives several load-bearing constants in notebooks and bakes
the resulting numbers into its source; this module turns each derivation
into a tested function + CLI so they can be recomputed from any dataset
(SURVEY.md L7: notebooks -> constants). Formula citations:

  - class_weights:        capstone/notebooks/sample_dataset_2d.ipynb cell 3
                          (published at capstone/models/losses.py:10-21)
  - annotation_counts:    sample_dataset_2d.ipynb cell 4
                          (published at capstone/training/utils.py:10)
  - stacked_window_stats: miccai_batch_exploration.ipynb cells 10-12
                          (published at capstone/transforms/predefined.py:5)
  - crop_envelope:        miccai_batch_exploration.ipynb cell 3
                          (published at capstone/utils/miccai.py:195-197)

Everything is host-side numpy: these run offline over a dataset once, not
on the training hot path.

CLI:
  python -m ctseg_tpu_torch.data.stats [--data_dir .../miccai_2d] [--raw_dir
      .../miccai/train] [--split train]
prints each derived statistic next to the published constant it reproduces.
"""

import json
from argparse import ArgumentParser
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ctseg_tpu_torch.constants import (
    ANNOTATION_COUNT,
    CLASS_WEIGHT,
    CROP_BOUNDARY_X,
    CROP_BOUNDARY_Y,
    CROP_BOUNDARY_Z,
    NUM_CLASSES,
    STACKED_WINDOW_MEAN,
    STACKED_WINDOW_STD,
    STRUCTURES,
    WINDOW_ORDER,
    WINDOWING_CONFIG,
)


def class_pixel_counts(labels: np.ndarray) -> np.ndarray:
    """Per-class pixel counts over squashed label maps (N, H, W) -> (10,)."""
    return np.bincount(
        np.asarray(labels).ravel().astype(np.int64), minlength=NUM_CLASSES
    )


def class_weights(labels: np.ndarray) -> Dict[str, float]:
    """Inverse pixel-frequency class weights, the reference derivation
    (sample_dataset_2d.ipynb cell 3): w_c = foreground_total / count_c,
    normalized to sum to 1 over the 9 structures; Background is pinned to
    the reference's 1e-10 (capstone/models/losses.py:11)."""
    counts = class_pixel_counts(labels)
    foreground = counts[1:].sum()
    # Deviation from the notebook (documented): the notebook divides raw
    # counts — valid because every class is present in PDDCA's train split.
    # A class ABSENT from an arbitrary split is excluded from the
    # normalization (weight 0.0, with a warning) instead of producing
    # inf/nan or — the earlier clamp-to-1 behavior — a weight orders of
    # magnitude above every present class that crushed the rest to ~0.
    present = counts[1:] > 0
    if not present.all():
        import warnings

        missing = [s for s, p in zip(STRUCTURES, present) if not p]
        warnings.warn(
            f"class_weights: no pixels for {missing}; these classes get "
            "weight 0 and are excluded from the normalization",
            stacklevel=2,
        )
    w = np.where(present, foreground / np.maximum(counts[1:], 1), 0.0)
    w = w / max(w.sum(), 1e-30)
    out = {"Background": 1e-10}
    out.update({s: float(v) for s, v in zip(STRUCTURES, w)})
    return out


def annotation_counts(labels: np.ndarray) -> np.ndarray:
    """Per-structure count of slices containing that class, the reference
    derivation (sample_dataset_2d.ipynb cell 4: masks.sum(H,W) > 0 summed
    over the split). labels: squashed (N, H, W) -> (9,) int64.

    Derived from the squashed label map, so a structure fully occluded by a
    higher-id overlap would not count — never observed in PDDCA (same
    caveat as the mixup presence derivation, PARITY.md deviations)."""
    labels = np.asarray(labels)
    out = np.zeros(len(STRUCTURES), np.int64)
    for c in range(1, NUM_CLASSES):
        out[c - 1] = int((labels == c).any(axis=(1, 2)).sum())
    return out


def _window_clip_shift(x: np.ndarray, width: int, level: int) -> np.ndarray:
    """The reference's apply_window math (transforms_2d.py:97-107) in
    numpy: clip to [level - width//2, level + width//2], shift to [0, 1]
    by the FIXED window bounds (not the data's clipped min/max) —
    differential-tested against ctseg_tpu_torch.transforms.windowing.apply_window
    in tests/test_stats.py."""
    lo, hi = level - width // 2, level + width // 2
    clipped = np.clip(x, lo, hi)
    return (clipped - lo) / (hi - lo + 1e-8)


def stacked_window_stats(
    images: np.ndarray,
    per_item: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mean/std of each stacked window channel over raw-HU images (N, ...).

    per_item=True uses the reference's POOLING formula
    (miccai_batch_exploration.ipynb cells 10-12): mean = sum of windowed
    values / total voxels, std = sqrt(sum of per-item var * N_item / total
    voxels) — a within-item pooled std that ignores the spread of per-item
    means exactly like the notebook. per_item=False is the exact global
    std (the statistically complete version). Two documented population
    differences from the notebook when run over a packed 2D split: the
    notebook pools per cropped PATIENT VOLUME (here: per item = per slice),
    and packed splits drop structure-free slices
    (capstone/data/process_miccai.py:86 does too — for training data, not
    for these stats). Returns (mean (3,), std (3,)) like WINDOW_ORDER.
    """
    images = np.asarray(images, np.float64)
    if images.size == 0:
        raise ValueError("stacked_window_stats: empty image array")
    n_total = images.size
    means, stds = [], []
    for wname in WINDOW_ORDER:
        width, level = WINDOWING_CONFIG[wname]
        s = s2 = v = 0.0
        for img in images:
            w = _window_clip_shift(img, width, level)
            s += w.sum()
            s2 += (w * w).sum()
            v += w.var() * w.size
        mean = s / n_total
        if per_item:
            std = np.sqrt(v / n_total)
        else:
            std = np.sqrt(max(s2 / n_total - mean * mean, 0.0))
        means.append(mean)
        stds.append(std)
    return np.asarray(means), np.asarray(stds)


def crop_envelope(raw_dir) -> Dict[str, Tuple]:
    """Structure-extent envelope over raw patient dirs, the derivation
    behind the published crop box (miccai_batch_exploration.ipynb cell 3):
    per patient, the min/max index of any structure voxel along each axis;
    the envelope is the min of mins / max of maxes over patients. Axis
    convention matches the reference crop (and CropBox.apply,
    utils/miccai.py): on a (D, H, W) volume, "x" slices the H axis, "y"
    slices the W axis (notebook cell 3: indicator_along_x = max(axis=(0,2))
    reduces D and W, leaving H), and "z" is the D index as a fraction of
    the slide count. The published box (capstone/utils/miccai.py:195-197)
    is this envelope hand-widened to a round safety margin."""
    from ctseg_tpu_torch.utils.miccai import PatientCollection

    mins = {ax: [] for ax in "xyz"}
    maxs = {ax: [] for ax in "xyz"}

    def extents(patient):
        lo = {ax: [] for ax in "xyz"}
        hi = {ax: [] for ax in "xyz"}
        for name in patient.present_structures():
            m = patient.structures[name].as_numpy()[0]  # (D, H, W)
            d = m.max(axis=(1, 2)).nonzero()[0]  # D extent -> "z"
            h = m.max(axis=(0, 2)).nonzero()[0]  # H extent -> "x"
            w = m.max(axis=(0, 1)).nonzero()[0]  # W extent -> "y"
            if len(d) == 0:
                continue
            lo["z"].append(d.min() / m.shape[0])
            hi["z"].append(d.max() / m.shape[0])
            lo["x"].append(h.min())
            hi["x"].append(h.max())
            lo["y"].append(w.min())
            hi["y"].append(w.max())
        return (
            {ax: min(v) for ax, v in lo.items() if v},
            {ax: max(v) for ax, v in hi.items() if v},
        )

    for _, (lo, hi) in PatientCollection(raw_dir).apply_function(extents).items():
        for ax in "xyz":
            if ax in lo:
                mins[ax].append(lo[ax])
                maxs[ax].append(hi[ax])
    return {
        ax: (min(mins[ax]), max(maxs[ax])) for ax in "xyz" if mins[ax]
    }


def derive_all(
    dataset, raw_dir: Optional[str] = None, per_item: bool = True
) -> Dict:
    """Every derivation over one packed 2D split (+ optional raw dir),
    formatted next to the published constants for comparison."""
    mean, std = stacked_window_stats(dataset.images, per_item=per_item)
    report = {
        "class_weights": {
            "derived": class_weights(dataset.labels),
            "published": dict(CLASS_WEIGHT),
        },
        "annotation_counts": {
            "derived": {
                s: int(v)
                for s, v in zip(STRUCTURES, annotation_counts(dataset.labels))
            },
            "published": dict(zip(STRUCTURES, ANNOTATION_COUNT)),
        },
        "stacked_window_stats": {
            "derived": {
                "mean": [round(float(v), 4) for v in mean],
                "std": [round(float(v), 4) for v in std],
            },
            "published": {
                "mean": list(STACKED_WINDOW_MEAN),
                "std": list(STACKED_WINDOW_STD),
            },
        },
    }
    if raw_dir:
        report["crop_envelope"] = {
            "derived": {
                ax: (
                    [round(float(a), 3), round(float(b), 3)]
                    if ax == "z"
                    else [int(a), int(b)]
                )
                for ax, (a, b) in crop_envelope(raw_dir).items()
            },
            "published": {
                "x": list(CROP_BOUNDARY_X),
                "y": list(CROP_BOUNDARY_Y),
                "z": list(CROP_BOUNDARY_Z),
            },
        }
    return report


def main(argv=None):
    from ctseg_tpu_torch.data.datasets import PackedDataset2D
    from ctseg_tpu_torch.paths import DEFAULT_DATA_STORAGE

    parser = ArgumentParser(
        description="Recompute the published dataset constants"
    )
    parser.add_argument("--data_dir", type=str, default=None,
                        help="dir holding <split>_packed.npz (miccai_2d)")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument(
        "--raw_dir", type=str, default=None,
        help="raw patient split dir (for the crop envelope); optional",
    )
    parser.add_argument(
        "--global_std", action="store_true",
        help="exact global std instead of the notebook's within-item pooling",
    )
    args = parser.parse_args(argv)
    data_dir = Path(args.data_dir or (Path(DEFAULT_DATA_STORAGE) / "miccai_2d"))
    dataset = PackedDataset2D.load(data_dir / f"{args.split}_packed.npz")
    report = derive_all(
        dataset, raw_dir=args.raw_dir, per_item=not args.global_std
    )
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
