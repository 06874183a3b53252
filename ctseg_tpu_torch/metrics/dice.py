"""Dice metric with the reference's NaN semantics, NaN-free (port of
ctseg_tpu/metrics/dice.py).

Per-(sample, class) Dice carries an explicit (value, valid) pair: `valid` is
False where the ground-truth class is empty (the reference's NaN) and the
value is 0 there. Predictions and targets are integer label maps
(N, *spatial). The per-class pixel counts are exact integer histograms,
equal to the JAX one-hot sums, made with scatter_add (torch.bincount and
boolean indexing would wait for the device).

`batch` (parallel/collectives.py::GlobalBatch) makes both reductions the
global batch's on a mesh: the per-sample counts are summed over the depth
slabs (exact, in int64) and the batch sums over the data ranks, so every
rank gets the global Dice.
"""

from typing import Tuple

import torch

from ctseg_tpu_torch.constants import NUM_CLASSES
from ctseg_tpu_torch.parallel.collectives import LOCAL, GlobalBatch


def _counts(labels: torch.Tensor, n_classes: int, where=None,
            batch: GlobalBatch = LOCAL) -> torch.Tensor:
    """(N, n_classes) float32 count of each class per sample, over the
    pixels where `where` holds (all by default)."""
    n = labels.shape[0]
    idx = labels.reshape(n, -1).long()
    idx = idx + n_classes * torch.arange(n, device=labels.device)[:, None]
    if where is not None:  # the rest go to a spare bin, dropped below
        idx = torch.where(where.reshape(n, -1), idx, n * n_classes)
    idx = idx.reshape(-1)
    counts = torch.zeros(n * n_classes + 1, dtype=torch.int64,
                         device=labels.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    counts = batch.spatial_counts(counts[:-1])
    return counts.reshape(n, n_classes).to(torch.float32)


def dice_per_sample_class(pred_labels, target_labels, n_classes=NUM_CLASSES,
                          include_background=False,
                          batch: GlobalBatch = LOCAL
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dice, valid), both (N, C'), C' = n_classes - 1 without background."""
    target_o = _counts(target_labels, n_classes, batch=batch)
    pred_o = _counts(pred_labels, n_classes, batch=batch)
    intersection = _counts(target_labels, n_classes,
                           where=pred_labels == target_labels, batch=batch)
    if not include_background:
        intersection, target_o, pred_o = (
            intersection[:, 1:], target_o[:, 1:], pred_o[:, 1:]
        )
    valid = target_o > 0
    dice = torch.where(
        valid, (2.0 * intersection) / torch.clamp_min(target_o + pred_o, 1.0),
        0.0,
    )
    return dice, valid


def masked_mean_batch(values, valid, batch: GlobalBatch = LOCAL
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class mean over the batch of the valid entries (0 for a class
    with none): (per_class_mean (C,), not_nans (C,))."""
    not_nans = batch.rows(torch.sum(valid.to(values.dtype), dim=0))
    total = batch.rows(torch.sum(torch.where(valid, values, 0.0), dim=0))
    mean = torch.where(not_nans > 0, total / torch.clamp_min(not_nans, 1.0), 0.0)
    return mean, not_nans


class DiceMetric:
    """Mean + per-structure Dice over a batch of label maps: the per-class
    batch mean ignores empty-GT samples; the mean over classes includes
    zeros for classes absent from the whole batch (reference
    capstone/models/metrics.py:8-31)."""

    def __init__(self, n_classes: int = NUM_CLASSES,
                 include_background: bool = False,
                 batch: GlobalBatch = LOCAL):
        self.n_classes = n_classes
        self.include_background = include_background
        self.batch = batch

    def __call__(self, pred_labels, target_labels):
        dice, valid = dice_per_sample_class(
            pred_labels, target_labels, n_classes=self.n_classes,
            include_background=self.include_background, batch=self.batch,
        )
        per_class, _ = masked_mean_batch(dice, valid, self.batch)
        return torch.mean(per_class), per_class
