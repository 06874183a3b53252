"""Segmentation losses in plain torch (port of ctseg_tpu/losses/segmentation.py).

Same numerical contracts as the JAX functions, on channel-first logits
(N, C, *spatial) and integer labels (N, *spatial):
  - Dice: MONAI v0.3 DiceLoss(include_background=False, to_onehot_y=True,
    softmax=True): per-(sample, class) 1 - (2*I + s)/(U + s), s = 1e-5.
  - GeneralizedDice: square weighting w = 1/ground_o^2 with the per-sample
    inf -> max(w) fixup, smooth_nr = smooth_dr = 1e-5.
  - Focal: MONAI FocalLoss(gamma=2) with a one-hot target: per-(sample,
    class) mean over voxels of -(1-p)^gamma * t * log p.
  - CrossEntropy / WeightedCrossEntropy: F.cross_entropy semantics (the
    weighted mean divides by the summed weight of the targets).
  - Missing-annotation masking (AnatomyNet), `apply_missing_mask`.
Every reduction honours `sample_mask` (N,) (padded evaluation rows count
for nothing). Boundary multiplies the probabilities with signed distance
maps (ops/edt.py, on the min-plus kernel K5), channel-first like the logits.

Every function takes `batch`, a parallel/collectives.py::GlobalBatch: on a
mesh a rank holds some rows (and, depth-sharded, a slab of each volume) of
the global batch, and its loss is its additive share of the global batch's
loss (parallel/distributed.py). Normalisers taken from the data (class
counts, n_valid, summed weights and masks) are summed over the ranks;
those that follow from shapes (rows, voxels) are the local ones times the
ranks; a per-sample spatial sum that enters non-linearly (Dice's) is summed
over the depth slabs with its gradient, and the per-sample result, then
equal on every slab, counts 1/n_space on each. The default, `LOCAL`, is
the single-process batch, where all of this is the identity.
"""

import functools
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ctseg_tpu_torch.constants import CLASS_WEIGHT, NUM_CLASSES
from ctseg_tpu_torch.parallel.collectives import LOCAL, GlobalBatch


def _spatial_dims(x: torch.Tensor):
    """All dims except batch (0) and channel (1)."""
    return tuple(range(2, x.ndim))


def _one_hot(labels: torch.Tensor, n_classes: int, dtype) -> torch.Tensor:
    """(N, *spatial) -> (N, C, *spatial)."""
    oh = F.one_hot(labels.long(), n_classes).to(dtype)
    return oh.movedim(-1, 1)


def _reduce_matrix(f: torch.Tensor, reduction: str,
                   sample_mask: Optional[torch.Tensor],
                   batch: GlobalBatch = LOCAL) -> torch.Tensor:
    """Reduce a per-(sample, class) matrix, honouring sample_mask."""
    if reduction == "none":
        return f
    if sample_mask is not None:
        m = sample_mask.to(f.dtype)[:, None]
        s = torch.sum(f * m)
        if reduction == "sum":
            return s
        if reduction == "mean":
            return s / torch.clamp_min(
                batch.rows(torch.sum(m)) * f.shape[-1], 1.0)
    elif reduction == "mean":
        if batch.n_data == 1:
            return torch.mean(f)
        return torch.sum(f) / (f.numel() * batch.n_data)
    elif reduction == "sum":
        return torch.sum(f)
    raise ValueError(f"unknown reduction {reduction!r}")


def _spatial_share(f: torch.Tensor, batch: GlobalBatch) -> torch.Tensor:
    """A per-sample matrix that every depth slab computed from the summed
    spatial sums: each slab's share."""
    return f if batch.n_space == 1 else f / batch.n_space


def cross_entropy_loss(logits, labels, weight=None, reduction="mean",
                       sample_mask=None, batch: GlobalBatch = LOCAL):
    """Softmax cross entropy over the class dim; torch's weighted mean
    sum(w_y * ce) / sum(w_y) with `weight` (C,)."""
    logp = F.log_softmax(logits, dim=1)
    onehot = _one_hot(labels, logits.shape[1], logp.dtype)
    ce = -torch.sum(onehot * logp, dim=1)  # (N, *spatial)
    w = None
    if weight is not None:
        w = torch.as_tensor(weight, dtype=ce.dtype, device=ce.device)[labels.long()]
    if reduction == "none":
        return ce * w if w is not None else ce
    if reduction not in ("mean", "sum"):
        raise ValueError(f"unknown reduction {reduction!r}")
    m = None
    if sample_mask is not None:
        m = sample_mask.to(ce.dtype).reshape((-1,) + (1,) * (ce.ndim - 1))
        m = m.expand(ce.shape)
    wm = w if m is None else (w * m if w is not None else m)
    num = torch.sum(ce * wm) if wm is not None else torch.sum(ce)
    if reduction == "sum":
        return num
    if wm is not None:
        denom = torch.clamp_min(batch.voxels(torch.sum(wm)), 1e-30)
    else:
        denom = float(ce.numel() * batch.n_data * batch.n_space)
    return num / denom


def weighted_cross_entropy_loss(logits, labels, reduction="mean",
                                sample_mask=None, batch: GlobalBatch = LOCAL):
    """Cross entropy with the reference's inverse-pixel-frequency weights."""
    return cross_entropy_loss(
        logits, labels, weight=list(CLASS_WEIGHT.values()),
        reduction=reduction, sample_mask=sample_mask, batch=batch,
    )


def dice_loss(logits, labels, include_background=False, smooth=1e-5,
              reduction="mean", sample_mask=None, batch: GlobalBatch = LOCAL):
    """Soft Dice on softmax probabilities vs one-hot targets; "none" gives
    the (N, C') matrix, C' without background unless include_background."""
    probs = F.softmax(logits, dim=1)
    target = _one_hot(labels, logits.shape[1], probs.dtype)
    dims = _spatial_dims(target)
    intersection = batch.spatial(torch.sum(target * probs, dim=dims))  # (N, C)
    target_o = batch.spatial(torch.sum(target, dim=dims))
    pred_o = batch.spatial(torch.sum(probs, dim=dims))
    if not include_background:
        intersection, target_o, pred_o = (
            intersection[:, 1:], target_o[:, 1:], pred_o[:, 1:]
        )
    f = 1.0 - (2.0 * intersection + smooth) / (target_o + pred_o + smooth)
    return _reduce_matrix(_spatial_share(f, batch), reduction, sample_mask,
                          batch)


def generalized_dice_loss(logits, labels, include_background=False,
                          smooth_nr=1e-5, smooth_dr=1e-5, reduction="mean",
                          sample_mask=None, batch: GlobalBatch = LOCAL):
    """Generalized Dice (Sudre 2017), square class weighting; classes absent
    from a sample get that sample's largest finite weight."""
    probs = F.softmax(logits, dim=1)
    target = _one_hot(labels, logits.shape[1], probs.dtype)
    dims = _spatial_dims(target)
    intersection = batch.spatial(torch.sum(target * probs, dim=dims))
    ground_o = batch.spatial(torch.sum(target, dim=dims))
    pred_o = batch.spatial(torch.sum(probs, dim=dims))
    if not include_background:
        intersection, ground_o, pred_o = (
            intersection[:, 1:], ground_o[:, 1:], pred_o[:, 1:]
        )
    denominator = ground_o + pred_o
    w = 1.0 / (ground_o * ground_o)  # inf where the class is absent
    finite = torch.isfinite(w)
    w_max = torch.amax(torch.where(finite, w, 0.0), dim=1, keepdim=True)
    w = torch.where(finite, w, w_max)
    f = 1.0 - (2.0 * (intersection * w) + smooth_nr) / (
        (denominator * w) + smooth_dr
    )
    return _reduce_matrix(_spatial_share(f, batch), reduction, sample_mask,
                          batch)


def focal_loss(logits, labels, gamma=2.0, reduction="mean", sample_mask=None,
               batch: GlobalBatch = LOCAL):
    """Focal loss against a one-hot target (background included); "none"
    gives (N, C), the per-class voxel mean of -(1 - p)^gamma * t * log p."""
    n_classes = logits.shape[1]
    logp = F.log_softmax(logits, dim=1)
    target = _one_hot(labels, n_classes, logp.dtype)
    logp_y = torch.sum(target * logp, dim=1)  # (N, *spatial)
    per_voxel = -torch.pow(1.0 - torch.exp(logp_y), gamma) * logp_y
    if reduction == "mean" and sample_mask is None:
        # Each voxel contributes to exactly one class.
        return torch.sum(per_voxel) / (
            per_voxel.numel() * batch.n_data * batch.n_space * n_classes)
    # the slab's voxels' share of the per-(sample, class) mean
    f = torch.mean(target * per_voxel[:, None], dim=_spatial_dims(target))
    return _reduce_matrix(_spatial_share(f, batch), reduction, sample_mask,
                          batch)


def boundary_loss(logits, dist_maps, reduction="mean", sample_mask=None,
                  batch: GlobalBatch = LOCAL):
    """Boundary loss: softmax probabilities (background dropped) times the
    signed distance maps (N, C-1, *spatial); "none" gives the spatial mean
    per (sample, class), (N, C-1)."""
    probs = F.softmax(logits, dim=1)[:, 1:]
    prod = probs * dist_maps.to(probs.dtype)
    f = torch.mean(prod, dim=_spatial_dims(prod))
    return _reduce_matrix(_spatial_share(f, batch), reduction, sample_mask,
                          batch)


def apply_missing_mask(name: str, loss: torch.Tensor,
                       mask_indicator: torch.Tensor,
                       sample_mask: Optional[torch.Tensor] = None,
                       batch: GlobalBatch = LOCAL):
    """AnatomyNet missing-annotation masking of an (N, C) loss matrix.

    mask_indicator (N, S) is 1/0 per structure; Focal gets a background
    column, present iff all structures are. Classes are weighted by
    1/annotation-count-in-batch (all ones when any class is absent from the
    batch), normalised to sum 1; the masked weighted loss is summed over
    classes and averaged over the batch.
    """
    mask_indicator = mask_indicator.to(loss.dtype)
    if sample_mask is not None:
        mask_indicator = mask_indicator * sample_mask.to(loss.dtype)[:, None]
    if name == "Focal":
        background = (
            torch.sum(mask_indicator, dim=1, keepdim=True) == (NUM_CLASSES - 1)
        ).to(loss.dtype)
        mask_indicator = torch.cat([background, mask_indicator], dim=1)
    counts = batch.rows(torch.sum(mask_indicator, dim=0))  # (C,)
    weights = 1.0 / counts
    any_inf = torch.any(torch.isinf(weights))
    weights = torch.where(any_inf, torch.ones_like(weights), weights)
    weights = weights / torch.sum(weights)
    masked = loss * weights[None, :] * mask_indicator
    if sample_mask is not None:
        n_valid = torch.clamp_min(
            batch.rows(torch.sum(sample_mask.to(loss.dtype))), 1.0)
        return torch.sum(masked) / n_valid
    if batch.n_data == 1:
        return torch.mean(torch.sum(masked, dim=1))
    return torch.sum(masked) / (masked.shape[0] * batch.n_data)


LOSSES = {
    "CrossEntropy": cross_entropy_loss,
    "WeightedCrossEntropy": weighted_cross_entropy_loss,
    "Focal": focal_loss,
    "Dice": dice_loss,
    "GeneralizedDice": generalized_dice_loss,
    "Boundary": boundary_loss,
}

# Losses that never get the missing-annotation mask.
_CE_LOSSES = frozenset({"CrossEntropy", "WeightedCrossEntropy"})


class MultiLoss:
    """Named losses summed into the training loss, with optional
    missing-annotation masking (the reference's MultipleLossWrapper)."""

    def __init__(self, losses: Sequence[str], exclude_missing: bool = False,
                 batch: GlobalBatch = LOCAL):
        unknown = [n for n in losses if n not in LOSSES]
        if unknown:
            raise ValueError(f"unknown loss: {unknown}")
        self.names = sorted(losses)  # the reference's order
        self.exclude_missing = exclude_missing
        self.batch = batch

    def __call__(self, logits, labels, mask_indicator=None, dist_maps=None,
                 sample_mask=None) -> Dict[str, torch.Tensor]:
        values: Dict[str, torch.Tensor] = {}
        for name in self.names:
            fx = LOSSES[name]
            # CE losses reduce to their (weighted) mean even under
            # exclude_missing (reference capstone/models/losses.py:196-199).
            masked = self.exclude_missing and name not in _CE_LOSSES
            reduction = "none" if masked else "mean"
            kw = {} if masked else {"sample_mask": sample_mask}
            if name == "Boundary" and dist_maps is None:
                raise ValueError("the Boundary loss needs distance maps")
            target = dist_maps if name == "Boundary" else labels
            loss = fx(logits, target, reduction=reduction, batch=self.batch,
                      **kw)
            if masked:
                if mask_indicator is None:
                    raise ValueError("exclude_missing needs mask indicators")
                loss = apply_missing_mask(name, loss, mask_indicator,
                                          sample_mask=sample_mask,
                                          batch=self.batch)
            values[name] = loss
        return values

    def total(self, values: Dict[str, torch.Tensor]) -> torch.Tensor:
        return functools.reduce(torch.add, values.values())
