"""95th-percentile Hausdorff distance: device and host (scipy) paths (port of
ctseg_tpu/metrics/hd95.py).

HD95 = max over the two directions of the 95th percentile of
surface-to-surface distances, from the EDT of each mask's boundary.

  - `hd95_per_structure_device`: torch, batched over samples and classes.
    Surfaces by erosion with the cross structuring element, distances by the
    exact separable squared EDT (ops/edt.py, on the min-plus kernel K5 on
    the card) with optional per-sample anisotropic `spacing`, percentiles
    with numpy's linear interpolation over an exact masked order statistic
    (a sort of the surface's distances; the reference searches by counting
    instead, to the same values).
  - `hd95` / `hd95_per_structure`: the numpy/scipy host path, the oracle
    (scipy's `sampling=` is the anisotropic ground truth). These three
    functions are a copy of the JAX package's, pinned equal by
    tests/test_torch_port_imports.py.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.ndimage import binary_erosion, distance_transform_edt

from ctseg_tpu_torch.ops.edt import edt_squared


def _surface(mask: np.ndarray) -> np.ndarray:
    """Boundary voxels: mask minus its erosion."""
    if not mask.any():
        return mask
    eroded = binary_erosion(mask, border_value=0)
    return mask & ~eroded


def hd95(
    pred: np.ndarray,
    target: np.ndarray,
    spacing: Optional[Sequence[float]] = None,
    percentile: float = 95.0,
) -> float:
    """HD95 between two binary masks. Returns nan if either mask is empty."""
    pred = np.asarray(pred).astype(bool)
    target = np.asarray(target).astype(bool)
    if not pred.any() or not target.any():
        return float("nan")

    pred_surface = _surface(pred)
    target_surface = _surface(target)

    # Distance from every voxel to the nearest surface voxel of the other set.
    dist_to_target = distance_transform_edt(~target_surface, sampling=spacing)
    dist_to_pred = distance_transform_edt(~pred_surface, sampling=spacing)

    d_pred_to_target = dist_to_target[pred_surface]
    d_target_to_pred = dist_to_pred[target_surface]
    return float(
        max(
            np.percentile(d_pred_to_target, percentile),
            np.percentile(d_target_to_pred, percentile),
        )
    )


def hd95_per_structure(
    pred_labels: np.ndarray,
    target_labels: np.ndarray,
    n_classes: int = 10,
    spacing: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Per-class HD95 of integer label maps (background class 0 excluded).

    Returns (n_classes - 1,) with nan where either mask is empty — callers
    aggregate with nan-aware reductions like the Dice metric does.
    """
    out = np.full(n_classes - 1, np.nan)
    for c in range(1, n_classes):
        out[c - 1] = hd95(pred_labels == c, target_labels == c, spacing=spacing)
    return out


# --------------------------------------------------------------------- device


def _surface_device(mask: torch.Tensor, spatial_dims: int) -> torch.Tensor:
    """Boundary voxels of (*batch, *spatial) bool masks: mask minus its
    erosion, as scipy.ndimage.binary_erosion's default cross (connectivity
    1) with border_value=0: a voxel survives erosion iff it and all its
    2 * ndim face neighbours are set (outside counts as unset)."""
    eroded = mask.clone()
    for ax in range(mask.ndim - spatial_dims, mask.ndim):
        n = mask.shape[ax]
        eroded.narrow(ax, 0, n - 1).logical_and_(mask.narrow(ax, 1, n - 1))
        eroded.narrow(ax, 1, n - 1).logical_and_(mask.narrow(ax, 0, n - 1))
        eroded.select(ax, 0).zero_()
        eroded.select(ax, n - 1).zero_()
    return mask & torch.logical_not(eroded)


def _masked_percentile_sqrt(d2: torch.Tensor, mask: torch.Tensor,
                            percentile: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of (R, V): the `percentile`-th percentile (numpy's linear
    interpolation) of sqrt(d2) over the entries where `mask` is set.
    Returns (value (R,), n_masked (R,)); a row with no entry has no value
    (NaN)."""
    n = torch.sum(mask, dim=1)
    last = torch.clamp_min(n - 1, 0)
    pos = (percentile / 100.0) * last.to(torch.float32)
    lo_idx = torch.floor(pos).long()
    frac = pos - lo_idx.to(torch.float32)
    hi_idx = torch.minimum(lo_idx + 1, last)
    # The masked values first, in order; the rest sort behind them.
    ordered = torch.sort(torch.where(mask, d2, torch.inf), dim=1).values
    v_lo = torch.sqrt(torch.gather(ordered, 1, lo_idx[:, None])[:, 0])
    v_hi = torch.sqrt(torch.gather(ordered, 1, hi_idx[:, None])[:, 0])
    return v_lo + frac * (v_hi - v_lo), n


@torch.no_grad()
def hd95_per_structure_device(
    pred_labels: torch.Tensor,
    target_labels: torch.Tensor,
    n_classes: int = 10,
    percentile: float = 95.0,
    spacing: Optional[torch.Tensor] = None,
    spatial_dims: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class HD95 of integer label maps, entirely on their device.

    pred_labels/target_labels: (*batch, *spatial) label maps, 2D or 3D;
    `spatial_dims` counts the map's dims (default: all of them, or the
    length of `spacing`). `spacing` is the voxel size per spatial axis,
    (spatial_dims,) or (*batch, spatial_dims) for one per sample. With
    spacing, HD95 is in the spacing's unit (mm for PDDCA headers); without,
    in voxels. Returns ((*batch, n_classes - 1) float32 values, the same
    shape bool valid), with valid False (and value 0) where either mask is
    empty: the repo's (value, valid) convention, where the scipy path has
    NaN. Matches `hd95_per_structure` (`sampling=spacing`) to float
    tolerance either way.
    """
    if spacing is not None:
        spacing = torch.as_tensor(spacing, dtype=torch.float32,
                                  device=pred_labels.device)
        nd = spacing.shape[-1]
    else:
        nd = pred_labels.ndim if spatial_dims is None else spatial_dims
    batch = pred_labels.shape[:pred_labels.ndim - nd]
    classes = torch.arange(1, n_classes, device=pred_labels.device)
    classes = classes.reshape((n_classes - 1,) + (1,) * nd)
    # (*batch, C-1, *spatial) masks, then their surfaces
    ps = _surface_device(pred_labels.unsqueeze(-nd - 1) == classes, nd)
    ts = _surface_device(target_labels.unsqueeze(-nd - 1) == classes, nd)
    if spacing is not None:
        # one spacing per sample, shared by its classes
        spacing = spacing.expand(*batch, nd).unsqueeze(-2)
    # distance_transform_edt(~surface): the distance to the nearest surface
    # voxel of the other mask, read at this mask's surface voxels. Both
    # directions of every (sample, class) share one launch per pass.
    d2_to_t, d2_to_p = edt_squared(
        torch.logical_not(torch.stack([ts, ps])), spacing, nd)
    rows = batch.numel() * (n_classes - 1)
    a, na = _masked_percentile_sqrt(d2_to_t.reshape(rows, -1),
                                    ps.reshape(rows, -1), percentile)
    b, nb = _masked_percentile_sqrt(d2_to_p.reshape(rows, -1),
                                    ts.reshape(rows, -1), percentile)
    ok = (na > 0) & (nb > 0)
    value = torch.where(ok, torch.maximum(a, b), 0.0)
    return (value.reshape(*batch, n_classes - 1),
            ok.reshape(*batch, n_classes - 1))
