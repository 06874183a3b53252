"""Exact Euclidean distance transform on the device (port of
ctseg_tpu/ops/edt.py).

The squared EDT is separable: exact 1D step counts along the last axis,
then one min-plus pass (ops/min_plus.py, K5 on the card) per remaining
axis. The order of operations is the JAX function's, so the result is equal
to it bit for bit: step counts with BIG where a row has no site, times the
last axis's spacing, squared and clamped at BIG, then the passes with each
axis's spacing as the scale.

The JAX functions take one map and are vmapped by their callers. Here the
batch is written out: leading dims are batch dims, the last `spatial_dims`
dims are the map, and every map of the batch goes through one kernel launch
per pass. The maps are data, not differentiable.
"""

from typing import Optional

import torch

from ctseg_tpu_torch.constants import NUM_CLASSES
from ctseg_tpu_torch.ops.min_plus import BIG, min_plus


def _scan_distance_1d(sites: torch.Tensor) -> torch.Tensor:
    """Distance in steps to the nearest True along the last axis, float32;
    BIG where a row has none. The reference scans a carry that starts at
    BIG (BIG + 1 rounds back to BIG in float32); the running maximum of the
    sites' indices gives the same integers."""
    w = sites.shape[-1]
    pos = torch.arange(w, dtype=torch.int32, device=sites.device)

    def one_way(s):
        last = torch.cummax(torch.where(s, pos, -1), dim=-1).values
        return torch.where(last >= 0, (pos - last).to(torch.float32), BIG)

    forward = one_way(sites)
    backward = one_way(sites.flip(-1)).flip(-1)
    return torch.minimum(forward, backward)


def edt_squared(mask: torch.Tensor, spacing=None,
                spatial_dims: Optional[int] = None) -> torch.Tensor:
    """Exact squared Euclidean distance to the nearest zero of `mask`.

    scipy.ndimage.distance_transform_edt(mask, sampling=spacing)**2 for each
    map: 0 on the zeros of the input, BIG for an all-ones map. `mask` is
    (*batch, *spatial); `spatial_dims` counts the map's dims (default: all
    of them, or the length of `spacing`). `spacing` is the voxel size per
    spatial axis: a sequence or a tensor (..., spatial_dims) whose leading
    dims broadcast against the batch dims, so every map may have its own.
    At unit spacing (None) the values are integer-valued floats.
    """
    if spacing is not None:
        spacing = torch.as_tensor(spacing, dtype=torch.float32,
                                  device=mask.device)
        nd = spacing.shape[-1]
        if spatial_dims not in (None, nd):
            raise ValueError(f"spacing of {nd} axes for {spatial_dims}D maps")
    else:
        nd = mask.ndim if spatial_dims is None else spatial_dims
    if not 1 <= nd <= mask.ndim:
        raise ValueError(f"{nd} spatial dims in a mask {tuple(mask.shape)}")
    batch = mask.shape[:mask.ndim - nd]
    n_maps = batch.numel()
    if spacing is not None:
        spacing = spacing.expand(*batch, nd).reshape(n_maps, nd)

    g = _scan_distance_1d(torch.logical_not(mask.bool()))
    if spacing is not None:
        g = g * spacing[:, -1].reshape(*batch, *(1,) * nd)
    d2 = torch.clamp_max(g * g, BIG)
    for ax in range(nd - 1):
        p = len(batch) + ax
        k = d2.shape[p]
        before = d2.shape[len(batch):p].numel()  # spatial dims ahead of ax
        if spacing is None:
            scale = torch.ones(n_maps * before, dtype=torch.float32,
                               device=d2.device)
        else:
            scale = spacing[:, ax].repeat_interleave(before).contiguous()
        d2 = min_plus(d2.reshape(n_maps * before, k, -1), scale).reshape(
            d2.shape)
    return d2


def edt(mask: torch.Tensor, spacing=None,
        spatial_dims: Optional[int] = None) -> torch.Tensor:
    """Euclidean distance from each voxel to the nearest zero of `mask`
    (scipy.ndimage.distance_transform_edt semantics, `spacing` its
    `sampling=`); batched like `edt_squared`."""
    return torch.sqrt(edt_squared(mask, spacing, spatial_dims))


def signed_distance_map(mask: torch.Tensor,
                        spatial_dims: Optional[int] = None) -> torch.Tensor:
    """Signed EDT of binary masks with the reference's convention:
    dist(~mask) * ~mask - (dist(mask) - 1) * mask, all divided by 255
    (capstone/data/utils.py:10-26); an empty mask gives zeros. `mask` is
    (*batch, *spatial); both transforms of every map share one launch."""
    pos = mask.bool()
    neg = torch.logical_not(pos)
    nd = mask.ndim if spatial_dims is None else spatial_dims
    d_out, d_in = edt(torch.stack([neg, pos]), spatial_dims=nd)
    result = d_out * neg - (d_in - 1.0) * pos
    nonempty = torch.any(pos.flatten(mask.ndim - nd), dim=-1)
    nonempty = nonempty.reshape(*nonempty.shape, *(1,) * nd)
    # A true division on the card too: by a Python scalar torch's CUDA
    # kernel multiplies by the reciprocal, one rounding more.
    return torch.where(nonempty, result, 0.0) / torch.full(
        (), 255.0, device=mask.device)


@torch.no_grad()
def signed_distance_maps_from_labels(labels: torch.Tensor,
                                     n_classes: int = NUM_CLASSES
                                     ) -> torch.Tensor:
    """(N, *spatial) label map -> (N, n_classes - 1, *spatial) signed
    distance maps, background excluded: channel-first, like the logits the
    Boundary loss multiplies them with."""
    classes = torch.arange(1, n_classes, device=labels.device)
    shape = (1, n_classes - 1) + (1,) * (labels.ndim - 1)
    masks = labels[:, None] == classes.reshape(shape)
    return signed_distance_map(masks, spatial_dims=labels.ndim - 1)
