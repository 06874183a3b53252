"""Depth-sharded sliding-window inference with halo exchanges (port of
ctseg_tpu/inference/spatial_sharded.py).

The volume's leading spatial axis is cut into one slab a rank; each rank
blends only the windows that start in its own slab, and the two boundary
regions are reconciled point to point between depth neighbours
(parallel/collectives.py::exchange_halo, `batch_isend_irecv`):

  1. forward halo: each rank receives the first (patch - step) rows of its
     right neighbour's slab, so that windows starting near its slab's end
     can be evaluated locally; the last rank repeats its own last row (the
     edge padding);
  2. backward halo: the logits and weights a rank accumulated in its halo
     rows (the right neighbour's) are sent right and added into that
     neighbour's slab; rank 0 receives nothing (the wrap-around the JAX
     ppermute sends it belongs to padded rows and is dropped there).

This shards both the compute and the volume: the window-parallel mode of
sliding_window.py keeps the volume whole on every rank. The depth is
edge-padded to n * local_d, local_d a multiple of the window step and at
least the patch's depth.
"""

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ctseg_tpu_torch.inference.sliding_window import (
    blend_accumulate,
    compute_window_grid,
    gaussian_importance,
    sliding_window_inference,
)
from ctseg_tpu_torch.parallel.collectives import all_gather_grad, exchange_halo


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _axis(mesh, axis: str):
    """(group, global ranks in order, this rank's index) of a mesh axis."""
    if axis == "space":
        return mesh.space, mesh.space_ranks, mesh.space_index
    if axis != "data" or mesh.n_space != 1:
        raise ValueError(f"shard depth over 'space', or over 'data' of a 1-D "
                         f"mesh; got {axis!r} on {mesh.shape}")
    return mesh.data, tuple(range(mesh.size)), mesh.data_index


def slab_depth(depth: int, patch_depth: int, n: int, overlap: float) -> int:
    """local_d: rows a rank holds, a multiple of the step, at least the
    patch's depth."""
    step = max(1, int(patch_depth * (1.0 - overlap)))
    return _ceil_to(max(math.ceil(depth / n), patch_depth), step)


def build_spatial_sliding_window_fn(
    apply_fn: Callable,
    volume_shape: Sequence[int],
    patch_size: Sequence[int],
    mesh,
    axis: str = "data",
    overlap: float = 0.5,
    batch_size: int = 4,
    out_channels: Optional[int] = None,
) -> Callable:
    """A runner for this rank's slab: slab (local_d, *rest, C) of the
    edge-padded volume of `volume_shape` (*spatial, C), rank-ordered along
    depth over the mesh's `axis` -> the slab's blended logits (local_d,
    *rest, out_channels), float32. `slab_depth` gives local_d."""
    patch_size = tuple(int(p) for p in patch_size)
    volume_shape = tuple(int(s) for s in volume_shape)
    ndim = len(patch_size)
    if len(volume_shape) != ndim + 1:
        raise ValueError("volume must be (*spatial, C)")
    if out_channels is None:
        raise ValueError("out_channels is required by the builder")
    _, ranks, index = _axis(mesh, axis)
    n = len(ranks)
    if n < 2:
        raise ValueError("use build_sliding_window_fn on one rank")
    pd = patch_size[0]
    step = max(1, int(pd * (1.0 - overlap)))
    local_d = slab_depth(volume_shape[0], pd, n, overlap)
    halo = pd - step
    if halo >= local_d:
        raise ValueError("patch depth too large for this mesh size")
    # The local grid, the same on every rank: depth starts are the multiples
    # of the step inside the slab; the other axes take the flush-end grid.
    rest = compute_window_grid(volume_shape[1:ndim], patch_size[1:], overlap)
    starts = np.array([(d0, *r) for d0 in range(0, local_d, step)
                       for r in rest], dtype=np.int64)

    def run(slab: torch.Tensor) -> torch.Tensor:
        if slab.shape[0] != local_d:
            raise ValueError(f"a slab of {slab.shape[0]} rows, want {local_d}")
        importance = gaussian_importance(patch_size, device=slab.device)
        ext = slab
        if halo > 0:
            _, right = exchange_halo(slab[:0], slab[:halo], ranks, index)
            if index == n - 1:  # edge rows past the volume's end
                right = slab[-1:].expand((halo,) + tuple(slab.shape[1:]))
            ext = torch.cat([slab, right], dim=0)
        acc, weight = blend_accumulate(ext, apply_fn, starts, patch_size,
                                       importance, out_channels, batch_size)
        both = torch.cat([acc, weight], dim=-1)
        out = both[:local_d]
        if halo > 0:
            # the overflow rows go right; rank 0 gets none (zeros)
            from_left, _ = exchange_halo(both[local_d:], both[:0], ranks,
                                         index)
            out = out.clone()
            out[:halo] += from_left
        return out[..., :-1] / torch.clamp_min(out[..., -1:], 1e-30)

    return run


def sliding_window_inference_spatial(
    volume: torch.Tensor,
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    patch_size: Sequence[int],
    mesh,
    axis: str = "data",
    overlap: float = 0.5,
    batch_size: int = 4,
    out_channels: Optional[int] = None,
) -> torch.Tensor:
    """Depth-sharded blended inference of `volume` (D, *rest, C), which
    every rank passes: each rank blends its slab, and the slabs are
    gathered, so every rank returns the whole (D, *rest, C_out) float32.
    One rank on the axis: the unsharded sliding_window_inference."""
    patch_size = tuple(int(p) for p in patch_size)
    ndim = len(patch_size)
    if volume.ndim != ndim + 1:
        raise ValueError("volume must be (*spatial, C)")
    group, ranks, index = _axis(mesh, axis)
    n = len(ranks)
    if n == 1:
        return sliding_window_inference(volume, apply_fn, patch_size, overlap,
                                        batch_size, out_channels=out_channels)
    if out_channels is None:
        probe = volume[tuple(slice(0, p) for p in patch_size)][None]
        out_channels = apply_fn(probe).shape[-1]
    d = volume.shape[0]
    local_d = slab_depth(d, patch_size[0], n, overlap)
    # Edge padding: windows near the true end see repeated rows, not zeros.
    pad = volume[-1:].expand((local_d * n - d,) + tuple(volume.shape[1:]))
    padded = torch.cat([volume, pad], dim=0)
    run = build_spatial_sliding_window_fn(
        apply_fn, volume.shape, patch_size, mesh, axis=axis, overlap=overlap,
        batch_size=batch_size, out_channels=out_channels)
    out = run(padded[index * local_d:(index + 1) * local_d])
    return all_gather_grad(out, group, 0)[:d]
