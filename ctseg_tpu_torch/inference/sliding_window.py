"""Sliding-window whole-volume inference with Gaussian overlap blending (port
of ctseg_tpu/inference/sliding_window.py).

A volume of any size is covered by a grid of overlapping windows; each
window's logits are weighted by a separable Gaussian importance map and
added into the output, which is then divided by the summed weights
(MONAI-style blending). Works for 2D (H, W) and 3D (H, W, D) volumes with a
trailing channel axis, the reference's layout: `apply_fn` maps patches
(N, *patch, C_in) to logits (N, *patch, C_out).

Each volume runs on its own clamped window grid, and only an axis shorter
than the patch is padded (`pad_volume_dhw`'s fill rule). The reference
rounds depths up to a shared grid bucket (`bucket_axis`, `bucketed_grid`,
`bucketed_swin_runner`) so that scans of different depths share one
compiled XLA program, and states that predictions inside the true extent
equal the per-shape grid's; eager PyTorch compiles nothing per shape, so
the port runs the per-shape grid. Windows go through the model
`batch_size` at a time.
"""

import itertools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ctseg_tpu_torch.constants import NUM_CLASSES, WINDOWING_CONFIG
from ctseg_tpu_torch.models.layers import channels_last
from ctseg_tpu_torch.ops.masks import squash_predictions
from ctseg_tpu_torch.transforms.windowing import apply_window

AIR_HU = -1024.0  # the pad fill of raw HU volumes


def _window_starts(size: int, patch: int, overlap: float) -> list:
    """Start offsets covering [0, size) with at least `overlap` overlap,
    the last window flush with the end."""
    assert patch <= size, f"patch {patch} larger than volume axis {size}"
    if patch == size:
        return [0]
    step = window_step(patch, overlap)
    starts = list(range(0, size - patch + 1, step))
    if starts[-1] != size - patch:
        starts.append(size - patch)
    return starts


def window_step(patch: int, overlap: float) -> int:
    """The stride between window starts along one axis."""
    return max(1, int(patch * (1.0 - overlap)))


def compute_window_grid(spatial_shape: Sequence[int],
                        patch_size: Sequence[int], overlap: float
                        ) -> np.ndarray:
    """(N_windows, ndim) int32 array of window start corners."""
    per_axis = [_window_starts(s, p, overlap)
                for s, p in zip(spatial_shape, patch_size)]
    return np.array(list(itertools.product(*per_axis)), dtype=np.int32)


def gaussian_importance(patch_size: Sequence[int], sigma_scale: float = 0.125,
                        dtype=torch.float32, device=None) -> torch.Tensor:
    """Separable Gaussian importance map, 1.0 at the centre, computed in
    float64 on the host and floored at 1e-6 (so a corner voxel covered by
    one window divides exactly), then cast to `dtype` on `device`."""
    maps = []
    for p in patch_size:
        center = (p - 1) / 2.0
        sigma = max(p * sigma_scale, 1e-3)
        x = np.arange(p, dtype=np.float64)
        g = np.exp(-0.5 * ((x - center) / sigma) ** 2)
        maps.append(g / g.max())
    out = np.ones([], dtype=np.float64)
    for i, g in enumerate(maps):
        shape = [1] * len(patch_size)
        shape[i] = -1
        out = out * g.reshape(shape)
    out = np.maximum(out, 1e-6)
    return torch.as_tensor(out, device=device).to(dtype)


def padded_shape(true_hwd: Sequence[int], patch_size: Sequence[int]
                 ) -> Tuple[int, ...]:
    """The shape a volume runs at: each axis at least the patch."""
    return tuple(max(int(s), int(p)) for s, p in zip(true_hwd, patch_size))


def pad_volume_dhw(arr: np.ndarray, shape_hwd, fill) -> np.ndarray:
    """Host-pad a (D, H, W) array up to the (H, W, D) shape `shape_hwd`.

    The image fill is -1024 HU (air), which the soft-tissue window maps to
    0.0. Where the array's dtype cannot hold the fill (uint8/uint16 scans),
    the padded array is float32: np.full would wrap -1024 to 64512, which
    windows to tissue (1.0) instead of air."""
    hb, wb, db = shape_hwd
    d, h, w = arr.shape
    if (h, w, d) == (hb, wb, db):
        return arr
    dtype = arr.dtype
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        if not info.min <= fill <= info.max:
            dtype = np.float32
    out = np.full((db, hb, wb), fill, dtype=dtype)
    out[:d, :h, :w] = arr
    return out


def volume_to_device(arr: np.ndarray, patch_size: Sequence[int], fill,
                     device=None, put: Optional[Callable] = None
                     ) -> torch.Tensor:
    """A host (D, H, W) array as the (H, W, D) tensor of its run shape
    (`padded_shape`): padded on the host with `fill` (`pad_volume_dhw`),
    kept in its dtype, and copied by `put` (host tensor -> device tensor;
    default a plain copy to `device`)."""
    d, h, w = arr.shape
    shape = padded_shape((h, w, d), patch_size)
    host = torch.from_numpy(np.ascontiguousarray(
        pad_volume_dhw(arr, shape, fill)))
    return (put(host) if put is not None else host.to(device)).movedim(0, -1)


def blend_accumulate(volume: torch.Tensor, apply_fn: Callable,
                     starts: np.ndarray, patch_size: Tuple[int, ...],
                     importance: torch.Tensor, out_channels: int,
                     batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the windows at `starts` through `apply_fn`, `batch_size` at a
    time, and return (acc (*spatial, out_channels), weight (*spatial, 1)),
    float32: each window's logits times the importance added into `acc` in
    window order, the importance into `weight`."""
    ndim = len(patch_size)
    spatial = tuple(volume.shape[:ndim])
    acc = torch.zeros(spatial + (out_channels,), dtype=torch.float32,
                      device=volume.device)
    weight = torch.zeros(spatial + (1,), dtype=torch.float32,
                         device=volume.device)
    importance_c = importance[..., None]
    windows = [tuple(slice(int(s), int(s) + p) for s, p in zip(st, patch_size))
               for st in starts]
    for lo in range(0, len(windows), batch_size):
        batch = windows[lo:lo + batch_size]
        patches = torch.stack([volume[w] for w in batch])
        weighted = apply_fn(patches).to(torch.float32) * importance_c
        for i, w in enumerate(batch):
            acc[w] += weighted[i]
            weight[w] += importance_c
    return acc, weight


def build_sliding_window_fn(apply_fn: Callable, spatial_shape: Sequence[int],
                            patch_size: Sequence[int], overlap: float = 0.5,
                            batch_size: int = 4, mode: str = "gaussian",
                            out_channels: int = NUM_CLASSES, device=None
                            ) -> Callable:
    """A runner for volumes of `spatial_shape`: volume (*spatial, C_in) ->
    blended logits (*spatial, out_channels), float32."""
    patch_size = tuple(int(p) for p in patch_size)
    starts = compute_window_grid(spatial_shape, patch_size, overlap)
    if mode == "gaussian":
        importance = gaussian_importance(patch_size, device=device)
    else:
        importance = torch.ones(patch_size, dtype=torch.float32,
                                device=device)

    def run(volume: torch.Tensor) -> torch.Tensor:
        acc, weight = blend_accumulate(
            volume, apply_fn, starts, patch_size, importance.to(volume.device),
            out_channels, batch_size)
        return acc / torch.clamp_min(weight, 1e-30)

    return run


def sliding_window_inference(volume: torch.Tensor, apply_fn: Callable,
                             patch_size: Sequence[int], overlap: float = 0.5,
                             batch_size: int = 4, mode: str = "gaussian",
                             out_channels: Optional[int] = None
                             ) -> torch.Tensor:
    """Blend `apply_fn`'s logits over the window grid covering `volume`
    (*spatial, C_in); returns (*spatial, C_out) float32."""
    patch_size = tuple(int(p) for p in patch_size)
    ndim = len(patch_size)
    if volume.ndim != ndim + 1:
        raise ValueError(f"volume must be (*spatial, C) for a {ndim}D patch, "
                         f"got shape {tuple(volume.shape)}")
    if out_channels is None:
        probe = volume[tuple(slice(0, p) for p in patch_size)][None]
        out_channels = apply_fn(probe).shape[-1]
    run = build_sliding_window_fn(apply_fn, volume.shape[:ndim], patch_size,
                                  overlap, batch_size, mode, out_channels,
                                  volume.device)
    return run(volume)


def model_apply_fn(model: torch.nn.Module) -> Callable:
    """apply_fn of a channel-first model: patches (N, *patch, C) -> logits
    (N, *patch, classes), views of channels_last memory on both sides."""
    def apply(patches: torch.Tensor) -> torch.Tensor:
        return model(channels_last(patches.movedim(-1, 1))).movedim(1, -1)

    return apply


def volume_logits(model: torch.nn.Module, image_hwd: torch.Tensor,
                  patch_size: Sequence[int], overlap: float, batch_size: int,
                  window: bool) -> torch.Tensor:
    """Blended logits (H, W, D, classes) of one raw-HU volume (H, W, D) on
    the model's device, at least the patch along every axis: the
    soft-tissue window (patch-mode checkpoints) or raw HU (resize mode),
    then the sliding window over the volume's own grid."""
    vol = image_hwd.to(torch.float32)[..., None]
    if window:
        vol = apply_window(vol, *WINDOWING_CONFIG["soft_tissue"])
    run = build_sliding_window_fn(model_apply_fn(model), vol.shape[:3],
                                  patch_size, overlap, batch_size,
                                  device=vol.device)
    with torch.inference_mode():
        return run(vol)


def volume_labels(model: torch.nn.Module, image_hwd: torch.Tensor,
                  patch_size: Sequence[int], overlap: float, batch_size: int,
                  window: bool) -> torch.Tensor:
    """`volume_logits`'s argmax: the (H, W, D) label map."""
    return squash_predictions(volume_logits(
        model, image_hwd, patch_size, overlap, batch_size, window))
