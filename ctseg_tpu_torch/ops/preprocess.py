"""The degree-2 train transform of the images: the hand-written CUDA kernel
(K4) and its plain version.

Port of ctseg_tpu/ops/pallas/preprocess.py::fused_window_normalize (three HU
windows + per-channel normalize) with the crop, rot90 and flip of
transforms/pipelines.py::_degree_2 folded in: those moves only relocate
pixels, so one pass maps (N, H, W) raw HU and the per-sample draws to the
(N, S, S, 3) float32 batch. The output is contiguous, so its
`permute(0, 3, 1, 2)` is a channels_last NCHW model input with no copy.

  - On a CPU tensor it runs `window_normalize_degree2_plain`: windowing,
    transforms/augment.apply_degree2, normalize (the reference's order).
  - On a CUDA tensor it launches csrc/preprocess.cu, or raises.

Both use the same float32 window and normalization constants and true
divisions, so on the card the kernel equals the plain version bit for bit.
With identity draws (no offset, no turn, no flip, S = H = W) it is
fused_window_normalize.
"""

import functools

import torch

from ctseg_tpu_torch.constants import (
    STACKED_WINDOW_MEAN,
    STACKED_WINDOW_STD,
    WINDOW_ORDER,
    WINDOWING_CONFIG,
)
from ctseg_tpu_torch.ops import _build
from ctseg_tpu_torch.transforms.augment import Degree2Draws, apply_degree2
from ctseg_tpu_torch.transforms.windowing import normalize, windowed_channels


@functools.lru_cache(maxsize=None)
def _params(device: torch.device) -> torch.Tensor:
    """(3, 5) float32: lo, hi, den, mean, std per window, rounded from the
    same Python numbers as transforms/windowing.py rounds them. Kept per
    device: a copy to the card per call would wait for the stream."""
    rows = []
    for i, name in enumerate(WINDOW_ORDER):
        width, level = WINDOWING_CONFIG[name]
        lo, hi = level - width // 2, level + width // 2
        rows.append((lo, hi, hi - lo + 1e-8, STACKED_WINDOW_MEAN[i],
                     STACKED_WINDOW_STD[i]))
    return torch.tensor(rows, dtype=torch.float32, device=device)


def identity_draws(n: int, device=None) -> Degree2Draws:
    """No offset, no turn, no flip: K4 is then fused_window_normalize."""
    z = torch.zeros((n,), dtype=torch.int32, device=device)
    return Degree2Draws(z, z, z, z)


def window_normalize_degree2_plain(images, draws: Degree2Draws, size: int):
    """Plain PyTorch version: windows, crop/rot90/flip, normalize; laid out
    like the kernel's output."""
    out = normalize(apply_degree2(windowed_channels(images), draws, size))
    return out.contiguous()


def window_normalize_degree2(images: torch.Tensor, draws: Degree2Draws,
                             size: int) -> torch.Tensor:
    """(N, H, W) raw HU + draws -> (N, size, size, 3) float32."""
    if images.ndim != 3:
        raise ValueError(f"want (N, H, W) slices, got {tuple(images.shape)}")
    n, h, w = images.shape
    if h < size or w < size:
        raise ValueError(f"cannot crop ({h}, {w}) slices to {size}")
    for name, t in zip(draws._fields, draws):
        if tuple(t.shape) != (n,):
            raise ValueError(f"want {name} ({n},), got {tuple(t.shape)}")
    if images.device.type == "cpu":
        return window_normalize_degree2_plain(images, draws, size)
    if images.device.type != "cuda":
        raise ValueError(f"no kernel for device {images.device}")
    if images.dtype != torch.float32 or not images.is_contiguous():
        raise TypeError(
            f"kernel wants contiguous float32 slices, got {images.dtype} with "
            f"strides {tuple(images.stride())}"
        )
    for name, t in zip(draws._fields, draws):
        if t.dtype != torch.int32 or t.device != images.device \
                or not t.is_contiguous():
            raise TypeError(
                f"kernel wants {name} contiguous int32 on {images.device}, "
                f"got {t.dtype} on {t.device}"
            )
    if n == 0 or n > 65535 or n * size * size * 3 >= 2**31 \
            or images.numel() >= 2**31:
        raise ValueError(f"kernel does not take {n} slices to {size}")

    lib = _build.library()
    out = torch.empty((n, size, size, 3), dtype=torch.float32,
                      device=images.device)
    params = _params(images.device)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = lib.ctseg_window_normalize(
        images.data_ptr(), draws.top.data_ptr(), draws.left.data_ptr(),
        draws.k.data_ptr(), draws.flip.data_ptr(), params.data_ptr(),
        out.data_ptr(), n, h, w, size, images.device.index, stream,
    )
    lib.check(err, "window_normalize_degree2")
    window_normalize_degree2.launches += 1
    return out


window_normalize_degree2.launches = 0  # K4 launches since the last reset
