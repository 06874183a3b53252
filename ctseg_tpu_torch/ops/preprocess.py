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

Both use the same float32 window and normalization constants and
correctly rounded divisions (the kernel's from reciprocals, `div_rn_model`),
so on the card the kernel equals the plain version bit for bit. With
identity draws (no offset, no turn, no flip, S = H = W) it is
fused_window_normalize.

The kernel takes one (sample, TILE x TILE output tile) a block: the tile's
sources are one square of the crop (`tile_origin`), loaded once into shared
memory and read there at each pixel's mapped place.
`window_normalize_tiles_model` is that walk in plain PyTorch, for the CPU
tests.
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

TILE = 32  # the kernel's output tile side (csrc/preprocess.cu's kTile)


@functools.lru_cache(maxsize=None)
def _params(device: torch.device) -> torch.Tensor:
    """(3, 7) float32: lo, hi, den, mean, std per window, rounded from the
    same Python numbers as transforms/windowing.py rounds them, then the
    correctly rounded reciprocals of den and std (float32 true divisions),
    from which the kernel makes its quotients (`div_rn_model`). Kept per
    device: a copy to the card per call would wait for the stream."""
    rows = []
    for i, name in enumerate(WINDOW_ORDER):
        width, level = WINDOWING_CONFIG[name]
        lo, hi = level - width // 2, level + width // 2
        rows.append((lo, hi, hi - lo + 1e-8, STACKED_WINDOW_MEAN[i],
                     STACKED_WINDOW_STD[i]))
    p = torch.tensor(rows, dtype=torch.float32)
    lo, hi, den, mean, std = p.T.tolist()
    # What div_rn_model's exactness rests on: every numerator of the two
    # divisions is 0, NaN or in [2^-64, 2^64] unless the value itself is
    # below 2^-64 (the kernel takes IEEE divisions there), and no quotient
    # leaves the normal range. Two distinct float32 values, one of them at
    # least 2^-40 in magnitude, differ by at least 2^-64 (the ulp at 2^-41),
    # so v - lo (lo not 0) and shifted - mean are 0 or at least 2^-64;
    # hi - lo, den, std and |mean| within 2^30 keep shifted below 2^60 and
    # shifted - mean below 2^64, and every quotient within [2^-94, 2^94].
    if not (all(x == 0 or abs(x) >= 2.0 ** -40 for x in lo)
            and all(2.0 ** -40 <= abs(x) <= 2.0 ** 30 for x in mean)
            and all(2.0 ** -30 <= x <= 2.0 ** 30 for x in den + std)
            and all(b - a <= 2.0 ** 30 for a, b in zip(lo, hi))):
        raise ValueError(f"K4 cannot divide exactly by {rows}")
    one = torch.ones(len(rows), dtype=torch.float32)
    p = torch.cat([p, (one / p[:, 2])[:, None], (one / p[:, 4])[:, None]], 1)
    return p.to(device)


def identity_draws(n: int, device=None) -> Degree2Draws:
    """No offset, no turn, no flip: K4 is then fused_window_normalize."""
    z = torch.zeros((n,), dtype=torch.int32, device=device)
    return Degree2Draws(z, z, z, z)


def window_normalize_degree2_plain(images, draws: Degree2Draws, size: int):
    """Plain PyTorch version: windows, crop/rot90/flip, normalize; laid out
    like the kernel's output."""
    out = normalize(apply_degree2(windowed_channels(images), draws, size))
    return out.contiguous()


def source_pixel(k: int, flip: bool, i, j, size: int):
    """(r, c): the pixel of the crop that output pixel (i, j) reads after
    rot90 by k and the flip (np.rot90's index map)."""
    j1 = size - 1 - j if flip else j
    return {0: (i, j1), 1: (j1, size - 1 - i), 2: (size - 1 - i, size - 1 - j1),
            3: (size - 1 - j1, i)}[k & 3]


def tile_origin(k: int, flip: bool, i0: int, j0: int, size: int, tile: int):
    """(r0, c0): the top-left corner of the tile x tile square of the crop
    that the output tile at (i0, j0) reads. The map is affine in (i, j), so
    the square's corner is the source of one of the tile's corners."""
    jlo = size - j0 - tile if flip else j0  # the tile's smallest j1
    return {0: (i0, jlo), 1: (jlo, size - i0 - tile),
            2: (size - i0 - tile, size - jlo - tile),
            3: (size - jlo - tile, i0)}[k & 3]


def _fma_model(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """float32 a * b + c rounded once, as a fused multiply-add: the product
    is exact in float64, the sum and its error by TwoSum, rounded to odd in
    float64 and then to nearest in float32 (53 >= 24 + 2 bits: one
    rounding's result)."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inf = torch.tensor(float("inf"), dtype=torch.float64)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.float()


def div_rn_model(a: torch.Tensor, b: torch.Tensor, y: torch.Tensor):
    """The kernel's a / b (csrc/preprocess.cu::div_rn) from y = RN(1 / b):
    q = RN(a y), then twice q + RN(a - b q) y with fused multiply-adds.
    Equal to a / b where a is 0, NaN or of a magnitude in [2^-64, 2^64]."""
    q = a * y
    for _ in range(2):
        q = _fma_model(_fma_model(-q, b, a), y, q)
    return q


def window_normalize_tiles_model(images: torch.Tensor, draws: Degree2Draws,
                                 size: int) -> torch.Tensor:
    """The kernel's walk in plain PyTorch, block by block as
    csrc/preprocess.cu takes it: per (sample, TILE x TILE output tile) the
    square at `tile_origin` loaded into a (TILE, TILE + 1) buffer (zeros
    where it leaves the crop or the slice), each output pixel read from the
    buffer at its `source_pixel` less the origin, the three windows, the
    tile's rows staged as 3 * TILE floats and copied into place; NaN where
    the source leaves the slice. The divisions are the kernel's
    (`div_rn_model`; IEEE divisions for a value nonzero and below 2^-64)."""
    n, h, w = images.shape
    tile = TILE
    lo, hi, den, mean, std, rden, rstd = _params(images.device).T[
        :, None, None, :]
    out = torch.empty((n, size, size, 3), dtype=torch.float32)
    a = torch.arange(tile)
    rr, cc = a[:, None], a[None, :]
    for m in range(n):
        k, flip = int(draws.k[m]), bool(draws.flip[m])
        ty, tx = int(draws.top[m]), int(draws.left[m])
        for i0 in range(0, size, tile):
            for j0 in range(0, size, tile):
                r0, c0 = tile_origin(k, flip, i0, j0, size, tile)
                r, c = r0 + rr, c0 + cc
                y, x = ty + r, tx + c
                inside = ((r >= 0) & (r < size) & (c >= 0) & (c < size)
                          & (y >= 0) & (y < h) & (x >= 0) & (x < w))
                square = torch.zeros((tile, tile + 1), dtype=torch.float32)
                square[:, :tile] = torch.where(
                    inside, images[m, y.clamp(0, h - 1), x.clamp(0, w - 1)],
                    0.0)
                r, c = source_pixel(k, flip, i0 + rr, j0 + cc, size)
                v = square[r - r0, c - c0][..., None]
                clipped = torch.where(v < lo, lo, torch.where(v > hi, hi, v))
                vals = div_rn_model(
                    div_rn_model(clipped - lo, den, rden) - mean, std, rstd)
                tiny = (v.abs() < 2.0 ** -64) & (v != 0)  # IEEE divisions
                vals = torch.where(tiny, ((clipped - lo) / den - mean) / std,
                                   vals)
                outside = (ty + r < 0) | (ty + r >= h) | (tx + c < 0) \
                    | (tx + c >= w)
                vals[outside] = float("nan")
                stage = vals.reshape(tile, 3 * tile)
                rows, cols = min(tile, size - i0), min(tile, size - j0)
                out[m, i0:i0 + rows, j0:j0 + cols] = stage[
                    :rows, :3 * cols].reshape(rows, cols, 3)
    return out


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
