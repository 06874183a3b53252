"""The separable squared-EDT min-plus pass: the hand-written CUDA kernel (K5)
and its plain version.

Port of ctseg_tpu/ops/pallas/min_plus.py::min_plus_2d, with the batch
written out (the JAX callers vmap over maps) and one scale per map:

    out[b, i, l] = min(BIG, min_k ((scale[b] * (i - k))**2 + x[b, k, l]))

for x (B, K, L) float32 and scale (B,) float32. A pass along any axis but
the last of an N-D map is a reshape to (prod(before), K, prod(after)).

  - On a CPU tensor it runs `min_plus_plain`, the all-pairs form of
    ctseg_tpu/ops/edt.py::_min_plus.
  - On a CUDA tensor it launches csrc/min_plus.cu, or raises.

Both round each pair's value three times (the product scale * (i - k), its
square, the sum with x) and reduce with `min`, so they are equal bit for
bit, and equal to the JAX kernel and its jnp form. The kernel leaves out
pairs that cannot lower the minimum (rows at BIG, rows beyond the distance
at which the cost alone reaches the accumulator, output rows that are 0);
`min_plus_pruned_model` is a plain PyTorch model of that search, which tests
hold bit-equal to the all-pairs form; nothing on a main path calls it. Not
differentiable: the transform's inputs are label masks, and the maps it
makes are data.
"""

import torch

from ctseg_tpu_torch.ops import _build

BIG = 1e12  # float32(1e12) = 999999995904: no row, or no site in the map
MAX_K = 1752  # rows of one (K, 32) tile, with its cost table, in a block's shared memory
TILE = 32  # columns a block of the kernel takes
ROWS = 8  # output rows a warp holds, and rows of x it meets a step
# Elements of the plain version's (b, i, K, L) intermediate per chunk.
_PLAIN_CHUNK = 1 << 26


def min_plus_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. The product, the square and the sum are
    separate tensor operations, so none is contracted into a multiply-add;
    chunked over maps and output rows to bound the (i, k, l) intermediate."""
    b, k, l = x.shape
    i = torch.arange(k, dtype=x.dtype, device=x.device)
    delta = i[:, None] - i[None, :]  # (i, k), exact
    out = torch.empty_like(x)
    maps = max(1, _PLAIN_CHUNK // (k * k * l))
    rows = max(1, min(k, _PLAIN_CHUNK // (maps * k * l)))
    for b0 in range(0, b, maps):
        xb = x[b0:b0 + maps]
        sb = scale[b0:b0 + maps].to(x.dtype)[:, None, None]
        for i0 in range(0, k, rows):
            d = sb * delta[i0:i0 + rows]  # (maps, rows, K)
            cost = d * d
            out[b0:b0 + maps, i0:i0 + rows] = torch.amin(
                cost[:, :, :, None] + xb[:, None, :, :], dim=2
            )
    return torch.clamp_max(out, BIG)


def min_plus_pruned_model(x: torch.Tensor, scale: torch.Tensor):
    """The kernel's pruned search in plain PyTorch, tile by tile and group
    by group as csrc/min_plus.cu walks them: (out, pairs evaluated). Per
    (map, TILE columns): the rows [first, last] that hold a value below BIG
    and the smallest value xmin; per group of ROWS output rows: 0 where the
    rows are 0 in every column and xmin >= 0, else blocks of ROWS rows
    outward from the group, until fl(cost[d] + xmin), d the nearest distance
    of the next step, is no less than the group's largest accumulator."""
    b, k, l = x.shape
    kp = -(-k // ROWS) * ROWS
    big = torch.tensor(BIG, dtype=x.dtype)
    xp = torch.full((b, kp, l), BIG, dtype=x.dtype)
    xp[:, :k] = x
    out = torch.empty((b, kp, l), dtype=x.dtype)
    pairs = 0
    idx = torch.arange(kp + ROWS, dtype=x.dtype)
    rows = torch.arange(ROWS)

    def meet(acc, cost, tile, i0, kb):
        d = (i0 + rows[:, None] - kb - rows[None, :]).abs()  # (r, j)
        v = cost[d][:, :, None] + tile[kb:kb + ROWS][None, :, :]
        return torch.minimum(acc, v.amin(dim=1)), ROWS * ROWS * tile.shape[1]

    for m in range(b):
        sd = scale[m].to(x.dtype) * idx
        cost = sd * sd
        for l0 in range(0, l, TILE):
            tile = xp[m, :, l0:l0 + TILE]
            below = (tile < big).any(dim=1).nonzero()
            if below.numel() == 0:
                out[m, :, l0:l0 + TILE] = big
                continue
            fb, lb = int(below[0]) // ROWS, int(below[-1]) // ROWS
            xmin = tile[tile < big].min()
            for i0 in range(0, kp, ROWS):
                ib = i0 // ROWS
                acc = torch.full((ROWS, tile.shape[1]), BIG, dtype=x.dtype)
                if xmin >= 0 and bool((tile[i0:i0 + ROWS] == 0).all()):
                    out[m, i0:i0 + ROWS, l0:l0 + TILE] = 0
                    continue
                t = max(0, fb - ib, ib - lb)
                if t == 0:
                    acc, n = meet(acc, cost, tile, i0, i0)
                    pairs += n
                    t = 1
                while True:
                    down, up = ib - t, ib + t
                    if down < fb and up > lb:
                        break
                    dmin = ROWS * t - (ROWS - 1)
                    if cost[dmin] + xmin >= acc.max():
                        break
                    for blk in (down, up):
                        if fb <= blk <= lb:
                            acc, n = meet(acc, cost, tile, i0, blk * ROWS)
                            pairs += n
                    t += 1
                out[m, i0:i0 + ROWS, l0:l0 + TILE] = acc
    return out[:, :k].contiguous(), pairs


def min_plus(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(B, K, L) float32 maps, (B,) float32 scales -> (B, K, L)."""
    if x.ndim != 3:
        raise ValueError(f"want (B, K, L) maps, got {tuple(x.shape)}")
    b, k, l = x.shape
    if tuple(scale.shape) != (b,):
        raise ValueError(f"want scale ({b},), got {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"scale on {scale.device}, maps on {x.device}")
    if x.numel() == 0:
        return torch.empty_like(x)
    if x.device.type == "cpu":
        return min_plus_plain(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    for name, t in (("maps", x), ("scale", scale)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(
                f"kernel wants contiguous float32 {name}, got {t.dtype} with "
                f"strides {tuple(t.stride())}"
            )
    tiles = -(-l // TILE)
    if k > MAX_K or b * tiles >= 2**31:
        raise ValueError(
            f"kernel does not take {b} maps of ({k}, {l}): at most {MAX_K} "
            f"rows and 2**31 - 1 (map, {TILE}-column tile) blocks"
        )

    lib = _build.library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ctseg_min_plus(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                             b, k, l, x.device.index, stream)
    lib.check(err, "min_plus")
    min_plus.launches += 1
    return out


min_plus.launches = 0  # K5 launches since the last reset
