"""InstanceNorm + PReLU: the hand-written CUDA kernels and their plain versions.

Port of ctseg_tpu/ops/pallas/instance_norm.py::fused_instance_norm_prelu,
forward (K1) and backward (K1b, its `_bwd_rule`). `instance_norm_prelu(x,
alpha)` takes x as (N, *spatial, C), the JAX layout, which is the NHWC view
`t.permute(0, 2, 3, 1)` of a channels_last activation, with no copy.

  - On a CPU tensor it runs the plain PyTorch versions.
  - On a CUDA tensor it launches csrc/instance_norm.cu, or raises: it never
    falls back to the plain version and never copies its input.

Statistics are the one-pass form of the Pallas kernel and of
models/layers.py::instance_norm_prelu: E[x] and E[x^2] in float32 (float64
for float64 input), var = E[x^2] - E[x]^2 clamped at 0, eps 1e-5.

When autograd needs it (grad enabled and x or alpha requiring grad), the
call goes through an autograd.Function: the forward also writes the
per-(sample, channel) mean and var (the residuals of the Pallas `_fwd_rule`)
and saves them with x; the backward (`instance_norm_prelu_bwd`) recomputes
xhat from them. Otherwise (serving, under inference_mode or no_grad) the
forward writes y only, through the custom op `ctseg::instance_norm_prelu`
(ops/custom_ops.py) on every device, so an exported program keeps the
kernel.

Both kernels on the card split the spatial axis over blocks, in one of two
forms chosen from the shape. `fwd_cluster_plan`, `bwd_cluster_plan`: a
thread block cluster holds a sample's tile in shared memory, so x (and g)
are read once. `fwd_plan`, `bwd_plan`, everywhere else: a sample is cut
into vectors of 16 bytes, "super-rows" of lcm(C, V) elements and spatial
chunks; phase 1 writes per-chunk partial sums to a workspace, a small
kernel adds them in index order into the statistics per (sample, channel),
phase 2 writes the output. The plans are pure functions that mirror
csrc/instance_norm.cu's geometry. `instance_norm_prelu_fwd_chunked` and
`instance_norm_prelu_bwd_chunked` are plain PyTorch models of the chunked
arithmetic (either form: a cluster's blocks are 8 or 16 chunks); tests hold
them to the plain versions, nothing on a main path calls them.
"""

import math

import torch

from ctseg_tpu_torch.ops import _build
from ctseg_tpu_torch.ops import custom_ops  # noqa: F401 (torch.ops.ctseg)

EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BWD_THREADS = 256  # threads per block of K1b (kBwdThreads)
BWD_TARGET_BLOCKS = 132 * 16  # blocks K1b aims for: 16 on each of 132 SMs
# Chunks a sample at most in the two-phase forms: the statistics between
# their phases add a sample's chunks one after another, one thread a channel,
# so at batch 1 and 4 more chunks cost more than they spread
# (csrc/tools/sweep_k1_chunks.py).
MAX_CHUNKS = 128
CLUSTER_THREADS = 512  # threads per block of K1b's read-once form
CLUSTER_TILE_BYTES = 128 * 1024  # x and g rows a block holds in shared memory
FWD_CLUSTER_THREADS = 256  # threads per block of K1's read-once form
SMS = 132  # streaming multiprocessors of an H100
FWD_CLUSTER_TILE_BYTES = 96 * 1024  # x rows a block holds, two blocks an SM
FWD_CLUSTER_MAX_TILE_BYTES = 192 * 1024  # the most, one block an SM
SMEM_BYTES = 227 * 1024  # shared memory a block may ask for


def _fwd_plain(x: torch.Tensor, alpha: torch.Tensor):
    """(y, mean, var): y like x; mean, var (N, C) in float32 (float64 for
    float64 input)."""
    ctype = torch.promote_types(x.dtype, torch.float32)
    axes = tuple(range(1, x.ndim - 1))
    x32 = x.to(ctype)
    mean = x32.mean(dim=axes, keepdim=True)
    mean_sq = (x32 * x32).mean(dim=axes, keepdim=True)
    var = torch.clamp_min(mean_sq - mean * mean, 0.0)
    xhat = (x32 - mean) * torch.rsqrt(var + EPS)
    a = alpha.reshape(()).to(ctype)
    y = torch.where(xhat >= 0, xhat, a * xhat).to(x.dtype)
    n, c = x.shape[0], x.shape[-1]
    return y, mean.reshape(n, c), var.reshape(n, c)


def instance_norm_prelu_plain(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, *spatial, C) -> same shape and dtype."""
    return _fwd_plain(x, alpha)[0]


def instance_norm_prelu_bwd_plain(x, g, mean, var, alpha):
    """Plain PyTorch version of K1b: (dx like x, dalpha (1,) like alpha).

    x, g: (N, *spatial, C); mean, var: (N, C) from the forward.
    """
    ctype = torch.promote_types(x.dtype, torch.float32)
    axes = tuple(range(1, x.ndim - 1))
    stat_shape = (x.shape[0],) + (1,) * len(axes) + (x.shape[-1],)
    inv = torch.rsqrt(var.to(ctype).reshape(stat_shape) + EPS)
    xhat = (x.to(ctype) - mean.to(ctype).reshape(stat_shape)) * inv
    g32 = g.to(ctype)
    a = alpha.reshape(()).to(ctype)
    gh = torch.where(xhat >= 0, g32, a * g32)
    m1 = gh.mean(dim=axes, keepdim=True)
    m2 = (gh * xhat).mean(dim=axes, keepdim=True)
    dx = (inv * (gh - m1 - xhat * m2)).to(x.dtype)
    dalpha = (g32 * torch.clamp_max(xhat, 0.0)).sum()
    return dx, dalpha.reshape(1).to(alpha.dtype)


def _split_plan(n: int, s: int, c: int, itemsize: int, aligned: bool,
                sums: int) -> dict:
    vec = 16 // itemsize
    if not aligned or (s * c) % vec != 0:
        vec = 1
    g = math.gcd(c, vec)
    q = c // g
    wc = min(q, BWD_THREADS)
    rr = BWD_THREADS // wc
    coltiles = -(-q // wc)
    rows_total = s // (vec // g)
    # Enough chunks to fill the card, each at least 4 iterations long, at
    # most MAX_CHUNKS.
    wanted = -(-BWD_TARGET_BLOCKS // (n * coltiles))
    chunks = max(1, min(wanted, rows_total // (4 * rr), MAX_CHUNKS))
    rows_per_chunk = -(-rows_total // chunks)
    chunks = -(-rows_total // rows_per_chunk)
    return {
        "vec": vec, "q": q, "lcm": q * vec, "wc": wc, "rr": rr,
        "coltiles": coltiles, "rows_total": rows_total,
        "rows_per_chunk": rows_per_chunk, "chunks": chunks,
        "grid": (coltiles, chunks, n),
        "workspace": (n, chunks, sums, q * vec),
    }


def bwd_plan(n: int, s: int, c: int, itemsize: int, aligned: bool = True) -> dict:
    """How K1b cuts n samples of s pixels x c channels (`itemsize` bytes an
    element) into blocks: the geometry of csrc/instance_norm.cu.

    vec: elements a lane takes, 16 bytes' worth when a sample's length is a
    multiple of that (and the tensors are 16-byte aligned), else 1. A
    super-row is lcm(c, vec) elements: q = c / gcd(c, vec) vectors over
    vec / gcd pixels, after which the channel pattern repeats. A block takes
    wc = min(q, 256) columns of it and rr = 256 // wc super-rows at a time,
    over rows_per_chunk super-rows; the grid is (coltiles, chunks, n). The
    chunks cover the rows_total super-rows once: chunk i is rows
    [i * rows_per_chunk, min((i + 1) * rows_per_chunk, rows_total)).
    workspace: the partials' shape, (n, chunks, 3, lcm)."""
    return _split_plan(n, s, c, itemsize, aligned, 3)


def fwd_plan(n: int, s: int, c: int, itemsize: int, aligned: bool = True) -> dict:
    """K1's two-phase form: `bwd_plan`'s geometry with two sums (x, x^2) in
    the workspace, (n, chunks, 2, lcm)."""
    return _split_plan(n, s, c, itemsize, aligned, 2)


def fwd_cluster_smem_bytes(rows_per_cta: int, wcc: int, vec: int) -> int:
    """Shared memory of a block of the read-once forward kernel
    (csrc/instance_norm.cu::fwd_cluster_smem_bytes): its rows of x, the
    block's reduction buffer, its sums and the statistics, in float32."""
    return rows_per_cta * wcc * 16 + 4 * (
        2 * FWD_CLUSTER_THREADS * vec + 4 * wcc * vec)


def fwd_cluster_candidates(n: int, s: int, c: int, itemsize: int,
                           aligned: bool = True) -> list:
    """Every geometry the read-once forward kernel takes for this shape, as
    `fwd_cluster_plan` returns them, in its order of preference: tiles that
    leave room for two blocks an SM before larger ones, small clusters
    before large ones (a cluster-wide barrier costs more the more blocks
    wait at it; 16 is a size CUDA calls non-portable), wide tiles before
    narrow ones."""
    vec = 16 // itemsize
    if not aligned or (s * c) % vec != 0 or s < 1:
        return []
    g = math.gcd(c, vec)
    q = c // g
    rows_total = s // (vec // g)
    if c % vec == 0:
        widths = [w for w in (256, 128, 64, 32, 16, 8, 4) if q % w == 0]
    else:
        widths = [q] if q <= FWD_CLUSTER_THREADS else []
    out = []
    for lo, hi in ((0, FWD_CLUSTER_TILE_BYTES),
                   (FWD_CLUSTER_TILE_BYTES, FWD_CLUSTER_MAX_TILE_BYTES)):
        for size, least in ((1, 8), (2, 8), (8, 8), (16, 4)):
            rows_per_cta = -(-rows_total // size)
            for wcc in widths:
                if wcc >= min(least, q) and \
                        lo < rows_per_cta * wcc * 16 <= hi and \
                        fwd_cluster_smem_bytes(rows_per_cta, wcc, vec) \
                        <= SMEM_BYTES:
                    out.append({
                        "vec": vec, "q": q, "lcm": q * vec, "wcc": wcc,
                        "size": size, "rr": FWD_CLUSTER_THREADS // wcc,
                        "coltiles": q // wcc, "rows_total": rows_total,
                        "rows_per_cta": rows_per_cta,
                        "tile_bytes": rows_per_cta * wcc * 16,
                        "grid": (size * (q // wcc), 1, n),
                    })
    return out


def fwd_cluster_plan(n: int, s: int, c: int, itemsize: int,
                     aligned: bool = True):
    """The read-once form of K1's forward, or None where it does not apply.

    A cluster of 1, 2, 8 or 16 blocks holds one sample's tile of `wcc` 16-byte
    vectors of the super-row (see `bwd_plan`) over all rows_total super-rows
    in its shared memory, block r the super-rows [r * rows_per_cta, (r + 1) *
    rows_per_cta), so x is read from device memory once. Where the channels
    are whole vectors (c % vec == 0) the tile is a power-of-two number of
    vectors that divides q, its rows at least 128 bytes (64 with 16
    blocks); otherwise it is the whole super-row (wcc == q: 256x256x10 is 5
    vectors, two pixels), so that every element column carrying a channel
    lies in the tile. It applies when a block's share of such a tile fits
    FWD_CLUSTER_MAX_TILE_BYTES and, with the sums beside it, SMEM_BYTES. Of `fwd_cluster_candidates` the first is
    taken, or the widest narrower tile of the same cluster size whose grid
    gives every SM a block where the first one's does not: measured on the
    card per site by csrc/tools/sweep_instance_norm_fwd.py. Model L's
    16x16x512 site takes one block a tile, 32x32x256 clusters of 2,
    64x64x128 of 8, 128x128x64 and 256x256x10 of 16. Everything else (a
    sample whose bytes are no multiple of 16, a view off the 16-byte grid, a
    super-row wider than a block, a sample larger than a cluster's shared
    memory) takes `fwd_plan`."""
    found = fwd_cluster_candidates(n, s, c, itemsize, aligned)
    if not found:
        return None
    for plan in found:  # the first one's narrower tiles follow it
        if plan["size"] != found[0]["size"]:
            break
        if math.prod(plan["grid"]) >= SMS:
            return plan
    return found[0]


def bwd_cluster_plan(n: int, s: int, c: int, itemsize: int,
                     aligned: bool = True):
    """The read-once form of K1b, or None where it does not apply.

    A cluster of 8 or 16 blocks holds one sample's tile of `wcc` 16-byte
    vectors (wcc * vec channels) over all s pixels in its shared memory,
    block r the pixels [r * rows_per_cta, (r + 1) * rows_per_cta), so x and
    g are read from device memory once. It applies when the channels are
    whole vectors (c % vec == 0) and some power-of-two tile width that
    divides c / vec fits a block's share of x and g into CLUSTER_TILE_BYTES:
    with 8 blocks and rows of at least 128 bytes (wcc >= 8) where that
    fits, else with 16 blocks and rows of at least 64 bytes. Model L's
    64x64x128, 32x32x256 and 16x16x512 sites take clusters of 8, 128x128x64
    clusters of 16 (16 float32 channels a tile); 256x256x10 (40-byte pixel
    rows) takes the two-phase form."""
    vec = 16 // itemsize
    if not aligned or c % vec != 0 or s < 1:
        return None
    q = c // vec
    for size, least in ((8, 8), (16, 4)):
        rows_per_cta = -(-s // size)
        wcc = CLUSTER_THREADS
        while wcc >= least:
            if q % wcc == 0 and \
                    2 * rows_per_cta * wcc * 16 <= CLUSTER_TILE_BYTES:
                return {
                    "vec": vec, "q": q, "wcc": wcc, "size": size,
                    "rr": CLUSTER_THREADS // wcc, "coltiles": q // wcc,
                    "rows_per_cta": rows_per_cta,
                    "grid": (size * (q // wcc), 1, n),
                    "workspace": (n, size, 3, c),
                }
            wcc //= 2
    return None


def instance_norm_prelu_fwd_chunked(x, alpha, chunk: int):
    """K1's forward as the split-spatial kernels compute it, in plain
    PyTorch: the sums of x and x^2 per (sample, chunk of `chunk` pixels,
    channel), the chunks added in index order, then the one-pass statistics
    and y. Same results as `_fwd_plain`, (y, mean, var), up to the order of
    the sums."""
    ctype = torch.promote_types(x.dtype, torch.float32)
    n, c = x.shape[0], x.shape[-1]
    x32 = x.to(ctype).reshape(n, -1, c)
    totals = []
    for t in (x32, x32 * x32):
        total = torch.zeros((n, c), dtype=ctype)
        for part in torch.split(t, chunk, dim=1):  # the workspace's rows
            total = total + part.sum(dim=1)
        totals.append(total)
    s = x32.shape[1]
    mean = totals[0] / s
    var = torch.clamp_min(totals[1] / s - mean * mean, 0.0)
    xhat = (x32 - mean[:, None]) * torch.rsqrt(var[:, None] + EPS)
    a = alpha.reshape(()).to(ctype)
    y = torch.where(xhat >= 0, xhat, a * xhat).reshape(x.shape).to(x.dtype)
    return y, mean, var


def instance_norm_prelu_bwd_chunked(x, g, mean, var, alpha, chunk: int):
    """K1b as the split-spatial kernels compute it, in plain PyTorch: the
    three sums per (sample, chunk of `chunk` pixels, channel), the chunks
    added in index order, then dx. Same signature and results as
    `instance_norm_prelu_bwd_plain`, up to the order of the sums."""
    ctype = torch.promote_types(x.dtype, torch.float32)
    n, c = x.shape[0], x.shape[-1]
    inv = torch.rsqrt(var.to(ctype).reshape(n, 1, c) + EPS)
    xhat = (x.to(ctype).reshape(n, -1, c) - mean.to(ctype).reshape(n, 1, c)) * inv
    g32 = g.to(ctype).reshape(n, -1, c)
    a = alpha.reshape(()).to(ctype)
    gh = torch.where(xhat >= 0, g32, a * g32)
    terms = (gh, gh * xhat, g32 * torch.clamp_max(xhat, 0.0))
    totals = []
    for t in terms:
        total = torch.zeros((n, c), dtype=ctype)
        for part in torch.split(t, chunk, dim=1):  # the workspace's rows
            total = total + part.sum(dim=1)
        totals.append(total)
    s = xhat.shape[1]
    m1 = (totals[0] / s).reshape(n, 1, c)
    m2 = (totals[1] / s).reshape(n, 1, c)
    dx = (inv * (gh - m1 - xhat * m2)).reshape(x.shape).to(x.dtype)
    return dx, totals[2].sum().reshape(1).to(alpha.dtype)


def _check_shapes(x: torch.Tensor, alpha: torch.Tensor) -> None:
    if x.ndim < 3:
        raise ValueError(f"want (N, *spatial, C), got shape {tuple(x.shape)}")
    if alpha.numel() != 1:
        raise ValueError(f"want one shared alpha, got shape {tuple(alpha.shape)}")


def _check_cuda(x: torch.Tensor, alpha: torch.Tensor, **others) -> tuple:
    """Raise on what the kernels do not take; returns (n, s, c)."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    for name, t in {"x": x, **others}.items():
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"kernel wants {name} contiguous on {x.device} in (N, "
                "*spatial, C) order (the NHWC view of a channels_last tensor);"
                f" got strides {tuple(t.stride())} on {t.device}"
            )
    if alpha.dtype != torch.float32 or alpha.device != x.device:
        raise TypeError(
            f"kernel wants alpha float32 on {x.device}, got {alpha.dtype} "
            f"on {alpha.device}"
        )
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // max(n * c, 1)
    if x.numel() == 0 or x.numel() >= 2**31 or n > 65535:
        raise ValueError(f"kernel does not take shape {tuple(x.shape)}")
    return n, s, c


def _forward(x: torch.Tensor, alpha: torch.Tensor, train: bool):
    """(y, mean, var); mean and var are None unless `train`. On CUDA,
    launches the read-once cluster kernel or the two-phase kernels, or
    raises."""
    if x.device.type == "cpu":
        y, mean, var = _fwd_plain(x, alpha)
        return (y, mean, var) if train else (y, None, None)
    n, s, c = _check_cuda(x, alpha)
    lib = _build.library()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    cluster = fwd_cluster_plan(n, s, c, x.element_size(), aligned)
    mean = var = None
    if train or cluster is None:  # the two-phase form keeps them in between
        mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
        var = torch.empty((n, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if cluster is not None:
        err = lib.ctseg_in_prelu_fwd_cluster(
            x.data_ptr(), y.data_ptr(), alpha.data_ptr(),
            None if mean is None else mean.data_ptr(),
            None if var is None else var.data_ptr(), n, s, c,
            cluster["wcc"], cluster["size"], _DTYPE_CODES[x.dtype],
            x.device.index, stream,
        )
    else:
        plan = fwd_plan(n, s, c, x.element_size(), aligned)
        parts = torch.empty(plan["workspace"], dtype=torch.float32,
                            device=x.device)
        err = lib.ctseg_in_prelu_fwd(
            x.data_ptr(), y.data_ptr(), alpha.data_ptr(), parts.data_ptr(),
            mean.data_ptr(), var.data_ptr(), n, s, c, plan["vec"],
            plan["chunks"], plan["rows_per_chunk"], _DTYPE_CODES[x.dtype],
            x.device.index, stream,
        )
    lib.check(err, "instance_norm_prelu")
    instance_norm_prelu.launches += 1
    return (y, mean, var) if train else (y, None, None)


def instance_norm_prelu_bwd(x, g, mean, var, alpha):
    """K1b: (dx, dalpha) of PReLU(InstanceNorm(x)) for the cotangent g.

    x, g: (N, *spatial, C) of one dtype; mean, var: (N, C) from the training
    forward. On CUDA, launches the read-once cluster kernel or the two-phase
    kernels (dalpha summed from the workspace's partials with torch.sum, a
    fixed order) or raises.
    """
    _check_shapes(x, alpha)
    if x.device.type == "cpu":
        return instance_norm_prelu_bwd_plain(x, g, mean, var, alpha)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise TypeError(
            f"want g like x {tuple(x.shape)} {x.dtype}, got "
            f"{tuple(g.shape)} {g.dtype}"
        )
    for name, t in (("mean", mean), ("var", var)):
        if t.dtype != torch.float32 or t.shape != (x.shape[0], x.shape[-1]):
            raise TypeError(
                f"kernel wants {name} (N, C) float32, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
    n, s, c = _check_cuda(x, alpha, g=g, mean=mean, var=var)
    lib = _build.library()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, g, dx))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cluster = bwd_cluster_plan(n, s, c, x.element_size(), aligned)
    if cluster is not None:
        parts = torch.empty(cluster["workspace"], dtype=torch.float32,
                            device=x.device)
        err = lib.ctseg_in_prelu_bwd_cluster(
            x.data_ptr(), g.data_ptr(), mean.data_ptr(), var.data_ptr(),
            alpha.data_ptr(), dx.data_ptr(), parts.data_ptr(), n, s, c,
            cluster["wcc"], cluster["size"], _DTYPE_CODES[x.dtype],
            x.device.index, stream,
        )
    else:
        plan = bwd_plan(n, s, c, x.element_size(), aligned)
        parts = torch.empty(plan["workspace"], dtype=torch.float32,
                            device=x.device)
        means = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
        err = lib.ctseg_in_prelu_bwd(
            x.data_ptr(), g.data_ptr(), mean.data_ptr(), var.data_ptr(),
            alpha.data_ptr(), dx.data_ptr(), parts.data_ptr(),
            means.data_ptr(), n, s, c,
            plan["vec"], plan["chunks"], plan["rows_per_chunk"],
            _DTYPE_CODES[x.dtype], x.device.index, stream,
        )
    lib.check(err, "instance_norm_prelu_bwd")
    instance_norm_prelu_bwd.launches += 1
    # Plane 2 of either workspace holds dalpha's partials.
    return dx, parts[:, :, 2].sum().reshape(1)


class _InstanceNormPReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        y, mean, var = _forward(x, alpha, train=True)
        ctx.save_for_backward(x, mean, var, alpha)
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, var, alpha = ctx.saved_tensors
        # The cotangent of a view (a slice of a skip concatenation, a
        # permute) may be strided; the kernel reads (N, *spatial, C) rows.
        return instance_norm_prelu_bwd(x, g.contiguous(), mean, var, alpha)


def instance_norm_prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU(InstanceNorm(x)) over (N, *spatial, C); output in x's dtype."""
    _check_shapes(x, alpha)
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad):
        return _InstanceNormPReLU.apply(x, alpha)
    return torch.ops.ctseg.instance_norm_prelu(x, alpha)


instance_norm_prelu.launches = 0  # K1 launches since the last reset
instance_norm_prelu_bwd.launches = 0  # K1b launches since the last reset
