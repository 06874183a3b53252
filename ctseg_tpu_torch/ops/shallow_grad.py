"""Weight gradients of the shallow-channel convs: the hand-written CUDA
kernel and its plain versions (port of ctseg_tpu/ops/shallow_grad.py).

The top decoder level maps straight to out_channels = 10, so its
transposed conv and the residual unit's conv after it run with 10-channel
operands. The JAX package gives those two convs custom VJPs that change
only the weight gradient (XLA's native one filled 10 of 128 lanes); on the
H100, cuDNN's FP32 weight gradient is slow at the same sites (521 ms for
the bench_3d transposed conv, 513 for the 10 -> 10 conv,
csrc/tools/probe_conv3d_fp32.py --sites). Here the same two convs are
`torch.autograd.Function`s:

  - forward: the F.conv3d / F.conv_transpose{2,3}d call the units make,
    bit for bit;
  - dx: cuDNN's (`aten.convolution_backward` with the input's mask only),
    as the JAX rule leaves dx to XLA;
  - dW and db: `shallow_dw`, one pass over x and dy. On a CUDA tensor it
    launches csrc/shallow_dw.cu for the stride-1 conv and, through
    `shallow_dwt`, csrc/shallow_dwt.cu for the transposed conv (or
    raises); on a CPU tensor it runs the JAX formulations in torch,
    `dw_merged_3d_plain` (the merged (D, C) fold and its band) and
    `convt_dw_plain` (the dilated-rhs conv with the batch contracted, then
    the spatial flip), and db as a float32 sum;
  - each gradient only where `ctx.needs_input_grad` asks for it.

The 2D plain conv keeps the library's weight gradient, as the JAX rule
keeps XLA's there. `smallc_supported` is the JAX package's routing rule,
with its two constants. The JAX package's `conv_packed_depth` and
`polyphase_conv_transpose` (off by default there, rejected by its own
measurements) have no counterpart.

Layouts: the Functions take (N, C, *spatial) tensors and torch's weights
((Cout, Cin, *k) for a conv, (Cin, Cout, *k) for a transposed conv); the
plain versions take the (N, *spatial, C) views and return the JAX package's
(*k, Cin, Cout) layout, whose transposed-conv taps are torch's flipped
(models/jax_import.py).
"""

import functools
import math

import torch
import torch.nn.functional as F

from ctseg_tpu_torch.ops import _build

# Largest min(Cin, Cout) that routes to these weight gradients.
SMALLC_THRESHOLD = 16
# Deepest activation the 3D plain conv routes at (the JAX package's
# measured envelope of the merged fold).
SMALLC_MERGED_MAX_DEPTH = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CONV_FN = {4: F.conv2d, 5: F.conv3d}
_CONV_T_FN = {4: F.conv_transpose2d, 5: F.conv_transpose3d}
# The stride-1 kernel's plan (`dw_plan`; csrc/shallow_dw.cu checks it).
# STRIPS: voxels a block's step stages (t1 columns of td depths), by
# itemsize, in order of preference: the first for which a tap grouping's
# ring fits a block's shared memory (csrc/tools/sweep_shallow_dw.py).
STRIPS = {2: (512, 256, 128, 64, 32, 16), 4: (512, 256, 128, 64, 32, 16)}
RING_EXTRA = 0      # ring slots past the hspan + 1 a step needs (the sweep's
                    # --ring-extra)
MIN_BLOCKS = 264    # below this many blocks h is cut into segments: two
                    # for each of an H100's 132 SMs (one a time each)
MIN_GROUPS = 16     # where a role's planes cover one kh (no plane staged
                    # twice), h is cut until a role has this many blocks, as
                    # far as MAX_GRID allows: each float32 output then sums
                    # 8 warps x MIN_GROUPS float32 chains in float64, and
                    # its error falls as their square root (PERF.md, section 6)
MAX_GRID = 1056     # blocks a launch, 8 for each SM: past it a block walks
                    # several units (runs x depth tiles x segments x
                    # samples), and past it in roles the roles take several
                    # launches; the workspaces are at most MAX_GRID blocks'
MAX_SHARED = 232448
MAX_K = 789         # the largest odd k the stride-1 plan takes: one column
                    # of 16 depths over a line of one kh fits MAX_SHARED in
                    # both types up to it (float32 with a Cin tile of 16 is
                    # the first past it, at 791)
S1_WARPS = 8        # the kernel's computing warps (kWarps)
TAPS_F32 = 32       # taps a float32 role: the lanes of a warp (kMaxTapsF32)
TAPS_BF16 = 27      # taps a bfloat16 role: 4 warps of 7, one slot for db
ROW_WORDS_BF16 = 12  # a bfloat16 shared row: 16 values at a 48-byte stride
ONES_WORDS = 16 * ROW_WORDS_BF16  # bfloat16: 16 rows of ones (db's tap)
# The plan's entries csrc/shallow_dw.cu takes, in its argument order.
_PLAN_ARGS = ("tl", "tg", "s_tile", "t_tile", "t1", "td", "hs", "hspan",
              "wspan", "stages", "sx", "sdy", "x_words", "slot_words",
              "groups", "rpl", "smem_bytes", "part_elems", "dbpart_elems")
# The transposed kernel's plan (`dwt_plan`; csrc/shallow_dwt.cu checks it).
# DWT_STRIPS: x voxels a block stages at a time, the first that fits a
# block's shared memory, by itemsize (csrc/tools/sweep_shallow_dw.py:
# bfloat16 gains from the longest strip, float32's 2D site from 32).
DWT_STRIPS = {2: (128, 64, 32, 16), 4: (32, 16)}
DWT_STAGES = 3      # strips in flight (csrc/shallow_dwt.cu's kStages; the
                    # sweep's --dwt-stages: 2 slower by 6-44%, 4 by 1-16%)
DWT_WARPS = 8       # Cin tiles of 16 a block (kWarps), beside 4 staging warps
DWT_SPLIT_WORDS = 40  # a split float32 window row (kSplitWords)
SMS = 132           # an H100's SMs: one block each (its 384 threads take
                    # the register file; 2 a SM: 0.3-11% slower, the
                    # sweep's --dwt-groups-per-sm)
_DWT_PLAN_ARGS = ("n_ct", "t1", "t2", "groups", "sx", "sdy", "x_words",
                  "stage_words", "smem_bytes", "part_elems", "dbpart_elems")


def smallc_supported(cin: int, cout: int, stride: int, kernel_size: int,
                     transpose: bool = False, ndim: int = 3,
                     depth=None) -> bool:
    """Whether a conv takes these weight gradients: min(Cin, Cout) <=
    SMALLC_THRESHOLD, and then a k=3, s=2 transposed conv in 2D or 3D, or a
    stride-1 3D conv with an odd kernel whose input depth is at most
    SMALLC_MERGED_MAX_DEPTH (None: unknown, routed)."""
    if min(cin, cout) > SMALLC_THRESHOLD:
        return False
    if transpose:
        return kernel_size == 3 and stride == 2 and ndim in (2, 3)
    if depth is not None and depth > SMALLC_MERGED_MAX_DEPTH:
        return False
    return ndim == 3 and stride == 1 and kernel_size % 2 == 1


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """(N, C, *spatial) -> its (N, *spatial, C) contiguous view (a copy
    unless t is stored channels_last)."""
    return t.movedim(1, -1).contiguous()


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


# ------------------------------------------------------------ plain versions
def dw_merged_3d_plain(x: torch.Tensor, dy: torch.Tensor, pad: int,
                       k: int, pad_d=None) -> torch.Tensor:
    """The 3D stride-1 conv's dW by the merged (D, C) fold, as the JAX
    `_dw_merged_3d`: pad x, fold (D, C) of both operands into one feature
    axis, take the 2D weight gradient M of the merged conv, and read dW off
    its band, dw[kh, kw, kd, ci, co] = sum_q M[kh, kw, (q + kd, ci), (q, co)].
    x (N, H, W, Dx, C), dy (N, H, W, D, Co) -> (k, k, k, C, Co) in
    promote(x.dtype, float32). x is padded by `pad` along H and W and by
    `pad_d` (default `pad`) along D, to D + 2 pad rows: on a depth slab x
    holds its halo rows already (pad_d 0, Dx = D + 2 pad)."""
    b, h, w, dx, c = x.shape
    d, co = dy.shape[3], dy.shape[-1]
    pd = pad if pad_d is None else pad_d
    if dx + 2 * pd != d + 2 * pad:
        raise ValueError(f"x of depth {dx} padded by {pd} is no conv input "
                         f"of dy's depth {d} at pad {pad}")
    acc = _acc_dtype(x.dtype)
    xp = F.pad(x, (0, 0, pd, pd) + (pad, pad) * 2)
    xm = xp.reshape(b, h + 2 * pad, w + 2 * pad, (d + 2 * pad) * c)
    dym = dy.reshape(b, h, w, d * co)
    # Only the weight's shape is read (torch.nn.grad.conv2d_weight's way).
    w2 = x.new_empty(1).expand(d * co, (d + 2 * pad) * c, k, k)
    m = torch.ops.aten.convolution_backward(
        dym.permute(0, 3, 1, 2), xm.permute(0, 3, 1, 2), w2, None, [1, 1],
        [0, 0], [1, 1], False, [0, 0], 1, [False, True, False])[1]
    # (D*Co, (D+2p)*C, k, k) -> the JAX (k, k, (D+2p)*C, D*Co), split.
    m6 = m.permute(2, 3, 1, 0).reshape(k, k, d + 2 * pad, c, d, co).to(acc)
    p_idx = torch.arange(d + 2 * pad, device=x.device)[None, :, None]
    q_idx = torch.arange(d, device=x.device)[None, None, :]
    k_idx = torch.arange(k, device=x.device)[:, None, None]
    ind = (p_idx == q_idx + k_idx).to(acc)
    return torch.einsum("hwpiqo,kpq->hwkio", m6, ind)


def convt_dw_plain(x: torch.Tensor, dy: torch.Tensor, stride: int,
                   k: int) -> torch.Tensor:
    """The transposed conv's dW as the JAX `_convt_smallc_bwd` takes it: a
    conv over dy with x as a stride-dilated kernel and the batch as the
    contracted feature axis, padded (p, k - s - p), whose result arrives in
    flipped tap order and is flipped back. x (N, *S, Ci), dy (N, *(s*S), Co)
    -> (*k, Ci, Co) in the JAX tap order, in promote(x.dtype, float32). dy
    may hold fewer rows along the last spatial axis (a depth slab's output
    rows, the rest of the extended slab's output not kept): the missing
    rows are zeros."""
    nd = x.ndim - 2
    p = (k - 1) // 2
    pad_hi = k - stride - p
    if pad_hi < 0:
        raise ValueError(f"unsupported (k, s) = ({k}, {stride})")
    short = stride * x.shape[nd] - dy.shape[nd]
    if short < 0 or short >= stride * x.shape[nd]:
        raise ValueError(f"dy of {dy.shape[nd]} rows from x of "
                         f"{x.shape[nd]} at stride {stride}")
    acc = _acc_dtype(x.dtype)
    spatial = tuple(range(1, nd + 1))
    # Batch Co, features N; the kernel (Ci, N, *S).
    lhs = F.pad(dy.to(acc), (0, 0, 0, short)).permute(nd + 1, 0, *spatial)
    rhs = x.to(acc).permute(nd + 1, 0, *spatial)
    lhs = F.pad(lhs, (p, pad_hi) * nd)
    out = _CONV_FN[nd + 2](lhs, rhs, dilation=stride)  # (Co, Ci, *k flipped)
    out = out.flip(tuple(range(2, nd + 2)))
    return out.permute(*range(2, nd + 2), 1, 0)


def _bias_grad_plain(dy_nhwc: torch.Tensor) -> torch.Tensor:
    """sum of dy over all but the channel axis, in float32 (the JAX rule's
    promote(dy.dtype, float32)), cast back to dy's type."""
    acc = _acc_dtype(dy_nhwc.dtype)
    return dy_nhwc.to(acc).sum(dim=tuple(range(dy_nhwc.ndim - 1))).to(
        dy_nhwc.dtype)


def _torch_layout(dw_jax: torch.Tensor, transposed: bool) -> torch.Tensor:
    """The JAX (*k, Ci, Co) weight -> torch's: (Co, Ci, *k) for a conv;
    for a transposed conv the taps unflipped, (Ci, Co, *k)."""
    nd = dw_jax.ndim - 2
    if transposed:
        return dw_jax.flip(tuple(range(nd))).permute(nd, nd + 1, *range(nd))
    return dw_jax.permute(nd + 1, nd, *range(nd))


# ------------------------------------------------------------ the kernels
def tiles(cin: int, cout: int, bf16: bool = False):
    """(S, T): the stride-1 kernel's Cout and Cin tiles (csrc/shallow_dw.cu):
    in float32 a lane's T x S accumulators, S = Cout rounded up to 4, 8, 10
    or 16 and T * S <= 128; bfloat16 takes 16 x 16 on the tensor cores."""
    if bf16:
        return 16, 16
    s = 4 if cout <= 4 else 8 if cout <= 8 else 10 if cout <= 10 else 16
    return s, {4: 16, 8: 12, 10: 10, 16: 8}[s]


def _row_words(tile: int) -> int:
    """Words of a float32 shared row: read as float2 by 16 lanes at once at
    a stride of 2 words past a multiple of 4, so they fall on distinct
    banks."""
    return tile + 2 if tile % 4 == 0 else tile


def _ceil4(words: int) -> int:
    return -(-words // 4) * 4


def tap_lines(k: int):
    """The tap groupings the stride-1 plan tries, in order: a role's taps
    are a run of tg taps (in (kh, kw, kd) order) of one line of tl taps,
    lines of k^3 (any taps) or k^2 (one kh)."""
    return tuple(dict.fromkeys((k ** 3, k ** 2)))


def group_span(k: int, first: int, count: int):
    """((kh, kw) of the group's first staged tap, (hspan, wspan)) of the
    `count` taps from tap `first`: the kh it covers, and the kw (all of them
    where it covers two kh); its planes hold every kd."""
    last = first + count - 1
    h0, h1 = first // (k * k), last // (k * k)
    if h0 != h1:
        return (h0, 0), (h1 - h0 + 1, k)
    w0 = first // k % k
    return (h0, w0), (1, last // k % k - w0 + 1)


@functools.lru_cache(maxsize=None)
def tap_groups(k: int, tl: int, itemsize: int):
    """(tg, groups a line, (hspan, wspan)): a role's taps, the roles of a
    line, and the kh and kw a role's ring planes cover, the most over the
    line's groups (every line alike)."""
    gpl = -(-tl // (TAPS_BF16 if itemsize == 2 else TAPS_F32))
    tg = -(-tl // gpl)
    spans = [group_span(k, first, min(tg, tl - first))[1]
             for first in range(0, tl, tg)]
    return tg, -(-tl // tg), tuple(max(s[a] for s in spans)
                                   for a in range(2))


def dw_plan(n: int, spatial, cin: int, cout: int, itemsize: int = 4,
            k: int = 3) -> dict:
    """The stride-1 kernel's geometry for x of (n, *spatial, cin) and a
    k-tap kernel, its one copy (csrc/shallow_dw.cu checks it). A role is a
    group of at most TAPS_F32 or TAPS_BF16 taps (`tap_groups`), a Cin tile
    and a Cout tile; a unit is one run of t1 columns of w by one tile of td
    depths of one sample and one segment of hs rows of h, which a block
    walks for its role, staging one x and one dy plane a step into a ring of
    `stages` slots (the hspan x planes a step reads and one more), an x
    plane (t1 + wspan - 1) columns of (td + k - 1) depths, the kh and kw a
    role covers (`group_span`) and every kd. The first strip of
    STRIPS[itemsize] (t1 x td voxels a step) and the first of `tap_lines`
    whose shared memory fits a block (MAX_SHARED) win; one column of 16
    depths over a line of one kh fits for every k up to MAX_K. h is cut
    into segments where the units and roles make fewer than MIN_BLOCKS
    blocks, or, where a role's planes cover one kh, a
    role fewer than MIN_GROUPS. At most MAX_GRID blocks a launch: rpl
    roles a launch (all where they fit), `groups` blocks a role, each
    walking units g, g + groups, ...; the C entry launches the roles' chunks
    in turn. Also the row strides (sx, sdy) and a slot's words (words of 4
    bytes), the workspaces' element counts (dW's partials float32, db's
    float64: at most MAX_GRID blocks' of one launch) and the shared memory
    a block takes."""
    for strip in STRIPS[itemsize]:
        for tl in tap_lines(k):
            plan = _plan(n, spatial, cin, cout, itemsize, strip, k, tl)
            if plan["smem_bytes"] <= MAX_SHARED:
                return plan
    return plan


def _plan(n, spatial, cin, cout, itemsize, strip, k, tl):
    e0, e1, e2 = spatial
    bf16 = itemsize == 2
    s_tile, t_tile = tiles(cin, cout, bf16)
    tg, gpl, (hspan, wspan) = tap_groups(k, tl, itemsize)
    roles = k ** 3 // tl * gpl * -(-cin // t_tile) * -(-cout // s_tile)
    ndt = -(-e2 // min(e2, strip))
    td = -(-e2 // ndt)
    t1 = max(1, min(e1, strip // td))
    cols = n * -(-e1 // t1) * ndt
    nseg = min(e0, max(1, -(-MIN_BLOCKS // (cols * roles))))
    if hspan == 1:
        groups_max = MAX_GRID // min(roles, MAX_GRID)
        nseg = min(e0, max(nseg, -(-min(MIN_GROUPS, groups_max) // cols)))
    hs = -(-e0 // nseg)
    nseg = -(-e0 // hs)
    units = cols * nseg
    rpl = min(roles, MAX_GRID)
    groups = min(units, MAX_GRID // rpl)
    sx, sdy = (ROW_WORDS_BF16,) * 2 if bf16 else (_row_words(t_tile),
                                                  _row_words(s_tile))
    stages = hspan + 1 + RING_EXTRA
    x_words = _ceil4((t1 + wspan - 1) * (td + k - 1) * sx)
    dy_rows = -(-t1 * td // 16) * 16 if bf16 else t1 * td
    slot_words = x_words + _ceil4(dy_rows * sdy)
    # After the walk the computing warps' sums take the ring's place
    # (bfloat16: S1_WARPS warps x 8 slots x 16 x 16; float32: their lanes x
    # T x S and db's float64 sums); bfloat16's rows of ones follow the ring;
    # then the full and empty barriers.
    ring_words = stages * slot_words + (ONES_WORDS if bf16 else 0)
    lanes_c = 32 * S1_WARPS
    red_words = S1_WARPS * 8 * 256 if bf16 else \
        lanes_c * t_tile * s_tile + 2 * lanes_c
    bar_words = _ceil4(max(ring_words, red_words))
    blocks = groups * rpl
    return {"strip": strip, "k": k, "tl": tl, "tg": tg, "roles": roles,
            "s_tile": s_tile, "t_tile": t_tile, "t1": t1, "td": td,
            "hs": hs, "nseg": nseg, "units": units, "hspan": hspan,
            "wspan": wspan, "stages": stages, "sx": sx,
            "sdy": sdy, "x_words": x_words, "slot_words": slot_words,
            "groups": groups, "rpl": rpl, "launches": -(-roles // rpl),
            "blocks": blocks, "part_elems": blocks * tg * t_tile * s_tile,
            "dbpart_elems": blocks * s_tile,
            "smem_bytes": bar_words * 4 + 16 * stages}


def dwt_plan(n: int, spatial, cin: int, cout: int,
             itemsize: int = 4) -> dict:
    """The transposed kernel's geometry for x of (n, *spatial, cin), its one
    copy (csrc/shallow_dwt.cu checks it): a block's Cin chunk (n_ct tiles of
    16, the warps left over taking every other k-step: `slices`), its Cout
    tile of 16 and, in 3D, its kh (`roles` blocks a group); strips of t1
    columns of w by t2 depths (all of d where a column fits, else one
    column in tiles of d) about DWT_STRIPS[itemsize] voxels, the first
    whose DWT_STAGES buffers fit a block; the dy window's rows; the row
    strides (sx, sdy) and a buffer's words in 4-byte words; G groups of
    strips, one block for each SM; the workspaces' element counts (dW's
    partials float32, db's float64) and the shared memory a block takes."""
    for strip in DWT_STRIPS[itemsize]:
        plan = _dwt_plan(n, spatial, cin, cout, itemsize, strip)
        if plan["smem_bytes"] <= MAX_SHARED:
            break
    return plan


def _dwt_plan(n, spatial, cin, cout, itemsize, strip):
    nd = len(spatial)
    e0, e1 = spatial[0], spatial[1]
    e2 = spatial[2] if nd == 3 else 1
    bf16 = itemsize == 2
    n_ct = min(8, 1 << (-(-cin // 16) - 1).bit_length())
    cin_c = 16 * n_ct
    nkh = 3 if nd == 3 else 1
    roles = -(-cin // cin_c) * -(-cout // 16) * nkh
    slices = DWT_WARPS // n_ct
    if e2 <= strip:
        t2, t1 = e2, max(1, min(e1, strip // e2))
    else:  # a column of d does not fit: one column, d in tiles
        t1, t2 = 1, strip
    qtot = n * e0 * -(-e1 // t1) * -(-e2 // t2)
    ew, ed = t1 + 1, (t2 + 1 if nd == 3 else 1)
    rows = (1 if nd == 3 else 3) * 2 * (2 if nd == 3 else 1) * ew * ed
    # x rows: an odd number of 16-byte units (bfloat16, ldmatrix) or 8
    # words past a multiple of 32 (float32's 32-bit fragment loads); dy
    # rows of 16 channels likewise (48 or 96 bytes).
    sx = (2 * n_ct + 1) * 4 if bf16 else cin_c + 8
    sdy = 12 if bf16 else 24
    x_words = -(-t1 * t2 // 16) * 16 * sx
    stage_words = x_words + -(-rows * sdy // 4) * 4
    # float32: the staging warpgroup splits each strip's window once into
    # tf32 (big, small) pairs for all warps, DWT_STAGES - 1 split windows of
    # rows of DWT_SPLIT_WORDS words after the buffers; then a full and an
    # empty barrier (8 bytes each) a buffer.
    split_words = 0 if bf16 else rows * DWT_SPLIT_WORDS
    smem = (DWT_STAGES * stage_words + (DWT_STAGES - 1) * split_words) * 4 \
        + 16 * DWT_STAGES
    groups = max(1, min(qtot, -(-SMS // roles)))
    blocks = groups * roles
    return {"strip": strip, "n_ct": n_ct, "cin_c": cin_c, "roles": roles,
            "slices": slices, "t1": t1, "t2": t2, "qtot": qtot,
            "window_rows": rows, "sx": sx, "sdy": sdy, "x_words": x_words,
            "stage_words": stage_words, "groups": groups, "blocks": blocks,
            "part_elems": blocks * slices * 9 * cin_c * 16,
            "dbpart_elems": blocks * 16, "smem_bytes": smem}


def _axis_pairs(e_in: int, e_out: int, k: int, transposed: bool,
                pad: int) -> int:
    """(input voxel, tap) pairs of one axis whose output voxel lies in
    [0, e_out): a conv's output o reads input o + t - pad, a transposed
    conv's (k = 3, s = 2) input i writes output 2i - 1 + t."""
    if transposed:
        return sum(max(0, min(e_in, (e_out - t) // 2 + 1) - (2 - t) // 2)
                   for t in range(3))
    return sum(max(0, min(e_out, e_in + pad - t) - max(0, pad - t))
               for t in range(k))


def dw_work(n: int, spatial, cin: int, cout: int, transposed: bool,
            k: int = 3, out_depth=None):
    """(FLOP, bytes) the weight gradient needs: 2 * Cin * Cout for each
    (voxel, tap) pair whose taps all fall inside the tensors, plus db's
    additions; x and dy read once, dW and db written once (4-byte values;
    scale the bytes for bfloat16). `spatial` is x's extents; `out_depth`
    dy's depth where it is not the conv's own (a depth slab: x holds the
    halo rows, p on each side of a stride-1 conv's output rows, 1 after a
    transposed conv's; None: the whole volume)."""
    p = (k - 1) // 2
    out = [2 * e if transposed else e for e in spatial]
    pads = [p] * len(spatial)
    if out_depth is not None:
        out[-1] = out_depth
        if not transposed:
            pads[-1] = p - (spatial[-1] - out_depth) // 2
    pairs = n
    for e, f, pa in zip(spatial, out, pads):
        pairs *= _axis_pairs(e, f, k, transposed, pa)
    vox = n * math.prod(spatial)
    out_vox = n * math.prod(out)
    flop = 2 * pairs * cin * cout + out_vox * cout
    nbytes = 4 * (vox * cin + out_vox * cout
                  + k ** len(spatial) * cin * cout + cout)
    return flop, nbytes


def shallow_dw_plain(x: torch.Tensor, dy: torch.Tensor, transposed: bool,
                     kernel_size: int = 3, stride=None, pad=None,
                     pad_d=None):
    """`shallow_dw`'s plain version on any device: the JAX formulation
    (`convt_dw_plain` or `dw_merged_3d_plain`) in torch's weight layout and
    x's type, and db summed in float32."""
    s = (2 if transposed else 1) if stride is None else stride
    p = (kernel_size - 1) // 2 if pad is None else pad
    xv, dv = _nhwc(x), _nhwc(dy)
    if transposed:
        dw = convt_dw_plain(xv, dv, s, kernel_size)
    else:
        dw = dw_merged_3d_plain(xv, dv, p, kernel_size, pad_d)
    return _torch_layout(dw, transposed).to(x.dtype), _bias_grad_plain(dv)


def _check_pair(x: torch.Tensor, dy: torch.Tensor, cpu_ok: bool = False):
    """x and dy of one type on one device, a device with a kernel (or, with
    cpu_ok, the CPU) and a type the kernels take."""
    if x.dtype != dy.dtype or x.device != dy.device:
        raise TypeError(f"x {x.dtype} on {x.device}, dy {dy.dtype} on "
                        f"{dy.device}")
    if cpu_ok and x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel wants float32 or bfloat16, got {x.dtype}")


def shallow_dw(x: torch.Tensor, dy: torch.Tensor, transposed: bool,
               kernel_size: int = 3, stride=None, pad=None, pad_d=None):
    """(dW, db) of a routed conv from its input x (N, Cin, *S) and output
    gradient dy (N, Cout, *S'), dW in torch's weight layout and x's type,
    db in dy's. A CPU tensor takes `shallow_dw_plain`; a CUDA tensor
    launches a kernel (every conv `smallc_supported` routes) or raises: the
    k=3, s=2 transposed conv in 2D and 3D csrc/shallow_dwt.cu
    (`shallow_dwt`), the stride-1 3D conv with an odd kernel up to MAX_K
    and pad (k-1)//2 csrc/shallow_dw.cu, any depth and extents.

    On a depth slab (parallel/collectives.py::DepthShard) x is the slab
    with its halo rows: the stride-1 conv's x has 2 (pad - pad_d) rows more
    than dy along D (pad_d, the depth padding, is 0 there and `pad` by
    default), and the transposed conv's dy may hold fewer than 2 x's rows
    along D (the slab's own output rows; the rest read as zeros)."""
    nd = x.ndim - 2
    _check_pair(x, dy, cpu_ok=True)
    if x.device.type == "cpu":
        return shallow_dw_plain(x, dy, transposed, kernel_size, stride, pad,
                                pad_d)
    k = kernel_size
    s = (2 if transposed else 1) if stride is None else stride
    p = (k - 1) // 2 if pad is None else pad
    pd = p if pad_d is None else pad_d
    if transposed:
        if (k, s, p, pd) != (3, 2, 1, 1):
            raise ValueError("kernel takes k=3 s=2 pad 1 transposed convs; "
                             f"got k={k}, stride {s}, pad {p}, depth pad "
                             f"{pd}")
        return shallow_dwt(x, dy)
    n, cin, *spatial = x.shape
    cout = dy.shape[1]
    if nd != 3 or s != 1 or k % 2 == 0 or k > MAX_K or \
            p != (k - 1) // 2 or not 0 <= pd <= p or dy.shape[0] != n or \
            list(dy.shape[2:4]) != spatial[:2] or \
            dy.shape[4] + 2 * (p - pd) != spatial[2]:
        raise ValueError(
            f"the stride-1 kernel takes 3D convs of odd k up to {MAX_K}, pad "
            f"(k-1)//2, depth pad 0 to it; got k={k}, stride {s}, pad {p}, "
            f"depth pad {pd}, x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    spatial = list(dy.shape[2:])  # the plan walks dy's voxels
    plan = dw_plan(n, spatial, cin, cout, x.element_size(), k)
    # dw_plan finds a fitting plan for every k up to MAX_K (one column of 16
    # depths over a line of one kh fits); the C entry checks it again.
    assert plan["smem_bytes"] <= MAX_SHARED, plan
    xv, dv = _nhwc(x), _nhwc(dy)
    dw = torch.empty((cout, cin, k, k, k), dtype=x.dtype, device=x.device)
    db = torch.empty(cout, dtype=x.dtype, device=x.device)
    part = torch.empty(plan["part_elems"], dtype=torch.float32,
                       device=x.device)
    dbpart = torch.empty(plan["dbpart_elems"], dtype=torch.float64,
                         device=x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ctseg_shallow_dw(
        xv.data_ptr(), dv.data_ptr(), part.data_ptr(), dbpart.data_ptr(),
        dw.data_ptr(), db.data_ptr(), n, *spatial, x.shape[4], cin, cout, k,
        pd,
        *(plan[key] for key in _PLAN_ARGS), _DTYPE_CODES[x.dtype],
        x.device.index, stream)
    lib.check(err, "shallow_dw")
    shallow_dw.launches += 1
    return dw, db


# csrc/shallow_dw.cu's calls (its main kernel and finalize, once for each
# launch's roles) since reset: the stride-1 conv's; the transposed conv's
# count on `shallow_dwt`.
shallow_dw.launches = 0


def shallow_dwt(x: torch.Tensor, dy: torch.Tensor):
    """(dW, db) of the k=3, s=2, pad 1, output padding 1 transposed conv from
    x (N, Cin, *S) and dy (N, Cout, *2S) on the card, 2D or 3D, float32 or
    bfloat16, any channel counts: one launch of csrc/shallow_dwt.cu (and
    its finalize). In 3D dy may hold 1 to 2 D rows along D (a depth slab's
    output rows; the rows past them read as zeros). dW is torch's (Cin,
    Cout, 3, 3[, 3]) in x's type, db (Cout,). Raises on anything else;
    there is no other route."""
    _check_pair(x, dy)
    nd = x.ndim - 2
    n, cin, *spatial = x.shape
    cout = dy.shape[1]
    twice = [2 * e for e in spatial]
    if nd not in (2, 3) or dy.ndim != x.ndim or dy.shape[0] != n or \
            list(dy.shape[2:-1]) != twice[:-1] or not (
                1 <= dy.shape[-1] <= twice[-1] if nd == 3
                else dy.shape[-1] == twice[-1]):
        raise ValueError("kernel takes a k=3 s=2 transposed conv in 2D or "
                         f"3D; got x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    plan = dwt_plan(n, spatial, cin, cout, x.element_size())
    if plan["smem_bytes"] > MAX_SHARED:
        raise ValueError(f"kernel does not take x {tuple(x.shape)}: a strip "
                         f"needs {plan['smem_bytes']} bytes of shared memory")
    xv, dv = _nhwc(x), _nhwc(dy)
    dw = torch.empty((cin, cout) + (3,) * nd, dtype=x.dtype, device=x.device)
    db = torch.empty(cout, dtype=x.dtype, device=x.device)
    part = torch.empty(plan["part_elems"], dtype=torch.float32,
                       device=x.device)
    dbpart = torch.empty(plan["dbpart_elems"], dtype=torch.float64,
                         device=x.device)
    e = list(spatial) + [1] * (3 - nd)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ctseg_shallow_dwt(
        xv.data_ptr(), dv.data_ptr(), part.data_ptr(), dbpart.data_ptr(),
        dw.data_ptr(), db.data_ptr(), n, *e, dy.shape[-1] if nd == 3 else 1,
        cin, cout, nd,
        *(plan[key] for key in _DWT_PLAN_ARGS), _DTYPE_CODES[x.dtype],
        x.device.index, stream)
    lib.check(err, "shallow_dwt")
    shallow_dwt.launches += 1
    return dw, db


shallow_dwt.launches = 0  # csrc/shallow_dwt.cu's calls since reset


# ------------------------------------------------------------ the Functions
def _tuple(v, nd):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * nd


class ConvSmallC(torch.autograd.Function):
    """F.conv{2,3}d(x, w, b, stride, pad) whose dW and db come from
    `shallow_dw` in 3D (the library's dW in 2D, as the JAX rule keeps
    XLA's) and dx from cuDNN. In 3D the depth padding may be less than the
    H and W padding (a depth slab with its halo rows: pad (p, p, 0))."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pad):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad)
        return _CONV_FN[x.ndim](x, w, b, stride, pad)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        nd = x.ndim - 2
        stride, pad = (_tuple(v, nd) for v in ctx.conf)
        dx = dw = db = None
        if need_x or (nd == 2 and need_w):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dy, x, w, None, stride, pad, (1,) * nd, False, (0,) * nd, 1,
                [need_x, nd == 2 and need_w, False])
        if nd == 3 and (need_w or need_b):
            if set(stride) != {1} or pad[0] != pad[1]:
                raise ValueError(f"stride {stride}, pad {pad}: not a routed "
                                 "conv")
            dw, db = shallow_dw(x, dy, False, w.shape[-1], 1, pad[0], pad[2])
        elif need_b:
            db = _bias_grad_plain(dy.movedim(1, -1))
        return (dx, dw.to(w.dtype) if need_w else None,
                db if need_b else None, None, None)


class ConvTransposeSmallC(torch.autograd.Function):
    """F.conv_transpose{2,3}d(x, w, b, stride, (k-1)//2, stride-1) whose dW
    and db come from `shallow_dw` and dx from cuDNN. `depth`: the output
    rows kept along the last axis (a depth slab's own, its x extended by
    the halo rows after it), None for all; dy then holds only those, and
    dW and db are theirs."""

    @staticmethod
    def forward(ctx, x, w, b, stride, kernel_size, depth):
        ctx.save_for_backward(x, w)
        y = _CONV_T_FN[x.ndim](x, w, b, stride, (kernel_size - 1) // 2,
                               stride - 1)
        ctx.conf = (stride, kernel_size, y.shape[-1])
        return y if depth is None else y.narrow(y.ndim - 1, 0, depth)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        stride, k, full = ctx.conf
        nd = x.ndim - 2
        dx = dw = db = None
        if need_x:
            # The rows not kept had a zero cotangent.
            dyf = dy if dy.shape[-1] == full else F.pad(
                dy, (0, full - dy.shape[-1]))
            dx = torch.ops.aten.convolution_backward(
                dyf, x, w, None,
                (stride,) * nd, ((k - 1) // 2,) * nd, (1,) * nd, True,
                (stride - 1,) * nd, 1, [True, False, False])[0]
        if need_w or need_b:
            dw, db = shallow_dw(x, dy, True, k, stride)
        return (dx, dw.to(w.dtype) if need_w else None,
                db if need_b else None, None, None, None)


def conv_smallc(x, w, b, stride, pad):
    """x (N, Cin, *S), torch weight (Cout, Cin, *k), bias (Cout,): the conv
    with the shallow weight gradient (stride 1, odd k, pad (k-1)//2, or 0
    along D on a depth slab extended by its halo rows). F.conv3d's
    arguments, so parallel/collectives.py::DepthShard.conv takes it as its
    conv."""
    return ConvSmallC.apply(x, w, b, stride, pad)


def conv_transpose_smallc(x, w, b, stride, kernel_size, depth=None):
    """x (N, Cin, *S), torch weight (Cin, Cout, *k), bias (Cout,): the
    transposed conv (out = in * stride) with the shallow weight gradient;
    its first `depth` rows along D where given (a depth slab's,
    parallel/collectives.py::DepthShard.conv_transpose_smallc)."""
    return ConvTransposeSmallC.apply(x, w, b, stride, kernel_size, depth)
