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
    launches csrc/shallow_dw.cu (or raises); on a CPU tensor it runs the
    JAX formulations in torch, `dw_merged_3d_plain` (the merged (D, C)
    fold and its band) and `convt_dw_plain` (the dilated-rhs conv with the
    batch contracted, then the spatial flip), and db as a float32 sum;
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
# The kernel's plan (`dw_plan`; csrc/shallow_dw.cu checks it). STRIPS:
# voxels of the base operand a block stages at a time, the first that fits
# a block's shared memory, by itemsize (csrc/tools/sweep_shallow_dw.py:
# bfloat16's tensor-core blocks gain from more blocks an SM, float32's from
# longer strips).
STRIPS = {2: (128,), 4: (1024, 512, 256, 128)}
CHAIN = 512        # most voxels a lane sums in float32 before the partials
MIN_BLOCKS = 528   # 4 blocks of 9 warps for each of an H100's 132 SMs
MAX_SHARED = 232448
# The plan's entries csrc/shallow_dw.cu takes, in its argument order.
_PLAN_ARGS = ("t1", "t2", "groups", "s_tile", "t_tile", "sb", "sg",
              "base_words", "gath_words", "smem_bytes")


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
                       k: int) -> torch.Tensor:
    """The 3D stride-1 conv's dW by the merged (D, C) fold, as the JAX
    `_dw_merged_3d`: pad x, fold (D, C) of both operands into one feature
    axis, take the 2D weight gradient M of the merged conv, and read dW off
    its band, dw[kh, kw, kd, ci, co] = sum_q M[kh, kw, (q + kd, ci), (q, co)].
    x (N, H, W, D, C), dy (N, H, W, D, Co) -> (k, k, k, C, Co) in
    promote(x.dtype, float32)."""
    b, h, w, d, c = x.shape
    co = dy.shape[-1]
    acc = _acc_dtype(x.dtype)
    xp = F.pad(x, (0, 0) + (pad, pad) * 3)
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
    -> (*k, Ci, Co) in the JAX tap order, in promote(x.dtype, float32)."""
    nd = x.ndim - 2
    p = (k - 1) // 2
    pad_hi = k - stride - p
    if pad_hi < 0:
        raise ValueError(f"unsupported (k, s) = ({k}, {stride})")
    acc = _acc_dtype(x.dtype)
    spatial = tuple(range(1, nd + 1))
    # Batch Co, features N; the kernel (Ci, N, *S).
    lhs = dy.to(acc).permute(nd + 1, 0, *spatial)
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


# ------------------------------------------------------------ the kernel
def tiles(cin: int, cout: int, bf16: bool = False):
    """(S, T): the kernel's Cout and Cin tiles (csrc/shallow_dw.cu): in
    float32 S is Cout rounded up to 4, 8, 10 or 16 and T * S <= 128
    accumulators a lane; bfloat16 takes 16 x 16 on the tensor cores."""
    if bf16:
        return 16, 16
    s = 4 if cout <= 4 else 8 if cout <= 8 else 10 if cout <= 10 else 16
    return s, {4: 16, 8: 12, 10: 10, 16: 8}[s]


def _row_words(tile: int, bf16: bool) -> int:
    """Words of a shared row: float32 rows read as float2 by consecutive
    lanes, their stride keeping a half-warp on distinct banks; bfloat16
    rows of 16 values (8 words) at the stride of 12 that `ldmatrix` reads
    without conflicts."""
    if bf16:
        return 12
    return tile + 2 if tile % 4 == 0 else tile


def dw_plan(n: int, spatial, cin: int, cout: int, transposed: bool,
            itemsize: int = 4, k: int = 3) -> dict:
    """The kernel's geometry for x of (n, *spatial, cin) and a k-tap kernel,
    its one copy (csrc/shallow_dw.cu checks it): strips of t1 columns of w
    by t2 depths (all of d where a column fits) about STRIPS[itemsize]
    voxels (the first whose shared memory fits a block), G groups of strips
    (enough that a lane's float32 chain is at most CHAIN voxels and the grid
    has MIN_BLOCKS), the tiles, the shared rows and buffers, the workspaces'
    element counts (dW's partials float32, db's float64) and the shared
    memory a block takes."""
    for strip in STRIPS[itemsize]:
        plan = _plan(n, spatial, cin, cout, transposed, itemsize, strip, k)
        if plan["smem_bytes"] <= MAX_SHARED:
            break
    return plan


def _plan(n, spatial, cin, cout, transposed, itemsize, strip, k):
    nd = len(spatial)
    e0, e1 = spatial[0], spatial[1]
    e2 = spatial[2] if nd == 3 else 1
    s = 2 if transposed else 1
    s2 = s if nd == 3 else 1
    bf16 = itemsize == 2
    s_tile, t_tile = tiles(cin, cout, bf16)
    n_s, n_t = -(-cout // s_tile), -(-cin // t_tile)
    taps1, taps2 = k, (k if nd == 3 else 1)
    taps = k * taps1 * taps2
    tb0 = 1 if nd == 3 else 3
    chunks = -(-tb0 * taps1 * taps2 // 9)  # blocks of 9 warps an h tap
    if e2 <= strip:
        t2, t1 = e2, max(1, min(e1, strip // e2))
    else:  # a column of d does not fit: d in equal tiles
        t1, t2 = 1, -(-e2 // -(-e2 // strip))
    qtot = n * e0 * -(-e1 // t1) * -(-e2 // t2)
    per_lane = -(-t1 * t2 // 32)  # voxels a lane takes from one strip
    blocks_x = k // tb0 * chunks * n_t * n_s
    groups = max(-(-qtot // max(1, CHAIN // per_lane)),
                 -(-MIN_BLOCKS // blocks_x))
    groups = min(groups, qtot, 65535)
    w2 = s2 * (t2 - 1) + taps2
    r1max = s * (t1 - 1) + taps1
    tile_b, tile_g = (t_tile, s_tile) if transposed else (s_tile, t_tile)
    sb, sg = _row_words(tile_b, bf16), _row_words(tile_g, bf16)
    base_words = -(-t1 * t2 * sb // 4) * 4
    gath_words = -(-tb0 * r1max * w2 * sg // 4) * 4
    cip, cop = n_t * t_tile, n_s * s_tile
    return {"strip": strip, "k": k, "s_tile": s_tile, "t_tile": t_tile,
            "t1": t1, "t2": t2, "groups": groups, "sb": sb, "sg": sg,
            "base_words": base_words, "gath_words": gath_words,
            "blocks": blocks_x * groups, "chain": per_lane * -(-qtot // groups),
            "part_elems": groups * taps * cip * cop,
            "dbpart_elems": groups * taps * cop,
            "smem_bytes": 2 * (base_words + gath_words) * 4
            + (48 if bf16 else 0) + 9 * 32 * (8 if bf16 else s_tile) * 8}


def dw_work(n: int, spatial, cin: int, cout: int, transposed: bool,
            k: int = 3):
    """(FLOP, bytes) the weight gradient needs: 2 * Cin * Cout for each
    (voxel, tap) pair whose taps all fall inside the tensor, plus db's
    additions; x and dy read once, dW and db written once (4-byte values;
    scale the bytes for bfloat16)."""
    pairs = n
    p = (k - 1) // 2
    for e in spatial:
        # conv: the taps of x at o + t - p inside [0, e): k e - p (p + 1)
        # per axis; transposed (k = 3): dy at 2i - 1 + t inside [0, 2e):
        # 3e - 1.
        pairs *= 3 * e - 1 if transposed else k * e - p * (p + 1)
    vox = n * math.prod(spatial)
    out_vox = vox * (2 ** len(spatial) if transposed else 1)
    flop = 2 * pairs * cin * cout + out_vox * cout
    nbytes = 4 * (vox * cin + out_vox * cout
                  + k ** len(spatial) * cin * cout + cout)
    return flop, nbytes


def shallow_dw_plain(x: torch.Tensor, dy: torch.Tensor, transposed: bool,
                     kernel_size: int = 3, stride=None, pad=None):
    """`shallow_dw`'s plain version on any device: the JAX formulation
    (`convt_dw_plain` or `dw_merged_3d_plain`) in torch's weight layout and
    x's type, and db summed in float32."""
    s = (2 if transposed else 1) if stride is None else stride
    p = (kernel_size - 1) // 2 if pad is None else pad
    xv, dv = _nhwc(x), _nhwc(dy)
    if transposed:
        dw = convt_dw_plain(xv, dv, s, kernel_size)
    else:
        dw = dw_merged_3d_plain(xv, dv, p, kernel_size)
    return _torch_layout(dw, transposed).to(x.dtype), _bias_grad_plain(dv)


def shallow_dw(x: torch.Tensor, dy: torch.Tensor, transposed: bool,
               kernel_size: int = 3, stride=None, pad=None):
    """(dW, db) of a routed conv from its input x (N, Cin, *S) and output
    gradient dy (N, Cout, *S'), dW in torch's weight layout and x's type,
    db in dy's. A CPU tensor takes `shallow_dw_plain`; a CUDA tensor
    launches csrc/shallow_dw.cu (every conv `smallc_supported` routes: the
    stride-1 3D conv with an odd kernel and pad (k-1)//2, the k=3, s=2
    transposed conv in 2D and 3D) or raises."""
    nd = x.ndim - 2
    if x.dtype != dy.dtype or x.device != dy.device:
        raise TypeError(f"x {x.dtype} on {x.device}, dy {dy.dtype} on "
                        f"{dy.device}")
    if x.device.type == "cpu":
        return shallow_dw_plain(x, dy, transposed, kernel_size, stride, pad)
    k = kernel_size
    s = (2 if transposed else 1) if stride is None else stride
    p = (k - 1) // 2 if pad is None else pad
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel wants float32 or bfloat16, got {x.dtype}")
    n, cin, *spatial = x.shape
    cout = dy.shape[1]
    want = [e * (2 if transposed else 1) for e in spatial]
    routed = (k == 3 and s == 2 and p == 1 and nd in (2, 3)) if transposed \
        else (nd == 3 and s == 1 and k % 2 == 1 and p == (k - 1) // 2)
    if not routed or list(dy.shape[2:]) != want or dy.shape[0] != n:
        raise ValueError(
            "kernel takes k=3 s=2 transposed convs and stride-1 3D convs of "
            f"odd k, pad (k-1)//2; got {'transposed ' if transposed else ''}"
            f"k={k}, stride {s}, pad {p}, x {tuple(x.shape)}, dy "
            f"{tuple(dy.shape)}")
    xv, dv = _nhwc(x), _nhwc(dy)
    if x.dtype == torch.bfloat16 and (cin % 2 or cout % 2 or xv.data_ptr() % 4
                                      or dv.data_ptr() % 4):
        # The kernel reads bfloat16 rows by 4-byte pairs. A bfloat16
        # product is exact in float32, so the float32 kernel on the widened
        # values computes the same sums.
        dw, db = shallow_dw(x.float(), dy.float(), transposed, k)
        return dw.to(x.dtype), db.to(x.dtype)
    plan = dw_plan(n, spatial, cin, cout, transposed, x.element_size(), k)
    if plan["smem_bytes"] > MAX_SHARED:
        raise ValueError(f"kernel does not take x {tuple(x.shape)}, k={k}: a "
                         f"strip needs {plan['smem_bytes']} bytes of shared "
                         "memory")
    w_shape = (cin, cout, *(k,) * nd) if transposed else \
        (cout, cin, *(k,) * nd)
    dw = torch.empty(w_shape, dtype=x.dtype, device=x.device)
    db = torch.empty(cout, dtype=x.dtype, device=x.device)
    part = torch.empty(plan["part_elems"], dtype=torch.float32,
                       device=x.device)
    dbpart = torch.empty(plan["dbpart_elems"], dtype=torch.float64,
                         device=x.device)
    e = list(spatial) + [1] * (3 - nd)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ctseg_shallow_dw(
        xv.data_ptr(), dv.data_ptr(), part.data_ptr(), dbpart.data_ptr(),
        dw.data_ptr(), db.data_ptr(), n, e[0], e[1], e[2], cin, cout, nd,
        int(transposed), k, *(plan[key] for key in _PLAN_ARGS),
        plan["part_elems"], plan["dbpart_elems"], _DTYPE_CODES[x.dtype],
        x.device.index, stream)
    lib.check(err, "shallow_dw")
    shallow_dw.launches += 1
    return dw, db


shallow_dw.launches = 0  # kernel calls (main + finalize launch) since reset


# ------------------------------------------------------------ the Functions
def _tuple(v, nd):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * nd


class ConvSmallC(torch.autograd.Function):
    """F.conv{2,3}d(x, w, b, stride, pad) whose dW and db come from
    `shallow_dw` in 3D (the library's dW in 2D, as the JAX rule keeps
    XLA's) and dx from cuDNN."""

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
            if set(stride) != {1} or len(set(pad)) != 1:
                raise ValueError(f"stride {stride}, pad {pad}: not a routed "
                                 "conv")
            dw, db = shallow_dw(x, dy, False, w.shape[-1], 1, pad[0])
        elif need_b:
            db = _bias_grad_plain(dy.movedim(1, -1))
        return (dx, dw.to(w.dtype) if need_w else None,
                db if need_b else None, None, None)


class ConvTransposeSmallC(torch.autograd.Function):
    """F.conv_transpose{2,3}d(x, w, b, stride, (k-1)//2, stride-1) whose dW
    and db come from `shallow_dw` and dx from cuDNN."""

    @staticmethod
    def forward(ctx, x, w, b, stride, kernel_size):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, kernel_size)
        return _CONV_T_FN[x.ndim](x, w, b, stride, (kernel_size - 1) // 2,
                                  stride - 1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        stride, k = ctx.conf
        nd = x.ndim - 2
        dx = dw = db = None
        if need_x:
            dx = torch.ops.aten.convolution_backward(
                dy, x, w, None, (stride,) * nd, ((k - 1) // 2,) * nd,
                (1,) * nd, True, (stride - 1,) * nd, 1,
                [True, False, False])[0]
        if need_w or need_b:
            dw, db = shallow_dw(x, dy, True, k, stride)
        return (dx, dw.to(w.dtype) if need_w else None,
                db if need_b else None, None, None)


def conv_smallc(x, w, b, stride, pad):
    """x (N, Cin, *S), torch weight (Cout, Cin, *k), bias (Cout,): the conv
    with the shallow weight gradient (stride 1, odd k, pad (k-1)//2)."""
    return ConvSmallC.apply(x, w, b, stride, pad)


def conv_transpose_smallc(x, w, b, stride, kernel_size):
    """x (N, Cin, *S), torch weight (Cin, Cout, *k), bias (Cout,): the
    transposed conv (out = in * stride) with the shallow weight gradient."""
    return ConvTransposeSmallC.apply(x, w, b, stride, kernel_size)
