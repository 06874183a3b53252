"""The stride-1 conv's weight-gradient kernel, csrc/shallow_dw.cu, on the CPU:
its plan (ops/shallow_grad.py::dw_plan) and its arithmetic, emulated in
numpy (the kernel itself runs on the card, chip_smoke.py phase 16b).

  - The plan at the bench_3d site, at SHALLOW_ROUTED's stride-1 cases, at
    depths 1 to 64, k in {1, 3, 5, 7} and odd channels, both types: an H100
    block's and SM's shared memory, a computing thread's registers, the
    grid, and what the C entry checks; at the bench_3d site two blocks an
    SM, one role (all 27 taps), every plane staged once.
  - `emulate_dw`: the kernel's walk (blocks of a run of columns, a segment
    of h and a role; the ring of x and dy planes, zero outside the tensor;
    float32 lanes on taps and voxel slots, bfloat16 warps on taps and
    k-step slices of 16 voxels with db as a tap of ones; the blocks' and the
    finalize's sums) in numpy float64, held to `dw_merged_3d_plain` and to
    `jax.vjp` of the JAX `conv_smallc` at float32 round-off, whole walks
    and segments, ragged runs, several Cin and Cout tiles and tap groups,
    and bfloat16 with odd channels (which the kernel stages by 2-byte
    copies).
  - On a CPU tensor `shallow_dw` is the plain version and builds nothing.
  - csrc/tools/variants_shallow_dw.py's stride-1 edits still match the
    kernel, and the plan's constants are the kernel's.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctseg_tpu.ops.shallow_grad as jax_sg
from ctseg_tpu_torch.ops import _build
from ctseg_tpu_torch.ops import shallow_grad as sg

CSRC = Path(sg.__file__).resolve().parent.parent / "csrc"
REGS = 255            # registers a thread
REG_FILE = 65536      # registers an SM


def kernel_constant(name):
    found = re.search(rf"constexpr (?:int|uint32_t) {name} = (\w+);",
                      (CSRC / "shallow_dw.cu").read_text())
    assert found, name
    return int(found.group(1), 0)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).movedim(-1, 1)


def assert_dw_plan_holds_the_kernel(plan, n, spatial, cin, cout, itemsize,
                                    k):
    """What csrc/shallow_dw.cu's C entry checks of the plan, and the H100's
    limits it must keep."""
    bf16 = itemsize == 2
    e0, e1, e2 = spatial
    p, taps = (k - 1) // 2, k ** 3
    assert plan["k"] == k
    s, t = plan["s_tile"], plan["t_tile"]
    assert (s, t) == sg.tiles(cin, cout, bf16)
    assert (s, t) == (16, 16) if bf16 else \
        (s, t) in ((4, 16), (8, 12), (10, 10), (16, 8))
    assert s >= min(cout, 16) and t * s <= (256 if bf16 else 128)
    tg = plan["tg"]
    assert 1 <= tg <= min(taps, sg.TAPS_BF16 if bf16 else sg.TAPS_F32)
    roles = -(-taps // tg) * -(-cin // t) * -(-cout // s)
    assert plan["roles"] == roles
    t1, hs = plan["t1"], plan["hs"]
    assert 1 <= t1 <= e1 and 1 <= hs <= e0
    assert plan["nseg"] == -(-e0 // hs)
    assert plan["stages"] >= 2 * p + 2  # k planes a step reads, one staged
    sx, sdy = plan["sx"], plan["sdy"]
    if bf16:  # 16 values at 48 bytes: ldmatrix without bank conflicts
        assert sx == sdy == sg.ROW_WORDS_BF16 == 12
    else:  # float2 loads of 16 rows fall on distinct banks
        assert sx >= t and sx % 4 == 2 and sdy >= s and sdy % 4 == 2
    dp = e2 + 2 * p
    assert plan["x_words"] % 4 == plan["slot_words"] % 4 == 0
    assert plan["x_words"] >= (t1 + 2 * p) * dp * sx
    dy_rows = -(-t1 * e2 // 16) * 16 if bf16 else t1 * e2
    assert plan["slot_words"] >= plan["x_words"] + dy_rows * sdy
    ring = plan["stages"] * plan["slot_words"] + (sg.ONES_WORDS if bf16
                                                  else 0)
    w = kernel_constant("kWarps")
    assert w == sg.S1_WARPS
    red = w * 8 * 256 if bf16 else 32 * w * (t * s + 2)
    bar = -(-max(ring, red) // 4) * 4
    smem = plan["smem_bytes"]
    assert smem == bar * 4 + 16 * plan["stages"] <= sg.MAX_SHARED
    blocks = n * plan["nseg"] * -(-e1 // t1) * roles
    assert plan["blocks"] == blocks < 2 ** 31
    assert plan["part_elems"] >= blocks * tg * t * s
    assert plan["dbpart_elems"] >= blocks * s
    # Registers: the stagers at kStagerRegs and the computing threads at
    # kConsumerRegs within an SM's file (one block an SM). A computing
    # thread holds float32's T x S accumulators and one voxel's operands
    # twice (the loop unrolled by 2), or bfloat16's 8 taps' fresh and
    # running sums (8 each) with a dy and an x fragment.
    stager, consumer = (kernel_constant("kStagerRegs"),
                        kernel_constant("kConsumerRegs"))
    assert kernel_constant("kStagers") * stager + \
        32 * w * consumer <= REG_FILE
    assert consumer % 8 == stager % 8 == 0 and consumer <= REGS
    held = 8 * 16 + 8 if bf16 else t * s + 2 * (t + s)
    assert held + 32 <= consumer


# The bench_3d site, SHALLOW_ROUTED's stride-1 cases (chip_smoke.py) and
# shapes past them: (n, spatial, cin, cout, k).
S1_SITES = {
    "bench_3d 10 -> 10 conv": (128, (128, 128, 16), 10, 10, 3),
    "k=5 conv 10 -> 10 at depth 64": (2, (32, 32, 64), 10, 10, 5),
    "k=1 conv 16 -> 8 at depth 64": (2, (32, 32, 64), 16, 8, 1),
    "k=3 conv 7 -> 7 (odd channels)": (2, (16, 16, 8), 7, 7, 3),
    "phase 18 16 -> 16": (2, (32, 32, 8), 16, 16, 3),
    "depth 1": (3, (9, 6, 1), 10, 10, 3),
    "depth 63, odd Cin": (1, (12, 10, 63), 13, 10, 3),
    "depth 64, k=7": (1, (8, 8, 64), 16, 16, 7),
    "k=5, Cin 40 -> 20": (2, (8, 9, 5), 40, 20, 5),
    "Cout 3, Cin 128": (2, (16, 16, 16), 128, 3, 3),
}


@pytest.mark.parametrize("site", list(S1_SITES))
@pytest.mark.parametrize("itemsize", [4, 2])
def test_the_stride1_plan_at_the_sites(site, itemsize):
    n, spatial, cin, cout, k = S1_SITES[site]
    plan = sg.dw_plan(n, spatial, cin, cout, itemsize, k)
    assert plan["strip"] in sg.STRIPS[itemsize]
    assert_dw_plan_holds_the_kernel(plan, n, spatial, cin, cout, itemsize, k)
    flop, nbytes = sg.dw_work(n, spatial, cin, cout, False, k)
    assert 0 < flop <= 2 * n * np.prod(spatial) * k ** 3 * cin * cout + \
        n * np.prod(spatial) * cout and nbytes > 0


@pytest.mark.parametrize("depth", [1, 2, 5, 8, 16, 17, 31, 32, 48, 63, 64])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_the_stride1_plan_at_every_depth(depth, k):
    for itemsize in (4, 2):
        plan = sg.dw_plan(2, (24, 20, depth), 10, 10, itemsize, k)
        assert_dw_plan_holds_the_kernel(plan, 2, (24, 20, depth), 10, 10,
                                        itemsize, k)


def test_the_main_site_plan_stages_each_plane_once_for_all_taps():
    """At bench_3d's 10 -> 10 conv a block holds every tap (one role) and
    walks all 128 rows of h (no segment re-stages a plane) over runs of 32
    whole columns (512 voxels a step) through a ring of 4 slots."""
    n, spatial, cin, cout, k = S1_SITES["bench_3d 10 -> 10 conv"]
    for itemsize in (4, 2):
        plan = sg.dw_plan(n, spatial, cin, cout, itemsize, k)
        assert plan["roles"] == 1 and plan["tg"] == 27
        assert plan["nseg"] == 1 and plan["hs"] == 128
        assert plan["t1"] * spatial[2] == plan["strip"] == 512
        assert plan["smem_bytes"] <= sg.MAX_SHARED
        assert plan["blocks"] == 128 * 4 and plan["stages"] == 4


# ------------------------------------------------------ the kernel in numpy
def emulate_dw(x, dy, plan, bf16=False):
    """csrc/shallow_dw.cu's walk in numpy float64. x (n, *S, cin), dy (n,
    *S, cout) -> dW in torch's (cout, cin, k, k, k) layout, db."""
    n, e0, e1, e2, cin = x.shape
    cout = dy.shape[-1]
    k = plan["k"]
    p, taps = (k - 1) // 2, k ** 3
    tg, tt, st = plan["tg"], plan["t_tile"], plan["s_tile"]
    n_ct, n_cot = -(-cin // tt), -(-cout // st)
    roles = -(-taps // tg) * n_ct * n_cot
    t1, hs, stages = plan["t1"], plan["hs"], plan["stages"]
    nw1, nseg = -(-e1 // t1), -(-e0 // hs)
    dp, xcols = e2 + 2 * p, t1 + 2 * p
    dy_rows = -(-t1 * e2 // 16) * 16 if bf16 else t1 * e2
    units = n * nseg * nw1
    W = sg.S1_WARPS  # the computing warps
    part = np.zeros((units * roles, tg, tt, st))
    dbpart = np.zeros((units * roles, st))
    for blk in range(units * roles):
        role, rest = blk % roles, blk // roles
        wc, rest = rest % nw1, rest // nw1
        seg, nn = rest % nseg, rest // nseg
        cot, ct, tgi = role % n_cot, (role // n_cot) % n_ct, \
            role // (n_cot * n_ct)
        w0 = wc * t1
        t1c = min(t1, e1 - w0)
        nq = t1c * e2
        h_lo = seg * hs
        n_items = min(hs, e0 - h_lo) + 2 * p
        ci0, co0 = ct * tt, cot * st
        cinw, cow = min(tt, cin - ci0), min(st, cout - co0)
        tgr = min(tg, taps - tgi * tg)
        db = role < n_cot
        # The ring, zeroed when the block starts; the stagers write only the
        # columns inside the tensor and the strip's dy rows.
        ring_x = np.zeros((stages, xcols * dp, tt))
        ring_dy = np.zeros((stages, dy_rows, st))
        c_lo, c_hi = max(0, p - w0), min(t1c + 2 * p, e1 - w0 + p)
        v = np.arange(nq)
        vrow = (v // e2) * dp + v % e2  # a voxel's x row at tap (0, 0)
        if bf16:
            nwt = 4 if tg >= 4 else 2 if tg >= 2 else 1
            slices, tpw = W // nwt, -(-tg // nwt)
            acc = np.zeros((W, 8, tt, st))
        else:
            slots = 32 // tg
            acc = np.zeros((W, 32, tt, st))
            dgs = 32 * W // st
            dbacc = np.zeros((dgs, st))
        for i in range(n_items):
            s = i % stages
            m = h_lo - p + i
            for c in range(c_lo, c_hi):
                rows = c * dp + p + np.arange(e2)
                ring_x[s, rows] = 0.0
                if 0 <= m < e0:
                    ring_x[s, rows, :cinw] = \
                        x[nn, m, w0 - p + c, :, ci0:ci0 + cinw]
            if i < 2 * p:
                continue
            h = h_lo + i - 2 * p
            ring_dy[s, :nq, :cow] = dy[nn, h, w0:w0 + t1c, :,
                                       co0:co0 + cow].reshape(nq, cow)
            dys = ring_dy[s]

            def x_of(tap, rows):
                kh, kw, kd = tap // (k * k), (tap // k) % k, tap % k
                return ring_x[(i - 2 * p + kh) % stages][
                    rows + kw * dp + kd]

            if bf16:
                nk = -(-nq // 16)
                for w in range(W):
                    wt, sl = w % nwt, w // nwt
                    nt = max(0, min(tgr - wt * tpw, tpw))
                    for ks in range(sl, nk, slices):
                        q = np.arange(ks * 16, ks * 16 + 16)
                        a_rows = vrow[np.minimum(q, nq - 1)]
                        b = dys[q]  # zero rows past the strip
                        for t in range(nt):
                            acc[w, t] += x_of(tgi * tg + wt * tpw + t,
                                              a_rows).T @ b
                        if db and wt == nwt - 1:  # the tap of ones
                            acc[w, nt] += np.ones((16, tt)).T @ b
            else:
                for lane in range(32):
                    j = min(lane // tg, slots - 1)
                    t = min(lane % tg, tgr - 1)
                    for w in range(W):
                        vs = np.arange(w * slots + j, nq, W * slots)
                        acc[w, lane] += x_of(tgi * tg + t, vrow[vs]).T @ \
                            dys[vs]
                if db:
                    for dg in range(dgs):
                        dbacc[dg] += dys[dg:nq:dgs].sum(0)
        # The block's sums: float32 over warps and voxel slots, bfloat16
        # over k-step slices; db from its thread groups or the tap of ones.
        for t in range(tgr):
            if bf16:
                part[blk, t] = sum(acc[w, t % tpw]
                                   for w in range(t // tpw, W, nwt))
            else:
                part[blk, t] = sum(acc[w, j * tg + t] for w in range(W)
                                   for j in range(slots))
        if db:
            if bf16:
                slot = max(0, min(tgr - (nwt - 1) * tpw, tpw))
                dbpart[blk] = sum(acc[w, slot, 0]
                                  for w in range(nwt - 1, W, nwt))
            else:
                dbpart[blk] = dbacc.sum(0)
    # The finalize: each output over its role's blocks in block order.
    dw = np.zeros((cout, cin) + (k,) * 3)
    for tap in range(taps):
        kidx = np.unravel_index(tap, (k,) * 3)
        for ci in range(cin):
            for co in range(cout):
                role = ((tap // tg) * n_ct + ci // tt) * n_cot + co // st
                dw[(co, ci) + kidx] = part[role::roles, tap % tg, ci % tt,
                                           co % st].sum()
    dbo = np.array([dbpart[co // st::roles, co % st].sum()
                    for co in range(cout)])
    return dw, dbo


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).double().numpy()


EMULATED = {  # (N, *spatial), cin, cout, k, itemsize, strip, min_blocks
    "f32 k=3, whole walk": ((2, 5, 7, 3), 3, 4, 3, 4, 8, 1),
    "f32 k=3, segments of 2, ragged run": ((1, 5, 7, 4), 5, 6, 3, 4, 8, 8),
    "f32 k=3, a step a block": ((2, 3, 4, 5), 10, 10, 3, 4, 256, None),
    "f32 k=1, voxel slots": ((2, 4, 3, 6), 16, 8, 1, 4, 8, 1),
    "f32 k=5, tap groups": ((1, 4, 5, 3), 2, 3, 5, 4, 16, 1),
    "f32 Cin and Cout tiles": ((1, 3, 4, 2), 20, 18, 3, 4, 8, 1),
    "bf16 k=3, whole walk": ((2, 5, 7, 3), 10, 10, 3, 2, 8, 1),
    "bf16 k=3, ragged k-steps": ((1, 4, 5, 7), 4, 6, 3, 2, 14, 4),
    "bf16 odd channels 7 -> 7": ((2, 4, 4, 3), 7, 7, 3, 2, 8, 1),
    "bf16 k=1, k-step slices": ((2, 3, 4, 8), 16, 8, 1, 2, 16, 1),
    "bf16 k=5, tap groups": ((1, 4, 4, 4), 3, 5, 5, 2, 16, 1),
    "bf16 Cin and Cout tiles": ((1, 3, 3, 2), 20, 17, 3, 2, 8, 1),
}


@pytest.mark.parametrize("case", list(EMULATED))
def test_the_kernels_walk_makes_the_weight_gradient(monkeypatch, case):
    """The numpy emulation of csrc/shallow_dw.cu equals the plain version
    (the JAX rule's merged fold) and jax.vjp of the JAX conv_smallc at
    float32 round-off; bfloat16 cases on bfloat16-rounded inputs."""
    shape, cin, cout, k, itemsize, strip, min_blocks = EMULATED[case]
    monkeypatch.setattr(sg, "STRIPS", {itemsize: (strip,)})
    if min_blocks is not None:
        monkeypatch.setattr(sg, "MIN_BLOCKS", min_blocks)
    rng = np.random.default_rng(8)
    x = rng.standard_normal(shape + (cin,))
    dy = rng.standard_normal(shape + (cout,))
    bf16 = itemsize == 2
    if bf16:
        x, dy = _bf16(x), _bf16(dy)
    plan = sg.dw_plan(shape[0], shape[1:], cin, cout, itemsize, k)
    assert plan["strip"] == strip
    assert_dw_plan_holds_the_kernel(plan, shape[0], shape[1:], cin, cout,
                                    itemsize, k)
    if min_blocks == 1:
        assert plan["hs"] == shape[1]  # the whole walk through the ring
    dw, db = emulate_dw(x, dy, plan, bf16)

    pdw, pdb = sg.shallow_dw(_nchw(x), _nchw(dy), False, k)
    np.testing.assert_allclose(dw, pdw.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(db, pdb.numpy(), rtol=1e-10, atol=1e-10)
    # jax.vjp of the JAX conv in float32: its (*k, ci, co) weight is
    # torch's transposed.
    w = rng.standard_normal((k,) * 3 + (cin, cout)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda x_, w_, b_: jax_sg.conv_smallc(x_, w_, b_, 1, (k - 1) // 2),
        jnp.asarray(x, jnp.float32), jnp.asarray(w),
        jnp.zeros(cout, jnp.float32))
    _, jdw, jdb = vjp(jnp.asarray(dy, jnp.float32))
    want = np.moveaxis(np.asarray(jdw, np.float64), (3, 4), (1, 0))
    assert np.linalg.norm(dw - want) <= 1e-5 * np.linalg.norm(want)
    assert np.linalg.norm(db - np.asarray(jdb)) <= 1e-5 * np.linalg.norm(db)


def test_the_kernel_is_not_built_for_a_cpu_tensor(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor built the kernels")

    monkeypatch.setattr(_build, "library", no_library)
    x = torch.randn(1, 7, 3, 4, 5, dtype=torch.bfloat16)
    dy = torch.randn(1, 7, 3, 4, 5, dtype=torch.bfloat16)
    before = sg.shallow_dw.launches
    dw, db = sg.shallow_dw(x, dy, False, 3)  # odd bfloat16 channels
    pdw, pdb = sg.shallow_dw_plain(x, dy, False, 3)
    assert torch.equal(dw, pdw) and torch.equal(db, pdb)
    assert dw.dtype == torch.bfloat16 and sg.shallow_dw.launches == before


@pytest.mark.parametrize("variant", ["staging only", "compute only",
                                     "no db", "unroll 2", "unroll 16"])
def test_the_variants_tools_stride1_edits_match_the_kernel(variant):
    """csrc/tools/variants_shallow_dw.py --map stride1 times csrc/
    shallow_dw.cu built from text edits; each edit must still find its text
    exactly once."""
    spec = importlib.util.spec_from_file_location(
        "variants_shallow_dw", CSRC / "tools" / "variants_shallow_dw.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert set(tool.S1_VARIANTS) == {"this tree", "staging only",
                                     "compute only", "no db", "unroll 2",
                                     "unroll 16"}
    edits = tool.S1_VARIANTS[variant]
    assert edits and tool.edited(variant, edits, source=tool.S1_SOURCE) != (
        CSRC / tool.S1_SOURCE).read_text()


def test_the_stride1_plan_constants_are_the_kernels():
    for name, value in (("kMaxShared", sg.MAX_SHARED),
                        ("kMaxTapsF32", sg.TAPS_F32),
                        ("kMaxTapsBf16", sg.TAPS_BF16),
                        ("kRowWordsBf16", sg.ROW_WORDS_BF16)):
        assert kernel_constant(name) == value, name
    # A bfloat16 role's taps leave the last of 4 warps of kTapsPerWarp a
    # slot for db.
    assert sg.TAPS_BF16 < 4 * kernel_constant("kTapsPerWarp")
    assert sg.TAPS_F32 == 32  # a warp's lanes
