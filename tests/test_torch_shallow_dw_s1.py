"""The stride-1 conv's weight-gradient kernel, csrc/shallow_dw.cu, on the CPU:
its plan (ops/shallow_grad.py::dw_plan) and its arithmetic, emulated in
numpy (the kernel itself runs on the card, chip_smoke.py phase 16b).

  - The plan at the bench_3d site, at SHALLOW_ROUTED's stride-1 cases and
    over every routed conv: odd k 1-15 (17 and 21 at small extents),
    depths 1-64, H and W in {1, 8, 64, 256}, channel pairs with
    min(Cin, Cout) <= 16, both types; an H100 block's and SM's shared
    memory, a computing thread's registers, the grid and the workspaces
    under the plan's constants, and what the C entry checks; at the
    bench_3d site one role of all 27 taps, every plane staged once.
  - `emulate_dw`: the kernel's walk (blocks of a role walking units of a
    run of columns, a depth tile and a segment of h, several units a block
    where the grid is bounded, the roles in several launches past it; tap
    groups of lines of k^3 or k^2 taps; the ring of x and dy planes, every
    row written, zero outside the tensor; float32 lanes on taps and voxel
    slots, bfloat16 warps on taps and k-step slices of 16 voxels with db as
    a tap of ones; the blocks' and the finalize's sums) in numpy float64, held
    to `dw_merged_3d_plain` and to `jax.vjp` of the JAX `conv_smallc` at
    float32 round-off: whole walks and segments, ragged runs and depth
    tiles, several Cin and Cout tiles and tap groups, k larger than the
    extents (taps on padding alone come out exactly 0), and bfloat16 with
    odd channels (which the kernel stages by 2-byte copies).
  - A UNet with kernel_size=9 whose routed convs' gradients equal the JAX
    model's on the CPU.
  - On a CPU tensor `shallow_dw` is the plain version and builds nothing.
  - csrc/tools/variants_shallow_dw.py's stride-1 edits still match the
    kernel, and the plan's constants are the kernel's.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctseg_tpu.ops.shallow_grad as jax_sg
from ctseg_tpu.models.unet import UNet as JaxUNet
from ctseg_tpu_torch.models import layers
from ctseg_tpu_torch.models.jax_import import state_dict_from_jax_params
from ctseg_tpu_torch.models.unet import SegmentationModel, UNet
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


def group_taps(k, tl, tg, tgi):
    """The taps of tap group tgi: a run of tg taps of line tgi // (groups a
    line), lines of tl taps in (kh, kw, kd) order."""
    gpl = -(-tl // tg)
    first = tgi % gpl * tg
    tap0 = tgi // gpl * tl + first
    return range(tap0, tap0 + min(tg, tl - first))


@functools.lru_cache(maxsize=None)
def groups_fit_their_planes(k, tl, tg, hspan, wspan):
    """Each group of a line (every line alike) has its taps in its planes:
    kh and kw from the group's first staged ones (`sg.group_span`) within
    (hspan, wspan), any kd; the groups cover the line's taps once."""
    seen = []
    for tgi in range(-(-tl // tg)):
        group = group_taps(k, tl, tg, tgi)
        (h0, w0), _ = sg.group_span(k, group[0], len(group))
        for tap in group:
            kh, kw = divmod(tap // k, k)
            if not (0 <= kh - h0 < hspan and 0 <= kw - w0 < wspan):
                return False
        seen += list(group)
    return seen == list(range(tl))


def assert_dw_plan_holds_the_kernel(plan, n, spatial, cin, cout, itemsize,
                                    k):
    """What csrc/shallow_dw.cu's C entry checks of the plan, and the H100's
    limits and the plan's constants it must keep."""
    bf16 = itemsize == 2
    e0, e1, e2 = spatial
    taps = k ** 3
    assert plan["k"] == k
    s, t = plan["s_tile"], plan["t_tile"]
    assert (s, t) == sg.tiles(cin, cout, bf16)
    assert (s, t) == (16, 16) if bf16 else \
        (s, t) in ((4, 16), (8, 12), (10, 10), (16, 8))
    assert s >= min(cout, 16) and t * s <= (256 if bf16 else 128)
    tl, tg = plan["tl"], plan["tg"]
    assert tl in (k * k, taps) and k <= sg.MAX_K
    assert 1 <= tg <= min(tl, sg.TAPS_BF16 if bf16 else sg.TAPS_F32)
    gpl = -(-tl // tg)
    roles = taps // tl * gpl * -(-cin // t) * -(-cout // s)
    assert plan["roles"] == roles
    hspan, wspan = plan["hspan"], plan["wspan"]
    assert 1 <= min(hspan, wspan) and max(hspan, wspan) <= k
    assert groups_fit_their_planes(k, tl, tg, hspan, wspan)
    t1, td, hs = plan["t1"], plan["td"], plan["hs"]
    assert 1 <= t1 <= e1 and 1 <= td <= e2 and 1 <= hs <= e0
    assert plan["nseg"] == -(-e0 // hs)
    units = n * plan["nseg"] * -(-e1 // t1) * -(-e2 // td)
    assert plan["units"] == units
    assert plan["stages"] >= hspan + 1  # planes a step reads, one staged
    sx, sdy = plan["sx"], plan["sdy"]
    if bf16:  # 16 values at 48 bytes: ldmatrix without bank conflicts
        assert sx == sdy == sg.ROW_WORDS_BF16 == 12
    else:  # float2 loads of 16 rows fall on distinct banks
        assert sx >= t and sx % 4 == 2 and sdy >= s and sdy % 4 == 2
    dpx = td + k - 1  # a plane's column holds every kd
    assert plan["x_words"] % 4 == plan["slot_words"] % 4 == 0
    assert plan["x_words"] >= (t1 + wspan - 1) * dpx * sx
    dy_rows = -(-t1 * td // 16) * 16 if bf16 else t1 * td
    assert plan["slot_words"] >= plan["x_words"] + dy_rows * sdy
    ring = plan["stages"] * plan["slot_words"] + (sg.ONES_WORDS if bf16
                                                  else 0)
    w = kernel_constant("kWarps")
    assert w == sg.S1_WARPS
    red = w * 8 * 256 if bf16 else 32 * w * (t * s + 2)
    bar = -(-max(ring, red) // 4) * 4
    smem = plan["smem_bytes"]
    assert smem == bar * 4 + 16 * plan["stages"] <= sg.MAX_SHARED
    # The grid: at most MAX_GRID blocks a launch, `groups` blocks a role
    # (no more than the units) and rpl roles a launch; the workspaces one
    # launch's blocks'.
    groups, rpl = plan["groups"], plan["rpl"]
    assert 1 <= groups <= units and 1 <= rpl <= roles
    assert plan["launches"] == -(-roles // rpl)
    assert plan["blocks"] == groups * rpl <= sg.MAX_GRID == \
        kernel_constant("kMaxGrid")
    assert plan["part_elems"] >= groups * rpl * tg * t * s
    assert plan["dbpart_elems"] >= groups * rpl * s
    assert plan["part_elems"] <= sg.MAX_GRID * max(
        sg.TAPS_F32 * 128, sg.TAPS_BF16 * 256)
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
    "k=7 conv 4 -> 4 at depth 64": (2, (32, 32, 64), 4, 4, 7),
    "k=9 conv 10 -> 10 at depth 64": (2, (32, 32, 64), 10, 10, 9),
    "k=15 conv 10 -> 10 at depth 64": (1, (16, 16, 64), 10, 10, 15),
    "k=9 conv 4 -> 4, batch 32 (blocks walk several units)": (
        32, (8, 48, 16), 4, 4, 9),
    "k=9 conv 16 -> 1024 (roles in several launches)": (1, (4, 4, 4), 16,
                                                        1024, 9),
    "phase 18 16 -> 16": (2, (32, 32, 8), 16, 16, 3),
    "depth 1": (3, (9, 6, 1), 10, 10, 3),
    "depth 63, odd Cin": (1, (12, 10, 63), 13, 10, 3),
    "depth 64, k=7": (1, (8, 8, 64), 16, 16, 7),
    "k=5, Cin 40 -> 20": (2, (8, 9, 5), 40, 20, 5),
    "Cout 3, Cin 128": (2, (16, 16, 16), 128, 3, 3),
    "k=9 at bench_3d's shape": (128, (128, 128, 16), 10, 10, 9),
    "k=11 at batch 4 x 256 x 256 x 32": (4, (256, 256, 32), 10, 10, 11),
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


# Every conv the rule routes: channel pairs with min(Cin, Cout) <= 16, odd
# counts among them.
SWEEP_PAIRS = ((1, 1), (4, 4), (16, 4), (3, 7), (8, 8), (10, 10), (16, 16),
               (16, 1024), (64, 10))


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11, 13, 15, 17, 21])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_the_stride1_plan_takes_every_routed_conv(k, itemsize):
    """dw_plan finds a plan the kernel takes for every depth 1-64, H and W
    in {1, 8, 64, 256} (k 17 and 21: {1, 8}) and every channel pair of
    SWEEP_PAIRS, with shared memory, the grid and the workspaces under
    MAX_SHARED, MAX_GRID and MAX_GRID blocks' partials."""
    extents = (1, 8) if k > 15 else (1, 8, 64, 256)
    assert all(sg.smallc_supported(cin, cout, 1, k, depth=64)
               for cin, cout in SWEEP_PAIRS)
    for depth in range(1, 65):
        for h in extents:
            for w in extents:
                for cin, cout in SWEEP_PAIRS:
                    spatial = (h, w, depth)
                    plan = sg.dw_plan(2, spatial, cin, cout, itemsize, k)
                    assert_dw_plan_holds_the_kernel(plan, 2, spatial, cin,
                                                    cout, itemsize, k)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_the_routed_cases_loop_and_launch_in_chunks(itemsize):
    """SHALLOW_ROUTED's k = 9 4 -> 4 conv at batch 32 has more units than
    the bounded grid gives a role (its blocks walk several, ragged runs of
    w among them), its k = 9 16 -> 1024 conv more roles than MAX_GRID (they
    take several launches): chip_smoke.py asserts both on the card."""
    n, spatial, cin, cout, k = S1_SITES[
        "k=9 conv 4 -> 4, batch 32 (blocks walk several units)"]
    plan = sg.dw_plan(n, spatial, cin, cout, itemsize, k)
    assert plan["units"] > plan["groups"] and spatial[1] % plan["t1"]
    n, spatial, cin, cout, k = S1_SITES[
        "k=9 conv 16 -> 1024 (roles in several launches)"]
    plan = sg.dw_plan(n, spatial, cin, cout, itemsize, k)
    assert plan["roles"] > sg.MAX_GRID and plan["launches"] > 1


@pytest.mark.parametrize("itemsize", [4, 2])
def test_the_stride1_plan_fits_up_to_max_k(itemsize):
    """One column of 16 depths over a line of one kh (the plan's last
    resort) fits a block for every odd k up to MAX_K at the widest rows
    (float32's Cin tile of 16; bfloat16's 16 x 16), at any depth; float32
    at MAX_K + 2 does not, so MAX_K is the edge."""
    cin, cout = (16, 4) if itemsize == 4 else (16, 16)

    def fits(k, depth):
        return sg._plan(1, (1, 1, depth), cin, cout, itemsize, 16, k,
                        k * k)["smem_bytes"] <= sg.MAX_SHARED

    assert all(fits(k, d) for k in range(1, sg.MAX_K + 1, 2)
               for d in (1, 16, 64))
    assert fits(sg.MAX_K + 2, 64) == (itemsize == 2)


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
    *S, cout) -> dW in torch's (cout, cin, k, k, k) layout, db. Each output
    is written once. x may hold 2 (p - pd) more rows than dy along D (a
    depth slab with its halo rows: the depth padding pd 0)."""
    n, e0, e1, xd, cin = x.shape
    e2, cout = dy.shape[3], dy.shape[-1]
    k = plan["k"]
    p, taps = (k - 1) // 2, k ** 3
    pd = p - (xd - e2) // 2
    tl, tg, tt, st = plan["tl"], plan["tg"], plan["t_tile"], plan["s_tile"]
    gpl = -(-tl // tg)
    n_ct, n_cot = -(-cin // tt), -(-cout // st)
    roles = taps // tl * gpl * n_ct * n_cot
    t1, td, hs, stages = plan["t1"], plan["td"], plan["hs"], plan["stages"]
    hspan, wspan = plan["hspan"], plan["wspan"]
    lag = hspan - 1
    nw1, ndt, nseg = -(-e1 // t1), -(-e2 // td), -(-e0 // hs)
    units, groups, rpl = n * nseg * nw1 * ndt, plan["groups"], plan["rpl"]
    dpx, xcols = td + k - 1, t1 + wspan - 1
    dy_rows = -(-t1 * td // 16) * 16 if bf16 else t1 * td
    W = sg.S1_WARPS  # the computing warps
    dw = np.full((cout, cin, taps), np.nan)
    dbo = np.full(cout, np.nan)
    for role0 in range(0, roles, rpl):  # the launches
        rc = min(rpl, roles - role0)
        part = np.zeros((groups * rc, tg, tt, st))
        dbpart = np.zeros((groups * rc, st))
        for blk in range(groups * rc):
            role, grp = role0 + blk % rc, blk // rc
            cot, ct, tgi = role % n_cot, (role // n_cot) % n_ct, \
                role // (n_cot * n_ct)
            group = group_taps(k, tl, tg, tgi)
            tap0, tgr = group[0], len(group)
            (kh0, kw0), _ = sg.group_span(k, tap0, tgr)
            ci0, co0 = ct * tt, cot * st
            cinw, cow = min(tt, cin - ci0), min(st, cout - co0)
            db = role < n_cot
            # The ring, zeroed when the block starts; the stagers write every
            # row of a unit's planes, zeros outside the tensor.
            ring_x = np.zeros((stages, xcols * dpx, tt))
            ring_dy = np.zeros((stages, dy_rows, st))
            if bf16:
                nwt = 4 if tg >= 4 else 2 if tg >= 2 else 1
                slices, tpw = W // nwt, -(-tg // nwt)
                acc = np.zeros((W, 8, tt, st))
            else:
                slots = 32 // tg
                acc = np.zeros((W, 32, tt, st))
                dgs = 32 * W // st
                dbacc = np.zeros((dgs, st))
            it = 0
            for un in range(grp, units, groups):
                q, dt = divmod(un, ndt)
                q, wc = divmod(q, nw1)
                nn, seg = divmod(q, nseg)
                w0, d0, h_lo = wc * t1, dt * td, seg * hs
                t1c, tdc = min(t1, e1 - w0), min(td, e2 - d0)
                nq = t1c * td
                n_items = min(hs, e0 - h_lo) + lag
                wb, dbase = w0 - p + kw0, d0 - pd
                v = np.arange(nq)
                vrow = (v // td) * dpx + v % td  # x row at the first tap
                for i in range(n_items):
                    s = it % stages
                    m = h_lo - p + kh0 + i
                    for c in range(t1c + wspan - 1):
                        for j in range(dpx):
                            wi, di = wb + c, dbase + j
                            ring_x[s, c * dpx + j] = 0.0
                            if 0 <= m < e0 and 0 <= wi < e1 and \
                                    0 <= di < xd:
                                ring_x[s, c * dpx + j, :cinw] = \
                                    x[nn, m, wi, di, ci0:ci0 + cinw]
                    if i >= lag:
                        h = h_lo + i - lag
                        for r in range(dy_rows):
                            c, j = divmod(r, td)
                            ring_dy[s, r, :cow] = 0.0
                            if c < t1c and j < tdc:
                                ring_dy[s, r, :cow] = \
                                    dy[nn, h, w0 + c, d0 + j, co0:co0 + cow]
                    it += 1
                    if i < lag:
                        continue
                    dys = ring_dy[s]

                    def x_of(tap, rows, it=it - 1):
                        kh, rest = divmod(tap, k * k)
                        kw, kd = divmod(rest, k)
                        return ring_x[(it - lag + kh - kh0) % stages][
                            rows + (kw - kw0) * dpx + kd]

                    if bf16:
                        nk = -(-nq // 16)
                        for w in range(W):
                            wt, sl = w % nwt, w // nwt
                            nt = max(0, min(tgr - wt * tpw, tpw))
                            for ks in range(sl, nk, slices):
                                q16 = np.arange(ks * 16, ks * 16 + 16)
                                a_rows = vrow[np.minimum(q16, nq - 1)]
                                b = dys[q16]  # zero rows past the unit
                                for t in range(nt):
                                    acc[w, t] += x_of(tap0 + wt * tpw + t,
                                                      a_rows).T @ b
                                if db and wt == nwt - 1:  # the tap of ones
                                    acc[w, nt] += np.ones((16, tt)).T @ b
                    else:
                        for lane in range(32):
                            j = min(lane // tg, slots - 1)
                            t = min(lane % tg, tgr - 1)
                            for w in range(W):
                                vs = np.arange(w * slots + j, nq, W * slots)
                                acc[w, lane] += x_of(tap0 + t, vrow[vs]).T @ \
                                    dys[vs]
                        if db:
                            for dg in range(dgs):
                                dbacc[dg] += dys[dg:nq:dgs].sum(0)
            # The block's sums: float32 over warps and voxel slots,
            # bfloat16 over k-step slices; db from its thread groups or the
            # tap of ones.
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
        # The launch's finalize: each output over its role's blocks in
        # block order.
        for rl in range(rc):
            role = role0 + rl
            cot, ct, tgi = role % n_cot, (role // n_cot) % n_ct, \
                role // (n_cot * n_ct)
            for t, tap in enumerate(group_taps(k, tl, tg, tgi)):
                for a in range(min(tt, cin - ct * tt)):
                    for b in range(min(st, cout - cot * st)):
                        co, ci = cot * st + b, ct * tt + a
                        assert np.isnan(dw[co, ci, tap])  # written once
                        dw[co, ci, tap] = part[rl::rc, t, a, b].sum()
            if role < n_cot:
                for b in range(min(st, cout - role * st)):
                    assert np.isnan(dbo[role * st + b])
                    dbo[role * st + b] = dbpart[rl::rc, b].sum()
    assert not np.isnan(dw).any() and not np.isnan(dbo).any()
    return dw.reshape((cout, cin) + (k,) * 3), dbo


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).double().numpy()


EMULATED = {  # (N, *spatial), cin, cout, k, itemsize, strip, min_blocks,
    # and the plan's other settings: the tap lines tried (as powers of k)
    # and MAX_GRID
    "f32 k=3, whole walk": ((2, 5, 7, 3), 3, 4, 3, 4, 8, 1, {}),
    "f32 k=3, segments of 2, ragged run": ((1, 5, 7, 4), 5, 6, 3, 4, 8, 8,
                                           {}),
    "f32 k=3, a step a block": ((2, 3, 4, 5), 10, 10, 3, 4, 256, None, {}),
    "f32 k=1, voxel slots": ((2, 4, 3, 6), 16, 8, 1, 4, 8, 1, {}),
    "f32 k=5, tap groups": ((1, 4, 5, 3), 2, 3, 5, 4, 16, 1, {}),
    "f32 Cin and Cout tiles": ((1, 3, 4, 2), 20, 18, 3, 4, 8, 1, {}),
    "bf16 k=3, whole walk": ((2, 5, 7, 3), 10, 10, 3, 2, 8, 1, {}),
    "bf16 k=3, ragged k-steps": ((1, 4, 5, 7), 4, 6, 3, 2, 14, 4, {}),
    "bf16 odd channels 7 -> 7": ((2, 4, 4, 3), 7, 7, 3, 2, 8, 1, {}),
    "bf16 k=1, k-step slices": ((2, 3, 4, 8), 16, 8, 1, 2, 16, 1, {}),
    "bf16 k=5, tap groups": ((1, 4, 4, 4), 3, 5, 5, 2, 16, 1, {}),
    "bf16 Cin and Cout tiles": ((1, 3, 3, 2), 20, 17, 3, 2, 8, 1, {}),
    "f32 k=7, kh-aligned roles (lines of k^2)": (
        (1, 4, 5, 6), 3, 4, 7, 4, 64, 1, {"lines": (2,)}),
    "bf16 k=7, kh-aligned roles (lines of k^2)": (
        (1, 3, 4, 5), 4, 4, 7, 2, 64, 1, {"lines": (2,)}),
    "f32 k=5, split roles over two kh": ((1, 3, 4, 6), 3, 3, 5, 4, 32, 1,
                                         {"lines": (3,)}),
    "f32 depth tiles, the last ragged": ((1, 3, 2, 11), 3, 4, 3, 4, 4, 1,
                                         {}),
    "bf16 depth tiles, a looping grid": ((1, 3, 3, 10), 5, 6, 3, 2, 4, 1,
                                         {"MAX_GRID": 4}),
    "f32 k=5 depth tiles, a looping grid, segments": (
        (2, 5, 3, 9), 3, 5, 5, 4, 4, 8, {"MAX_GRID": 6, "lines": (2,)}),
    "f32 roles over several launches": ((1, 3, 4, 3), 20, 18, 3, 4, 8, 1,
                                        {"MAX_GRID": 3}),
    "f32 k=9 over extents 4, 5, 3 (taps on padding alone)": (
        (1, 4, 5, 3), 2, 3, 9, 4, 16, 1, {}),
    "bf16 k=9 over extents 4, 5, 3, several launches": (
        (1, 4, 5, 3), 3, 2, 9, 2, 16, 1, {"MAX_GRID": 8}),
    "f32 k=15 at depth 1": ((1, 2, 3, 1), 2, 1, 15, 4, 16, 1, {}),
    "f32 k=7 one-kh roles, h cut for a role's blocks": (
        (1, 6, 3, 4), 2, 2, 7, 4, 16, None, {"lines": (2,)}),
}


def padding_only_taps(spatial, k):
    """(k, k, k) mask of the taps that read padding alone: an offset t - p
    no output voxel of an axis reaches inside it."""
    off = np.abs(np.arange(k) - (k - 1) // 2)
    e0, e1, e2 = spatial
    return (off[:, None, None] >= e0) | (off[None, :, None] >= e1) | \
        (off[None, None, :] >= e2)


@pytest.mark.parametrize("case", list(EMULATED))
def test_the_kernels_walk_makes_the_weight_gradient(monkeypatch, case):
    """The numpy emulation of csrc/shallow_dw.cu equals the plain version
    (the JAX rule's merged fold) and jax.vjp of the JAX conv_smallc at
    float32 round-off; bfloat16 cases on bfloat16-rounded inputs. Taps on
    padding alone come out exactly 0."""
    shape, cin, cout, k, itemsize, strip, min_blocks, other = EMULATED[case]
    monkeypatch.setattr(sg, "STRIPS", {itemsize: (strip,)})
    if min_blocks is not None:
        monkeypatch.setattr(sg, "MIN_BLOCKS", min_blocks)
        monkeypatch.setattr(sg, "MIN_GROUPS", min_blocks)
    if "lines" in other:
        monkeypatch.setattr(sg, "tap_lines", lambda k_: tuple(
            k_ ** e for e in other["lines"]))
    if "MAX_GRID" in other:
        monkeypatch.setattr(sg, "MAX_GRID", other["MAX_GRID"])
    rng = np.random.default_rng(8)
    x = rng.standard_normal(shape + (cin,))
    dy = rng.standard_normal(shape + (cout,))
    bf16 = itemsize == 2
    if bf16:
        x, dy = _bf16(x), _bf16(dy)
    plan = sg.dw_plan(shape[0], shape[1:], cin, cout, itemsize, k)
    assert plan["strip"] == strip
    if "MAX_GRID" in other:  # the plan's constants, the kernel's own
        monkeypatch.setattr(sg, "MAX_GRID", kernel_constant("kMaxGrid"))
        assert plan["blocks"] <= other["MAX_GRID"]
        assert plan["units"] > plan["groups"] or plan["launches"] > 1
    assert_dw_plan_holds_the_kernel(plan, shape[0], shape[1:], cin, cout,
                                    itemsize, k)
    if "lines" in other:
        assert plan["tl"] == k ** other["lines"][0]
    if min_blocks == 1 and plan["td"] == shape[3]:
        assert plan["hs"] == shape[1]  # the whole walk through the ring
    if min_blocks is None and plan["hspan"] == 1:  # a role's MIN_GROUPS
        assert plan["groups"] >= min(sg.MIN_GROUPS, plan["units"]) and \
            plan["nseg"] > 1
    dw, db = emulate_dw(x, dy, plan, bf16)
    assert (dw[..., padding_only_taps(shape[1:], k)] == 0).all()

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


def test_a_kernel_size_9_unet_trains_as_the_jax_unet():
    """A 3D UNet with kernel_size=9 (filters 4, 8, one residual unit, 4
    output classes) on a 8 x 8 x 40 input: its stride-1 convs with at most
    16 channels route to conv_smallc in both models (the top decoder's 4 ->
    4 conv at depth 40 among them), and every parameter's gradient of a
    fixed linear loss equals the JAX model's in float64, the JAX weights
    carried over by models/jax_import.py."""
    filters, strides, res, k = (4, 8), (2,), 1, 9
    shape = (1, 8, 8, 40)
    rng = np.random.default_rng(9)
    x = rng.normal(size=shape + (1,))
    g = rng.normal(size=shape + (4,))
    jcalls = []
    conv = jax_sg.conv_smallc

    def rec_conv(x_, w_, b_, stride, pad):
        jcalls.append((x_.shape[-1], w_.shape[-1], x_.shape[-2], w_.shape[0]))
        return conv(x_, w_, b_, stride, pad)

    jm = JaxUNet(out_channels=4, channels=filters, strides=strides,
                 num_res_units=res, kernel_size=k, dtype=jnp.float64,
                 param_dtype=jnp.float64)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sg, "conv_smallc", rec_conv)
        grads = jax.grad(lambda p_: jnp.sum(
            jm.apply(p_, jnp.asarray(x)) * jnp.asarray(g)))(params)
    assert (4, 4, 40, k) in jcalls

    model = SegmentationModel(1, 4, filters, strides, res, spatial_dims=3,
                              device="cpu", dtype=torch.float64)
    model.unet = UNet(1, 4, filters, strides, res, kernel_size=k,
                      spatial_dims=3).double()
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    model.load_state_dict(state_dict_from_jax_params(
        {"unet": tree}, 1, filters, strides, num_res_units=res))
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        port_conv = layers.conv_smallc

        def rec_port(x_, w_, b_, stride, pad):
            calls.append((x_.shape[1], w_.shape[0], x_.shape[-1],
                          w_.shape[-1]))
            return port_conv(x_, w_, b_, stride, pad)

        mp.setattr(layers, "conv_smallc", rec_port)
        y = model(layers.channels_last(torch.from_numpy(x).movedim(-1, 1)))
        (y * torch.from_numpy(g).movedim(-1, 1)).sum().backward()
    assert sorted(calls) == sorted(jcalls)
    want = state_dict_from_jax_params(
        {"unet": jax.tree_util.tree_map(np.asarray, grads["params"])}, 1,
        filters, strides, num_res_units=res)
    got = {name: prm.grad for name, prm in model.named_parameters()}
    assert set(got) == set(want)
    for name, grad in got.items():
        scale = float(want[name].abs().max())
        torch.testing.assert_close(grad, want[name], rtol=0,
                                   atol=1e-10 * max(scale, 1.0), msg=name)


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
                                     "no db", "unroll 2", "unroll 16",
                                     "outside rows skipped",
                                     "a field after rpl", "divisors first",
                                     "one unit a block"])
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
                                     "unroll 16", "outside rows skipped",
                                     "a field after rpl", "divisors first",
                                     "one unit a block"}
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
