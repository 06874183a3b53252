"""The transposed conv's weight-gradient kernel, csrc/shallow_dwt.cu, on the
CPU: its plan (ops/shallow_grad.py::dwt_plan) and its arithmetic, emulated
in numpy (the kernel itself runs on the card, chip_smoke.py phase 16b).

  - The plan at the routed transposed sites of the main paths, at
    SHALLOW_ROUTED's depth-400 and odd-channel cases, at depth 5,000 and
    at channel counts past one Cin chunk or Cout tile, 2D and 3D, both
    types: an H100 block's and SM's shared memory, a thread's registers
    (the accumulators a lane), the grid, and what the C entry checks.
  - `emulate_dwt`: the kernel's decomposition (groups of strips, blocks of
    Cin chunk x Cout tile x kh, x rows and the parity-staged dy window, the
    9 taps' row offsets, k-steps of 16 voxels with zero rows past the strip,
    db from the 4 taps that read every dy voxel once, the finalize's sums)
    in numpy float64, held to `convt_dw_plain` and to `jax.vjp` of the JAX
    `conv_transpose_smallc` at float32 round-off, in 2D and 3D, whole
    columns and depth tiles, odd channels, several Cin chunks and Cout
    tiles, and Cin under 128 (warps taking every other k-step).
  - On a CPU tensor `shallow_dw(..., transposed=True)` is the plain
    version and `shallow_dwt` raises: the kernel has no CPU route.
  - csrc/tools/variants_shallow_dw.py's text edits still match the kernel,
    and the plan's constants are the kernel's.
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
from ctseg_tpu_torch.ops import shallow_grad as sg

CSRC = Path(sg.__file__).resolve().parent.parent / "csrc"
REGS = 255            # registers a thread
REG_FILE = 65536      # registers an SM


def kernel_constant(name):
    found = re.search(rf"constexpr int {name} = (\d+);",
                      (CSRC / "shallow_dwt.cu").read_text())
    assert found, name
    return int(found.group(1))


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).movedim(-1, 1)


def assert_dwt_plan_holds_the_kernel(plan, n, spatial, cin, cout, itemsize):
    """What csrc/shallow_dwt.cu's C entry checks of the plan, and the H100's
    limits it must keep."""
    nd, bf16 = len(spatial), itemsize == 2
    e1, e2 = spatial[1], spatial[2] if nd == 3 else 1
    t1, t2 = plan["t1"], plan["t2"]
    assert plan["n_ct"] in (1, 2, 4, 8) and plan["cin_c"] == 16 * plan["n_ct"]
    assert plan["n_ct"] * plan["slices"] == sg.DWT_WARPS
    assert 1 <= t1 <= e1 and 1 <= t2 <= e2 and t1 * t2 <= 4096
    assert t2 == e2 or t1 == 1  # d in tiles only one column at a time
    sx, sdy = plan["sx"], plan["sdy"]
    if bf16:  # an odd number of 16-byte units: ldmatrix without conflicts
        assert sx % 8 == 4 and 2 * sx >= plan["cin_c"]
        assert sdy % 8 == 4 and sdy >= 8
    else:  # 8 or 24 words past 32: the tf32 fragments' loads
        assert sx % 32 in (8, 24) and sx >= plan["cin_c"]
        assert sdy % 32 in (8, 24) and sdy >= 16
    ew, ed = t1 + 1, (t2 + 1 if nd == 3 else 1)
    rows = (1 if nd == 3 else 3) * 2 * (2 if nd == 3 else 1) * ew * ed
    assert plan["window_rows"] == rows
    assert plan["x_words"] % 4 == plan["stage_words"] % 4 == 0
    assert plan["x_words"] >= -(-t1 * t2 // 16) * 16 * sx
    assert plan["stage_words"] >= plan["x_words"] + rows * sdy
    smem = plan["smem_bytes"]
    # float32's tf32 pairs: one split window fewer than buffers; then the
    # buffers' full and empty barriers.
    split = 0 if bf16 else rows * sg.DWT_SPLIT_WORDS
    assert (sg.DWT_STAGES * plan["stage_words"] +
            (sg.DWT_STAGES - 1) * split) * 4 + 16 * sg.DWT_STAGES <= smem <= \
        sg.MAX_SHARED
    assert smem >= sg.DWT_WARPS * 16 * 8  # db's float64 sums at the end
    roles = -(-cin // plan["cin_c"]) * -(-cout // 16) * (3 if nd == 3 else 1)
    assert plan["roles"] == roles
    qtot = n * spatial[0] * -(-e1 // t1) * -(-e2 // t2)
    assert plan["qtot"] == qtot and 1 <= plan["groups"] <= qtot
    assert plan["blocks"] == plan["groups"] * roles < 2 ** 31
    assert plan["part_elems"] >= plan["blocks"] * plan["slices"] * 9 * \
        plan["cin_c"] * 16
    assert plan["dbpart_elems"] >= plan["blocks"] * 16
    # The SMs are filled where there are strips enough, one block each.
    assert min(qtot * roles, sg.SMS) <= plan["blocks"] < sg.SMS + roles
    # Registers: a computing warp's 9 taps x 2 n-tiles x 4 accumulators a
    # lane, twice (the strip's and the running sums), its 9 taps' dy
    # fragments (4 registers each) and its x fragment (4) within what
    # setmaxnreg gives it, and the staging warpgroup's and the computing
    # warps' registers within an SM's file.
    producers, consumer_regs = (kernel_constant("kProducers"),
                                kernel_constant("kConsumerRegs"))
    assert 2 * 9 * 8 + 9 * 4 + 4 <= consumer_regs <= REGS
    assert producers % 128 == 0 and consumer_regs % 8 == 0
    assert producers * kernel_constant("kProducerRegs") + \
        sg.DWT_WARPS * 32 * consumer_regs <= REG_FILE


# The routed transposed sites of the main paths (chip_smoke.py's
# SHALLOW_SITES), SHALLOW_ROUTED's transposed cases, and shapes past them.
# (n, spatial, cin, cout)
DWT_SITES = {
    "bench_3d transposed": (128, (64, 64, 8), 128, 10),
    "Model L transposed": (128, (128, 128), 128, 10),
    "model_3d transposed": (1, (128, 128, 48), 128, 10),
    "phase 18 transposed": (2, (16, 16, 4), 64, 16),
    "transposed from depth 400": (1, (8, 8, 400), 32, 10),
    "transposed from depth 5000": (1, (4, 4, 5000), 16, 16),
    "transposed 16 -> 7 (odd channels)": (2, (16, 16, 8), 16, 7),
    "2D 7 -> 16 (odd Cin)": (4, (33, 17), 7, 16),
    "3D 200 -> 10 (two Cin chunks)": (2, (8, 8, 8), 200, 10),
    "2D 16 -> 40 (three Cout tiles)": (2, (16, 16), 16, 40),
}


@pytest.mark.parametrize("site", list(DWT_SITES))
@pytest.mark.parametrize("itemsize", [4, 2])
def test_the_transposed_plan_at_the_sites(site, itemsize):
    n, spatial, cin, cout = DWT_SITES[site]
    plan = sg.dwt_plan(n, spatial, cin, cout, itemsize)
    assert plan["smem_bytes"] <= sg.MAX_SHARED
    assert plan["strip"] in sg.DWT_STRIPS[itemsize]
    assert_dwt_plan_holds_the_kernel(plan, n, spatial, cin, cout, itemsize)


def test_the_transposed_plan_at_the_main_sites_takes_all_cin_and_sms():
    """At the main paths' sites (Cin 128, Cout 10) a block holds all 128
    channels of a strip (one Cin chunk, one Cout tile; 3 kh blocks in 3D)
    and the grid fills the 132 SMs."""
    for site in ("bench_3d transposed", "Model L transposed",
                 "model_3d transposed"):
        n, spatial, cin, cout = DWT_SITES[site]
        for itemsize in (4, 2):
            plan = sg.dwt_plan(n, spatial, cin, cout, itemsize)
            assert plan["n_ct"] == 8 and plan["slices"] == 1
            assert plan["roles"] == (3 if len(spatial) == 3 else 1)
            assert plan["blocks"] >= sg.SMS


# ------------------------------------------------------ the kernel in numpy
def _tap_offset(nd, ew, ed, tap9):
    """csrc/shallow_dwt.cu's tap_offset."""
    r = 0 if nd == 3 else tap9 // 3
    kw = tap9 // 3 if nd == 3 else tap9 % 3
    kd = tap9 % 3 if nd == 3 else 1
    npd = 2 if nd == 3 else 1
    pw, pd = int(kw != 1), (int(kd != 1) if nd == 3 else 0)
    plane = (r * 2 + pw) * npd + pd
    return (plane * ew + int(kw == 2)) * ed + int(nd == 3 and kd == 2)


def emulate_dwt(x, dy, plan):
    """csrc/shallow_dwt.cu's decomposition in numpy float64. x (n, *S, cin),
    dy (n, *2S, cout) -> dW in torch's (cin, cout, 3, 3[, 3]) layout, db."""
    nd = x.ndim - 2
    if nd == 2:
        x, dy = x[:, :, :, None], dy[:, :, :, None]
    n, e0, e1, e2, cin = x.shape
    f0, f1, f2 = dy.shape[1:4]
    cout = dy.shape[-1]
    n_ct, cin_c, slices = plan["n_ct"], plan["cin_c"], plan["slices"]
    n_cot, nkh = -(-cout // 16), (3 if nd == 3 else 1)
    roles, groups = plan["roles"], plan["groups"]
    t1, t2 = plan["t1"], plan["t2"]
    nw1, nw2 = -(-e1 // t1), -(-e2 // t2)
    qtot = n * e0 * nw1 * nw2
    ew, ed, npd = t1 + 1, (t2 + 1 if nd == 3 else 1), (2 if nd == 3 else 1)
    nr = plan["window_rows"]
    toff = [_tap_offset(nd, ew, ed, t) for t in range(9)]
    part = np.zeros((groups, roles, slices, 9, cin_c, 16))
    dbpart = np.zeros((groups, roles, 16))
    for group in range(groups):
        q_lo, q_hi = group * qtot // groups, (group + 1) * qtot // groups
        for role in range(roles):
            kh = role % nkh
            cot, cic = (role // nkh) % n_cot, role // (nkh * n_cot)
            ci0, co0 = cic * cin_c, cot * 16
            cinw, cow = min(cin_c, cin - ci0), min(16, cout - co0)
            db_block = cic == 0 and (nd == 2 or kh >= 1)
            for qb in range(q_lo, q_hi):
                rest, dc = divmod(qb, nw2)
                t, wc = divmod(rest, nw1)
                nn, h = divmod(t, e0)
                w0, d0 = wc * t1, dc * t2
                t1c, t2c = min(t1, e1 - w0), min(t2, e2 - d0)
                nq = t1c * t2 if t2c == t2 else t2c
                nq16 = -(-nq // 16) * 16
                # x rows: one contiguous run of voxels, zero past nq and
                # past Cin.
                flat = x[nn, h].reshape(-1, cin)
                row0 = w0 * e2 + d0
                xs = np.zeros((nq16, cin_c))
                xs[:nq, :cinw] = flat[row0:row0 + nq, ci0:ci0 + cinw]
                # The window: plane (r, pw, pd), rows (iw, id); zero outside
                # dy, past Cout and where never staged.
                win = np.zeros((nr, 16))
                for e in range(nr):
                    rest2, idd = divmod(e, ed)
                    plane, iw = divmod(rest2, ew)
                    pd = plane & 1 if npd == 2 else 0
                    pw = (plane >> 1 if npd == 2 else plane) & 1
                    r = plane >> 2 if npd == 2 else plane >> 1
                    if iw > t1c or idd > t2c:
                        continue
                    h2 = 2 * h - 1 + (kh if nd == 3 else r)
                    w2 = 2 * (w0 + iw) - pw
                    d2 = 2 * (d0 + idd) - pd if nd == 3 else 0
                    if 0 <= h2 < f0 and 0 <= w2 < f1 and 0 <= d2 < f2:
                        win[e, :cow] = dy[nn, h2, w2, d2, co0:co0 + cow]
                for ks in range((nq + 15) // 16):
                    k0 = ks * 16
                    sl = ks % slices
                    q = np.minimum(np.arange(k0, k0 + 16), nq - 1)
                    vb = (q // t2) * ed + q % t2
                    valid = np.arange(k0, k0 + 16) < nq
                    for tap in range(9):
                        b = win[vb + toff[tap]]
                        for ct in range(n_ct):
                            a = xs[k0:k0 + 16, ct * 16:ct * 16 + 16]
                            part[group, role, sl, tap,
                                 ct * 16:ct * 16 + 16] += a.T @ b
                        if db_block and tap in (4, 5, 7, 8):
                            dbpart[group, role] += b[valid].sum(0)
    taps = 9 * nkh
    dw = np.zeros((cin, cout) + (3,) * nd)
    for tap in range(taps):
        kh, t9 = divmod(tap, 9)
        idx = np.unravel_index(tap, (3,) * nd)
        for ci in range(cin):
            for co in range(cout):
                role = ((ci // cin_c) * n_cot + co // 16) * nkh + kh
                dw[(ci, co) + idx] = part[:, role, :, t9, ci % cin_c,
                                          co % 16].sum()
    db = np.zeros(cout)
    for co in range(cout):
        for kh in range(1 if nd == 3 else 0, nkh):
            db[co] += dbpart[:, (co // 16) * nkh + kh, co % 16].sum()
    return dw, db


EMULATED = {  # (N, *spatial), cin, cout, strip (None: the plan's own)
    "2D whole rows": ((2, 5, 7), 24, 10, None),
    "2D strips of 4 columns": ((2, 5, 7), 24, 10, 4),
    "3D whole columns": ((2, 3, 4, 3), 20, 10, None),
    "3D strips of 2 columns": ((1, 3, 5, 4), 12, 6, 8),
    "3D depth tiles": ((1, 2, 2, 19), 16, 10, 16),
    "3D odd channels": ((2, 3, 3, 5), 7, 7, None),
    "3D two Cin chunks": ((1, 2, 3, 3), 130, 4, None),
    "2D three Cout tiles": ((1, 4, 5), 5, 40, None),
    "2D Cin 128": ((1, 3, 5), 128, 10, None),
}


@pytest.mark.parametrize("case", list(EMULATED))
def test_the_kernels_strips_make_the_weight_gradient(monkeypatch, case):
    """The numpy emulation of csrc/shallow_dwt.cu equals the plain version
    (the JAX rule's formulation) and jax.vjp of the JAX
    conv_transpose_smallc, at float32 round-off."""
    shape, cin, cout, strip = EMULATED[case]
    if strip is not None:
        monkeypatch.setattr(sg, "DWT_STRIPS", {4: (strip,)})
    rng = np.random.default_rng(7)
    spatial = shape[1:]
    nd = len(spatial)
    osp = tuple(2 * e for e in spatial)
    x = rng.standard_normal(shape + (cin,))
    dy = rng.standard_normal((shape[0],) + osp + (cout,))
    plan = sg.dwt_plan(shape[0], spatial, cin, cout, 4)
    assert strip is None or plan["strip"] == strip
    assert_dwt_plan_holds_the_kernel(plan, shape[0], spatial, cin, cout, 4)
    dw, db = emulate_dwt(x, dy, plan)

    pdw, pdb = sg.shallow_dw(_nchw(x), _nchw(dy), True)
    np.testing.assert_allclose(dw, pdw.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(db, pdb.numpy(), rtol=1e-10, atol=1e-10)
    # jax.vjp of the JAX conv in float32: its (*k, ci, co) weights are
    # torch's with the taps flipped.
    w = rng.standard_normal((3,) * nd + (cin, cout)).astype(np.float32)
    b = np.zeros(cout, np.float32)
    _, vjp = jax.vjp(
        lambda x_, w_, b_: jax_sg.conv_transpose_smallc(x_, w_, b_, 2, 3),
        jnp.asarray(x, jnp.float32), jnp.asarray(w), jnp.asarray(b))
    _, jdw, jdb = vjp(jnp.asarray(dy, jnp.float32))
    want = np.flip(np.asarray(jdw, np.float64), tuple(range(nd)))
    want = np.moveaxis(want, (nd, nd + 1), (0, 1))
    assert np.linalg.norm(dw - want) <= 1e-5 * np.linalg.norm(want)
    assert np.linalg.norm(db - np.asarray(jdb)) <= 1e-5 * np.linalg.norm(db)


def test_the_kernel_has_no_cpu_route():
    x = torch.randn(1, 4, 3, 3)
    dy = torch.randn(1, 2, 6, 6)
    dw, db = sg.shallow_dw(x, dy, True)  # the plain version
    pdw, pdb = sg.shallow_dw_plain(x, dy, True)
    assert torch.equal(dw, pdw) and torch.equal(db, pdb)
    before = sg.shallow_dwt.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        sg.shallow_dwt(x, dy)
    assert sg.shallow_dwt.launches == before


@pytest.mark.parametrize("variant", ["staging only", "compute only",
                                     "no db", "no products", "no dy loads"])
def test_the_variants_tools_edits_match_the_kernel(variant):
    """csrc/tools/variants_shallow_dw.py times csrc/shallow_dwt.cu built
    from text edits; each edit must still find its text exactly once."""
    spec = importlib.util.spec_from_file_location(
        "variants_shallow_dw", CSRC / "tools" / "variants_shallow_dw.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert set(tool.DWT_VARIANTS) == {
        "this tree", "staging only", "compute only", "no db", "no products",
        "no dy loads"}
    edits = tool.DWT_VARIANTS[variant]
    assert edits and tool.edited(variant, edits) != (
        CSRC / tool.DWT_SOURCE).read_text()


def test_the_plan_constants_are_the_kernels():
    source = (CSRC / "shallow_dwt.cu").read_text()
    for name, value in (("kStages", sg.DWT_STAGES), ("kWarps", sg.DWT_WARPS),
                        ("kMaxShared", sg.MAX_SHARED),
                        ("kSplitWords", sg.DWT_SPLIT_WORDS)):
        found = re.search(rf"constexpr int {name} = (\d+);", source)
        assert found and int(found.group(1)) == value, name
