"""The arithmetic of the pruned K5, the EDT kernels around it and the
split-spatial K1 forward.

The CUDA kernels run only on the card (chip_smoke.py holds them to their
plain versions there). What they compute differently from the plain versions
is modelled in plain PyTorch beside them, and held here, on the CPU, with
inputs made by numpy from a seed:

  - `min_plus.min_plus_pruned_model` (the rows [first, last] below BIG, the
    outward walk that stops at fl(cost[d] + xmin) >= the largest
    accumulator, the all-zero groups) against `min_plus_plain` and the
    Pallas kernel in interpret mode: equal bit for bit, on scales from
    0.3-3.0, exact ties, rows and maps at BIG, an all-zero map, K = 1, a
    ragged shape, maps near 1e6 where nothing is pruned, negative values
    and hypothesis-drawn slabs.
  - the scan and the signed-map arithmetic as the kernels order them
    (`label_scan`, `row_scan`, `signed_map` on the CPU, composed by
    `_signed_maps`) against the plain compositions (equal bit for bit) and
    against the JAX package's EDT (bit-equal squared distances, signed maps
    at 1e-6: one float32 sqrt and division), with a missing class, a class
    that fills rows, per-map spacings; 2D and 3D.
  - the chunked K1 forward (`instance_norm_prelu_fwd_chunked`) against
    `_fwd_plain` at 1e-6 in float32 and 1e-12 in float64 (the sums are
    taken in another order, chunk by chunk) and against the Pallas kernel in
    interpret mode at tests/test_torch_port_kernels.py's 1e-5.
  - the forward's plans as pure functions.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ctseg_tpu.ops import edt as jax_edt
from ctseg_tpu.ops.pallas.instance_norm import fused_instance_norm_prelu
from ctseg_tpu.ops.pallas.min_plus import min_plus_2d
from ctseg_tpu_torch.ops import edt, instance_norm
from ctseg_tpu_torch.ops import min_plus as k5

BIG32 = float(np.float32(1e12))


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------- pruned K5
def _distance_maps(seed, b, k, l, density=0.05):
    """Squared row distances of random sites: 0 on them, BIG on rows
    without any."""
    sites = _rng(seed).random((b, k, l)) < density
    sites[:, k // 3] = False
    return edt.row_scan_plain(torch.from_numpy(~sites)).numpy()


def _unprunable(seed, b, k, l):
    x = 1e6 + 10.0 * _rng(seed).random((b, k, l))
    x[:, :, 7::32] = 2e6  # above the largest cost plus the smallest value
    return x.astype(np.float32)


def _ties(seed, b, k, l):
    """Few distinct small integers: many pairs give the same sum."""
    return _rng(seed).integers(0, 3, size=(b, k, l)).astype(np.float32) * 4.0


def _holes(seed, b, k, l):
    rng = _rng(seed)
    x = np.floor(rng.random((b, k, l)) * 2000).astype(np.float32)
    x[rng.random((b, k, l)) < 0.3] = 1e12
    x[:, k // 2] = 1e12        # a row with no value
    x[:, :, 5 % l] = 1e12      # a column with none
    x[0] = 1e12                # a whole map
    return x


PRUNED_CASES = {
    "distance maps": (_distance_maps, (3, 40, 45)),
    "sparse distance maps": (
        lambda s, b, k, l: _distance_maps(s, b, k, l, 0.002), (3, 40, 45)),
    "holes at BIG": (_holes, (3, 19, 40)),
    "ties": (_ties, (2, 24, 33)),
    "all zero": (lambda s, b, k, l: np.zeros((b, k, l), np.float32),
                 (2, 16, 33)),
    "all BIG": (lambda s, b, k, l: np.full((b, k, l), 1e12, np.float32),
                (2, 9, 33)),
    "K = 1": (_holes, (4, 1, 40)),
    "ragged": (_holes, (37, 100, 70)),
    "unprunable": (_unprunable, (2, 40, 64)),
    "negative values": (
        lambda s, b, k, l: (_rng(s).normal(size=(b, k, l)) * 50).astype(
            np.float32), (2, 20, 35)),
}


@pytest.mark.parametrize("name", sorted(PRUNED_CASES))
def test_pruned_search_is_bit_equal_to_all_pairs_and_pallas(name):
    make, (b, k, l) = PRUNED_CASES[name]
    x = make(len(name), b, k, l)
    scale = _rng(b + k).uniform(0.3, 3.0, size=b).astype(np.float32)
    scale[0] = 1.0
    xt, stt = torch.from_numpy(x), torch.from_numpy(scale)
    out, pairs = k5.min_plus_pruned_model(xt, stt)
    plain = k5.min_plus_plain(xt, stt)
    assert out.dtype == torch.float32 and out.shape == plain.shape
    assert torch.equal(out, plain)
    for i in range(min(b, 3)):
        pallas = np.asarray(min_plus_2d(jnp.asarray(x[i]),
                                        jnp.float32(scale[i]), interpret=True))
        np.testing.assert_array_equal(out[i].numpy(), pallas)
    kp = -(-k // k5.ROWS) * k5.ROWS
    if name == "unprunable":
        assert pairs == b * kp * kp * l  # every block met every block
    else:
        assert pairs < b * kp * kp * l
    if name in ("all zero", "all BIG"):
        assert pairs == 0
        assert float(out.max()) == (0.0 if name == "all zero" else BIG32)


def test_pruned_search_meets_few_rows_on_distance_maps():
    """On maps like the Boundary loss's the walk ends after the rows that
    the largest distance spans: a small share of the all-pairs work."""
    x = torch.from_numpy(_distance_maps(3, 2, 128, 64, density=0.1))
    out, pairs = k5.min_plus_pruned_model(x, torch.ones(2))
    assert torch.equal(out, k5.min_plus_plain(x, torch.ones(2)))
    assert pairs < 0.25 * 2 * 128 * 128 * 64


@settings(max_examples=25, deadline=None)
@given(
    b=st.integers(1, 2), k=st.integers(1, 21), l=st.integers(1, 40),
    seed=st.integers(0, 2**31 - 1),
    kind=st.sampled_from(["maps", "holes", "ties", "dense", "negative"]),
    scale=st.floats(0.3125, 3.0, width=32),
)
def test_pruned_search_on_drawn_slabs(b, k, l, seed, kind, scale):
    rng = _rng(seed)
    if kind == "maps":
        x = _distance_maps(seed, b, k, l, density=float(rng.uniform(0, 0.3)))
    elif kind == "holes":
        x = np.floor(rng.random((b, k, l)) * 500).astype(np.float32)
        x[rng.random((b, k, l)) < rng.uniform(0, 1)] = 1e12
    elif kind == "ties":
        x = _ties(seed, b, k, l)
    elif kind == "dense":
        x = (1e6 + 100 * rng.random((b, k, l))).astype(np.float32)
    else:
        x = (rng.normal(size=(b, k, l)) * 30).astype(np.float32)
    xt = torch.from_numpy(x)
    stt = torch.full((b,), scale, dtype=torch.float32)
    out, _ = k5.min_plus_pruned_model(xt, stt)
    assert torch.equal(out, k5.min_plus_plain(xt, stt))


# ------------------------------------------- the scan and the signed maps
def _label_maps(seed, shape):
    rng = _rng(seed)
    labels = rng.integers(0, 10, size=shape).astype(np.uint8)
    labels[1][labels[1] == 3] = 0    # a class missing from one sample
    labels[2] = 0                    # a sample with background only
    labels[0, 2:5] = 7               # a class that fills rows
    labels[3] = 4                    # a class that fills a sample
    return labels


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64])
@pytest.mark.parametrize("shape", [(4, 18, 37), (4, 6, 9, 33), (4, 40)])
def test_kernel_ordered_signed_maps_equal_the_plain_composition(shape, dtype):
    labels = torch.from_numpy(_label_maps(5, shape)).to(dtype)
    ours = edt._signed_maps(labels, 10)
    plain = edt.signed_distance_maps_from_labels_plain(labels)
    assert ours.shape == (4, 9) + shape[1:] and ours.dtype == torch.float32
    assert torch.equal(ours, plain)
    assert torch.equal(edt.signed_distance_maps_from_labels(labels), plain)
    assert not ours[2].any() and not ours[1, 2].any()  # empty masks: zeros


def test_kernel_ordered_signed_maps_match_jax():
    labels = _label_maps(6, (4, 18, 16))
    ours = edt._signed_maps(torch.from_numpy(labels), 10)
    ref = np.asarray(jax_edt.signed_distance_maps_from_labels(
        jnp.asarray(labels)))  # (N, H, W, 9)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=0, atol=1e-6)
    # one mask is a label map with one class
    mask = torch.from_numpy(labels == 4)
    one = edt._signed_maps(mask, 2)[:, 0]
    assert torch.equal(one, edt.signed_distance_map_plain(mask, 2))
    assert torch.equal(one, ours[:, 3])


def test_label_scan_gives_both_signs_and_the_nonempty_flags():
    labels = torch.from_numpy(_label_maps(7, (4, 12, 35)))
    d2, nonempty = edt.label_scan(labels, 10)
    assert d2.shape == (2, 4, 9, 12, 35) and nonempty.shape == (4, 9)
    classes = torch.arange(1, 10)[:, None, None]
    pos = labels[:, None] == classes
    for sign, mask in enumerate((~pos, pos)):
        assert torch.equal(d2[sign], edt.row_scan(
            mask.flatten(0, 1)).reshape(4, 9, 12, 35))
    assert torch.equal(nonempty.bool(), pos.flatten(2).any(dim=-1))
    # the rows 7 fills: 0 squared distance to the class, BIG to its outside
    assert float(d2[0, 0, 6, 3].max()) == 0.0
    assert float(d2[1, 0, 6, 3].min()) == BIG32


@pytest.mark.parametrize("shape,nd", [((3, 20, 24), 2), ((2, 6, 9, 8), 3),
                                      ((5, 31), 1)])
def test_row_scan_with_per_map_spacings_is_bit_equal_to_jax(shape, nd):
    rng = _rng(sum(shape))
    masks = rng.random(shape) > 0.3
    masks.reshape(shape[0], -1, shape[-1])[0, :2] = True  # rows with no zero
    spacing = rng.uniform(0.3, 3.0, size=(shape[0], nd)).astype(np.float32)
    ours = edt.edt_squared(torch.from_numpy(masks), torch.from_numpy(spacing))
    assert torch.equal(ours, edt.edt_squared_plain(
        torch.from_numpy(masks), torch.from_numpy(spacing)))
    for i in range(shape[0]):
        ref = np.asarray(jax_edt.edt_squared(jnp.asarray(masks[i]),
                                             jnp.asarray(spacing[i])))
        np.testing.assert_array_equal(ours[i].numpy(), ref)
    rows = torch.from_numpy(masks).reshape(shape[0], -1, shape[-1])
    scaled = edt.row_scan(rows, torch.from_numpy(spacing[:, -1].copy()))
    g = edt.row_scan(rows).sqrt()  # unit spacing: the step counts
    want = torch.clamp_max((g * torch.from_numpy(spacing[:, -1])[:, None, None])
                           ** 2, BIG32)
    assert torch.equal(scaled[g < 1e5], want[g < 1e5])
    assert float(scaled[g > 1e5].min()) == BIG32


def test_edt_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="M, R, W"):
        edt.row_scan(torch.zeros((4, 5), dtype=torch.bool))
    with pytest.raises(ValueError, match="N, R, W"):
        edt.label_scan(torch.zeros((4, 5), dtype=torch.uint8), 10)
    before = (edt.row_scan.launches, edt.signed_map.launches)
    edt.signed_distance_maps_from_labels(torch.zeros((1, 4, 5), dtype=torch.uint8))
    edt._signed_maps(torch.zeros((1, 4, 5), dtype=torch.uint8), 10)
    assert before == (edt.row_scan.launches, edt.signed_map.launches)


# ------------------------------------------------------------ chunked K1f
def _k1_input(shape, seed, dtype):
    x = _rng(seed).normal(0.5, 1.5, size=shape)
    x[..., 0] = 3.0 + 1e-6 * x[..., 0]  # near-constant: var rounds to ~0
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("alpha", [0.25, -0.1, 0.0])
@pytest.mark.parametrize("shape,chunk", [
    ((3, 16, 16, 10), 64),    # C = 10, the top decoder level's width
    ((2, 7, 9, 10), 16),      # S = 63, no multiple of the chunk
    ((2, 12, 10, 32), 50),    # ragged last chunk
    ((1, 5, 5, 3), 1),        # one pixel a chunk
    ((2, 6, 6, 64), 36),      # one chunk: the plain order
    ((2, 4, 5, 6, 8), 15),    # rank 5
])
def test_chunked_k1f_matches_plain(shape, chunk, alpha, dtype, tol):
    x = _k1_input(shape, len(shape) + chunk, dtype)
    a = torch.tensor([alpha], dtype=dtype)
    y, mean, var = instance_norm.instance_norm_prelu_fwd_chunked(x, a, chunk)
    py, pmean, pvar = instance_norm._fwd_plain(x, a)
    assert y.shape == x.shape and y.dtype == dtype
    assert mean.shape == var.shape == (shape[0], shape[-1])
    assert bool(torch.isfinite(y).all())  # the near-constant channel too
    np.testing.assert_allclose(mean.numpy(), pmean.numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(var[:, 1:].numpy(), pvar[:, 1:].numpy(),
                               rtol=10 * tol, atol=tol)
    assert bool((var >= 0).all())
    # |xhat| reaches a few units, so y carries a few roundings of the sums.
    np.testing.assert_allclose(y[..., 1:].numpy(), py[..., 1:].numpy(),
                               rtol=10 * tol, atol=10 * tol)


@pytest.mark.parametrize("alpha", [0.25, -0.1])
@pytest.mark.parametrize("chunk", [16, 50, 192])
def test_chunked_k1f_matches_pallas(chunk, alpha):
    x = _k1_input((2, 16, 12, 8), 1, torch.float32)
    a = np.asarray([alpha], np.float32)
    ours = instance_norm.instance_norm_prelu_fwd_chunked(
        x, torch.from_numpy(a), chunk)[0].numpy()
    pallas = np.asarray(fused_instance_norm_prelu(
        jnp.asarray(x.numpy()), jnp.asarray(a), True))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[..., 1:], pallas[..., 1:], rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------ the forward's plans (pure functions)
SITES = [(128 * 128, 64), (64 * 64, 128), (32 * 32, 256), (16 * 16, 512),
         (256 * 256, 10)]
K1F_SHAPES = [
    # (n, s, c, itemsize)
    (128, 256 * 256, 10, 4), (32, 256 * 256, 10, 2), (32, 128 * 128, 64, 4),
    (128, 64 * 64, 128, 2), (32, 16 * 16, 1024, 4), (2, 35, 3, 4),
    (5, 36, 10, 4), (5, 16, 1030, 4), (3, 7, 2051, 2), (1, 1, 1, 4),
    (4, 6, 4100, 4), (7, 1000, 24, 2), (4, 512 * 512, 64, 4),
    (3, 6144, 255, 2), (3, 3072, 255, 2),
]


@pytest.mark.parametrize("n,s,c,itemsize", K1F_SHAPES)
def test_k1f_plan_covers_the_sample_once(n, s, c, itemsize):
    plan = instance_norm.fwd_plan(n, s, c, itemsize)
    assert plan["lcm"] == plan["q"] * plan["vec"] == math.lcm(c, plan["vec"])
    assert plan["rows_total"] * plan["lcm"] == s * c
    chunks, per = plan["chunks"], plan["rows_per_chunk"]
    edges = [(i * per, min((i + 1) * per, plan["rows_total"]))
             for i in range(chunks)]
    assert edges[0][0] == 0 and edges[-1][1] == plan["rows_total"]
    assert all(a < b for a, b in edges)
    assert all(edges[i][1] == edges[i + 1][0] for i in range(chunks - 1))
    assert plan["grid"] == (plan["coltiles"], chunks, n)
    assert plan["workspace"] == (n, chunks, 2, plan["lcm"])
    # the backward's plan is the same cut, with three sums
    bwd = instance_norm.bwd_plan(n, s, c, itemsize)
    assert bwd["workspace"] == (n, chunks, 3, plan["lcm"])
    assert {k: v for k, v in bwd.items() if k != "workspace"} == \
        {k: v for k, v in plan.items() if k != "workspace"}


@pytest.mark.parametrize("n,s,c,itemsize", K1F_SHAPES)
def test_k1f_cluster_candidates_hold_the_sample_in_shared_memory(n, s, c,
                                                                 itemsize):
    vec = 16 // itemsize
    found = instance_norm.fwd_cluster_candidates(n, s, c, itemsize)
    plan = instance_norm.fwd_cluster_plan(n, s, c, itemsize)
    assert (plan is None) == (found == [])
    if found:
        assert plan in found and plan["size"] == found[0]["size"]
        assert plan["wcc"] <= found[0]["wcc"]
    if (s * c) % vec != 0:
        assert found == []
    assert instance_norm.fwd_cluster_candidates(n, s, c, itemsize, False) == []
    for plan in found:
        q, wcc, size = plan["q"], plan["wcc"], plan["size"]
        assert plan["vec"] == vec and plan["lcm"] == math.lcm(c, vec)
        assert plan["rows_total"] * plan["lcm"] == s * c
        # the tiles cover the super-row once; a channel never leaves its tile
        assert plan["coltiles"] * wcc == q
        assert c % vec == 0 or wcc == q
        assert (wcc * vec) % c == 0 or c % (wcc * vec) == 0
        # the blocks cover the super-rows once
        per = plan["rows_per_cta"]
        assert per == -(-plan["rows_total"] // size)  # the last may be empty
        assert plan["grid"] == (size * plan["coltiles"], 1, n)
        # a block: its threads, its rows of x, the sums and the statistics
        assert 1 <= plan["rr"] * wcc <= instance_norm.FWD_CLUSTER_THREADS
        assert plan["tile_bytes"] == per * wcc * 16
        smem = plan["tile_bytes"] + 4 * (
            2 * instance_norm.FWD_CLUSTER_THREADS * vec + 4 * wcc * vec)
        assert smem == instance_norm.fwd_cluster_smem_bytes(per, wcc, vec)
        assert smem <= 227 * 1024


def test_k1f_plans_at_the_model_sites():
    """Every IN+PReLU site takes the read-once form in both types, with at
    least 132 blocks at the serving batch; at C = 10 a super-row is 5
    vectors and all but one of a two-phase block's 256 lanes work."""
    for s, c in SITES:
        for itemsize in (4, 2):
            plan = instance_norm.fwd_cluster_plan(32, s, c, itemsize)
            assert plan is not None
            assert math.prod(plan["grid"]) >= 132
            assert plan["tile_bytes"] <= (
                instance_norm.FWD_CLUSTER_TILE_BYTES if c != 10
                else instance_norm.FWD_CLUSTER_MAX_TILE_BYTES)
            two = instance_norm.fwd_plan(32, s, c, itemsize)
            assert math.prod(two["grid"]) >= 132 * 2
    sizes = [instance_norm.fwd_cluster_plan(32, s, c, 4)["size"]
             for s, c in SITES]
    assert sizes == [16, 8, 2, 1, 16]  # the fewest blocks that hold a tile
    # one sample leaves the SMs idle whatever the tile: the widest stays
    assert instance_norm.fwd_cluster_plan(1, 256, 512, 4)["wcc"] == 16
    assert instance_norm.fwd_cluster_plan(32, 256, 512, 2)["wcc"] == 8
    top = instance_norm.fwd_cluster_plan(32, 65536, 10, 4)
    assert (top["q"], top["wcc"], top["size"], top["rr"]) == (5, 5, 16, 51)
    assert top["lcm"] == 20 and top["rows_per_cta"] * 80 == top["tile_bytes"]
    two = instance_norm.fwd_plan(32, 65536, 10, 4)
    assert (two["q"], two["wc"], two["rr"]) == (5, 5, 51)


@pytest.mark.parametrize("s,c,itemsize,aligned", [
    (35, 3, 4, True),            # 105 elements: no whole vectors
    (16, 1030, 4, True),         # a super-row of 515 vectors, wider than a block
    (64 * 64, 128, 4, False),    # a view off the 16-byte grid
    (1024 * 1024, 64, 4, True),  # 16 blocks cannot hold 64-byte rows of it
    (512 * 512, 10, 4, True),    # nor this sample's whole super-rows
    # a 255-vector super-row in bfloat16: 16 blocks' tiles of 48 rows fit
    # 192 KB, but not with the 48 KB of sums and statistics beside them
    (6144, 255, 2, True),
])
def test_k1f_cluster_plan_leaves_the_rest_to_two_phases(s, c, itemsize, aligned):
    assert instance_norm.fwd_cluster_plan(4, s, c, itemsize, aligned) is None
    plan = instance_norm.fwd_plan(4, s, c, itemsize, aligned)
    assert plan["chunks"] >= 1 and plan["rows_total"] * plan["lcm"] == s * c


def test_cpu_tensors_never_count_a_k1_launch():
    before = instance_norm.instance_norm_prelu.launches
    x = _k1_input((1, 4, 4, 10), 1, torch.float32)
    instance_norm.instance_norm_prelu(x, torch.tensor([0.25]))
    assert instance_norm.instance_norm_prelu.launches == before
