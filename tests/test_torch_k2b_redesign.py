"""K2b (ops/conv_block.py::in_prelu_bwd) on K1b's geometry, as far as the
CPU can check it: its plans as pure functions, the shared memory they ask
of an H100, the ctypes signatures of the C entry points, and its plain
version against the Pallas kernel in interpret mode.

  - `bwd_plan` at every K2 site of Model L (chip_smoke.py's K2_SITES), at
    the training batch 128, GradCAM's batch 8 and batch 1, both storage
    types: the read-once form with the block, cluster and tile the sweep chose
    (csrc/tools/sweep_k2b.py), the two-phase form at the two ragged shapes
    and off the 16-byte grid.
  - Every candidate geometry: its blocks cover the sample's pixels once and
    its tiles the channels once, its shared memory (rows of g and xhat, the
    reduction buffer, the sums and the means, counted here from the
    kernel's layout) within a block's 227 KB (two blocks of 256 threads
    within an SM's 228 KB) and its cluster within the 16 blocks an H100
    allows.
  - Every `_build.SIGNATURES` entry has the argument count of its
    `extern "C"` function in csrc/*.cu (ctypes would pass a wrong count
    silently).
  - `in_prelu_bwd_plain` in float64 against the Pallas kernel in interpret
    mode (which computes in float32 inside: dy within 1e-6 + 1e-5 relative,
    dalpha within 1e-5 of the sum of its terms' magnitudes), and its CPU
    call launches nothing.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.ops.pallas import conv_block as jax_conv_block
from ctseg_tpu_torch.ops import _build
from ctseg_tpu_torch.ops import conv_block
from ctseg_tpu_torch.ops import instance_norm

# (H, W, C) of Model L's K2 sites -> (threads a block, cluster size, tile
# width in vectors), for both storage types, from the sweep.
SITES = {
    (128, 128, 64): (512, 16, 4),
    (64, 64, 128): (256, 16, 8),
    (32, 32, 256): (256, 4, 8),
    (16, 16, 512): (256, 1, 8),
    (16, 16, 1024): (256, 1, 8),
}
RAGGED = [(20, 12, 40), (7, 9, 136)]  # chip_smoke.py's non-sites
H100_BLOCK_SMEM = 227 * 1024
H100_SM_SMEM = 228 * 1024  # shared by its blocks, 1 KB reserved each
H100_MAX_CLUSTER = 16


def _smem_bytes(plan):
    """The read-once kernel's dynamic shared memory, from its layout
    (csrc/instance_norm.cu::cluster_smem_bytes): rows_per_cta rows of the
    tile for g and for xhat, a float32 buffer [3][threads][vec], the
    block's three sums and the two means per channel of the tile."""
    width = plan["wcc"] * plan["vec"]
    itemsize = 16 // plan["vec"]
    return (2 * plan["rows_per_cta"] * width * itemsize
            + 4 * (3 * plan["threads"] * plan["vec"] + 5 * width))


def _check_cluster(plan, n, s, c):
    assert plan["form"] == "cluster"
    vec = plan["vec"]
    assert plan["q"] * vec == c and plan["q"] % plan["wcc"] == 0
    assert plan["coltiles"] * plan["wcc"] == plan["q"]
    size, rows = plan["size"], plan["rows_per_cta"]
    assert size in conv_block.BWD_CLUSTER_SIZES and size <= H100_MAX_CLUSTER
    assert (size - 1) * rows < s <= size * rows  # every block has rows
    assert plan["threads"] in conv_block.BWD_CLUSTER_THREADS
    assert plan["rr"] * plan["wcc"] == plan["threads"]
    assert plan["grid"] == (size * plan["coltiles"], 1, n)
    assert plan["workspace"] == (n, size, 3, c)
    assert plan["tile_bytes"] == 2 * rows * plan["wcc"] * 16 \
        <= instance_norm.CLUSTER_TILE_BYTES
    smem = _smem_bytes(plan)
    assert smem == plan["smem_bytes"] == instance_norm.bwd_cluster_smem_bytes(
        rows, plan["wcc"], vec, plan["threads"])
    assert smem <= H100_BLOCK_SMEM
    if plan["threads"] == 256:  # two blocks share an SM
        assert 2 * (smem + 1024) <= H100_SM_SMEM
    # the cluster holds the sample's tile: its blocks' shares of g and xhat
    assert size * smem >= 2 * s * plan["wcc"] * 16


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n", [128, 8, 1])
@pytest.mark.parametrize("site", sorted(SITES))
def test_k2b_plan_at_model_l_sites(site, n, itemsize):
    h, w, c = site
    plan = conv_block.bwd_plan(n, h * w, c, itemsize)
    _check_cluster(plan, n, h * w, c)
    assert (plan["threads"], plan["size"], plan["wcc"]) == SITES[site]
    assert plan["vec"] == 16 // itemsize
    # 128-byte rows wherever a cluster can hold them, 64 at 128x128x64
    assert plan["wcc"] * 16 >= (64 if site == (128, 128, 64) else 128)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n", [128, 8, 1])
@pytest.mark.parametrize("shape", RAGGED)
def test_k2b_plan_leaves_ragged_shapes_to_two_phases(shape, n, itemsize):
    h, w, c = shape
    s = h * w
    plan = conv_block.bwd_plan(n, s, c, itemsize)
    assert plan["form"] == "two-phase"
    assert plan == {"form": "two-phase",
                    **instance_norm.bwd_plan(n, s, c, itemsize)}
    assert plan["vec"] == 16 // itemsize  # whole 16-byte lanes still
    assert 1 <= plan["chunks"] <= instance_norm.MAX_CHUNKS
    assert (plan["chunks"] - 1) * plan["rows_per_chunk"] < plan["rows_total"]
    assert plan["rows_total"] * plan["lcm"] == s * c
    assert plan["workspace"] == (n, plan["chunks"], 3, plan["lcm"])


@pytest.mark.parametrize("site", sorted(SITES))
def test_k2b_plan_off_the_16_byte_grid_is_two_phase_by_elements(site):
    h, w, c = site
    plan = conv_block.bwd_plan(4, h * w, c, 4, aligned=False)
    assert plan["form"] == "two-phase" and plan["vec"] == 1


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", sorted(SITES) + RAGGED + [(5, 7, 8)])
def test_every_k2b_cluster_candidate_fits_an_h100(shape, itemsize):
    h, w, c = shape
    found = conv_block.bwd_cluster_candidates(8, h * w, c, itemsize)
    for plan in found:
        _check_cluster(plan, 8, h * w, c)
    # by block size (256 first), cluster size, then widest tile first
    keys = [(conv_block.BWD_CLUSTER_THREADS.index(p["threads"]), p["size"],
             -p["wcc"]) for p in found]
    assert keys == sorted(keys)
    assert conv_block.bwd_cluster_candidates(8, h * w, c, itemsize,
                                             aligned=False) == []


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("site", sorted(SITES))
def test_k1b_keeps_its_own_cluster_rule(site, itemsize):
    """K1b's plan (8 or 16 blocks) is not K2b's; its full shared memory is
    now checked too, which changes none of Model L's sites."""
    h, w, c = site
    k1b = instance_norm.bwd_cluster_plan(128, h * w, c, itemsize)
    assert k1b["size"] in (8, 16)
    assert instance_norm.bwd_cluster_smem_bytes(
        k1b["rows_per_cta"], k1b["wcc"], k1b["vec"]) <= H100_BLOCK_SMEM


def test_k1b_cluster_plan_refuses_a_tile_beyond_a_blocks_shared_memory():
    # bfloat16, 512 vectors a tile: the rows fit 128 KB but the sums and
    # means beside them do not fit 227 KB; a narrower tile is taken
    plan = instance_norm.bwd_cluster_plan(2, 8 * 7, 4096, 2)
    assert plan["wcc"] == 256
    assert instance_norm.bwd_cluster_smem_bytes(
        plan["rows_per_cta"], 512, 8) > H100_BLOCK_SMEM


def test_signatures_match_the_c_entry_points():
    found = {}
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[m.group(1)] = len(m.group(2).split(","))
    for name, argtypes in _build.SIGNATURES.items():
        assert found.get(name) == len(argtypes), name
    assert "ctseg_in_prelu_bwd_saved_cluster" in found
    assert "ctseg_in_prelu_bwd_saved" in found


@pytest.mark.parametrize("alpha", [0.25, -0.1, 0.0])
@pytest.mark.parametrize("shape", [(2, 6, 5, 8), (1, 16, 16, 32),
                                   (3, 7, 9, 12)])
def test_k2b_plain_matches_pallas_in_float64(shape, alpha):
    rng = np.random.default_rng(11)
    g = rng.normal(size=shape)
    xhat = rng.normal(size=shape)
    rsinv = rng.random((shape[0], shape[-1])) + 0.5
    a = np.asarray([alpha])
    dy_ref, da_ref = jax_conv_block.in_prelu_bwd(
        *(jnp.asarray(v) for v in (g, xhat, rsinv, a)), interpret=True)
    before = conv_block.in_prelu_bwd.launches
    dy, da = conv_block.in_prelu_bwd(
        *(torch.from_numpy(v) for v in (g, xhat, rsinv, a)))
    assert conv_block.in_prelu_bwd.launches == before
    assert dy.dtype == da.dtype == torch.float64
    np.testing.assert_allclose(dy.numpy(), np.asarray(dy_ref), rtol=1e-5,
                               atol=1e-6)
    terms = np.abs(g * np.minimum(xhat, 0.0)).sum()
    assert abs(float(da) - float(da_ref[0])) <= 1e-5 * terms
