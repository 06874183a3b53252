"""The arithmetic of the tensor-core K2 forward and the split-spatial K1b.

The CUDA kernels run only on the card (chip_smoke.py holds them to their
plain versions there). What they compute differently from the plain versions
is modelled in plain PyTorch beside them, and held here, on the CPU, with
inputs made by numpy from a seed:

  - `conv_block.split_tf32` and the three-product conv built from it
    (`conv3x3_split_tf32_model`), the float32 path of the tensor-core conv,
    against a float64 conv, up to K = 9 x 1024: no worse than 4x the plain
    float32 conv's error and far below single TF32's; and the whole forward
    built from the models against the JAX package's Pallas kernel
    (interpret mode) at K2's tolerance, 1e-4.
  - the per-tile (count, mean, M2) statistics of the conv's epilogue and
    their combination in tile order (`tile_stats`, `combine_tile_stats`)
    against the two-pass variance, with a ragged last tile and a
    near-constant channel: 1e-6 relative in float32, 1e-12 in float64.
  - the chunked two-phase K1b (`instance_norm_prelu_bwd_chunked`) against
    `instance_norm_prelu_bwd_plain`, at C = 10 and at S no multiple of the
    chunk: 1e-12 in float64, chip_smoke.py's BWD_TOL (1e-5, 1e-4) in
    float32.
  - the wrappers' grid, chunk and workspace arithmetic as pure functions:
    K1b's chunks cover the spatial axis once whatever the shape, a conv
    tile never holds pixels of two samples, and the shapes the tensor-core
    kernel refuses go to the counted FP32-pipe route.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctseg_tpu.ops.pallas import conv_block as jax_conv_block
from ctseg_tpu_torch.ops import conv_block, instance_norm

BWD_TOL = (1e-5, 1e-4)  # chip_smoke.py's float32 (atol, rtol) for dx


def _rng(seed):
    return np.random.default_rng(seed)


def _conv_inputs(n, h, w, cin, cout, seed):
    rng = _rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    bound = 1.0 / math.sqrt(9 * cin)
    wgt = rng.uniform(-bound, bound, size=(3, 3, cin, cout)).astype(np.float32)
    b = rng.uniform(-bound, bound, size=(cout,)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wgt), torch.from_numpy(b)


def _conv64(x, w):
    return F.conv2d(x.double().permute(0, 3, 1, 2),
                    w.double().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)


# --------------------------------------------------------------- split TF32
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_tf32_rounds_to_ten_mantissa_bits(seed):
    rng = _rng(seed)
    v = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096))
    v = torch.from_numpy(v.astype(np.float32))
    big, small = conv_block.split_tf32(v)
    for part in (big, small):
        # tf32: the low 13 of float32's 23 mantissa bits are zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # big is v to nearest: within half a unit of the 10th mantissa bit
    ulp = torch.exp2(torch.floor(torch.log2(v.abs())) - 10)
    assert bool(((v - big).abs() <= 0.5 * ulp).all())
    # and the two together leave about 2^-22 of v
    rest = (v.double() - big.double() - small.double()).abs()
    assert float((rest / v.abs().double()).max()) <= 2.0 ** -21


def test_split_tf32_keeps_what_tf32_holds_and_rejects_other_types():
    v = torch.tensor([0.0, 1.0, -1.5, 0.15625, 1024.0, -3.0e-5])
    v = conv_block.split_tf32(v)[0]  # now exactly representable
    big, small = conv_block.split_tf32(v)
    assert torch.equal(big, v)
    assert torch.equal(small, torch.zeros_like(v))
    # ties go away from zero, as cvt.rna: 1 + 2^-11 -> 1 + 2^-10
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(conv_block.split_tf32(tie)[0],
                       torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))
    with pytest.raises(TypeError):
        conv_block.split_tf32(v.double())


@pytest.mark.parametrize("shape", [
    (2, 4, 4, 1024, 8),    # K = 9 x 1024, the bottom unit's depth
    (1, 6, 5, 512, 16),
    (2, 9, 7, 64, 24),
    (1, 12, 12, 8, 8),
])
def test_three_product_conv_keeps_float32_accuracy(shape):
    x, w, _ = _conv_inputs(*shape, seed=sum(shape))
    ref = _conv64(x, w)
    plain = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     padding=1).permute(0, 2, 3, 1)
    split = conv_block.conv3x3_split_tf32_model(x, w)
    a_big = conv_block.split_tf32(x.permute(0, 3, 1, 2))[0]
    b_big = conv_block.split_tf32(w.permute(3, 2, 0, 1))[0]
    single = F.conv2d(a_big, b_big, padding=1).permute(0, 2, 3, 1)

    err_plain = float((plain.double() - ref).abs().max())
    err_split = float((split.double() - ref).abs().max())
    err_single = float((single.double() - ref).abs().max())
    assert split.dtype == torch.float32 and split.shape == ref.shape
    assert err_split <= 4.0 * err_plain
    assert err_split <= err_single / 20.0


@pytest.mark.parametrize("alpha", [0.25, -0.1])
@pytest.mark.parametrize("shape", [(2, 12, 12, 8, 16), (1, 20, 13, 16, 8)])
def test_modelled_forward_matches_pallas(shape, alpha):
    """The three-product conv + bias, the tiles' statistics combined in
    order, normalize, PReLU: the tensor-core forward's arithmetic, against
    the Pallas kernel in interpret mode at K2's tolerance."""
    x, w, b = _conv_inputs(*shape, seed=7)
    a = np.asarray([alpha], np.float32)
    y = conv_block.conv3x3_split_tf32_model(x, w) + b
    n, h, wd, cout = y.shape
    count, mean, m2 = conv_block.tile_stats(y.reshape(n, h * wd, cout))
    mu, var = conv_block.combine_tile_stats(count, mean, m2)
    xhat = (y - mu[:, None, None]) * torch.rsqrt(var[:, None, None] + 1e-5)
    ours = torch.where(xhat >= 0, xhat, float(alpha) * xhat).numpy()
    assert mean.shape[1] == -(-(h * wd) // conv_block.TILE_M)

    fused = np.asarray(jax_conv_block.fused_conv3x3_in_prelu(
        *[jnp.asarray(v) for v in (x.numpy(), w.numpy(), b.numpy(), a)], True))
    np.testing.assert_allclose(ours, fused, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        ours, conv_block.conv3x3_in_prelu_plain(
            x, w, b, torch.from_numpy(a)).numpy(), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ tile-wise statistics
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("s,tile", [(300, 128), (256, 128), (100, 128),
                                    (1000, 64), (37, 8)])
def test_tile_statistics_combine_to_the_two_pass_variance(s, tile, dtype, rtol):
    rng = _rng(s + tile)
    y = rng.normal(0.7, 1.3, size=(3, s, 6))
    y[..., 0] = 3.0 + 1e-6 * y[..., 0]   # near-constant channel
    y[..., 1] = 5.0 + y[..., 1]          # a mean 4 times the spread
    y = torch.from_numpy(y).to(dtype)
    count, mean, m2 = conv_block.tile_stats(y, tile)
    assert count.tolist() == [min(tile, s - t) for t in range(0, s, tile)]
    assert float(count.sum()) == s
    mu, var = conv_block.combine_tile_stats(count, mean, m2)

    ref = y.double()
    ref_mu = ref.mean(dim=1)
    ref_var = torch.square(ref - ref_mu[:, None]).mean(dim=1)
    assert mu.dtype == dtype and var.dtype == dtype
    np.testing.assert_allclose(mu.double().numpy(), ref_mu.numpy(),
                               rtol=rtol, atol=0.0)
    np.testing.assert_allclose(var[:, 1:].double().numpy(),
                               ref_var[:, 1:].numpy(), rtol=rtol, atol=0.0)
    # The near-constant channel's spread (1.3e-6) is within a few roundings
    # of its mean (3.0) in either type, so its variance (1.7e-12) is held as
    # the norm uses it, as var + eps: Chan's form has no E[y^2] - E[y]^2
    # cancellation, which would leave nothing of it.
    np.testing.assert_allclose(var[:, 0].double().numpy() + conv_block.EPS,
                               ref_var[:, 0].numpy() + conv_block.EPS,
                               rtol=rtol, atol=0.0)
    assert bool((var[:, 0] > 0).all())
    np.testing.assert_allclose(var[:, 0].double().numpy(),
                               ref_var[:, 0].numpy(), rtol=0.1)


def test_one_tile_is_the_plain_two_pass():
    y = torch.from_numpy(_rng(5).normal(size=(2, 50, 4)))
    count, mean, m2 = conv_block.tile_stats(y, 128)
    mu, var = conv_block.combine_tile_stats(count, mean, m2)
    assert torch.equal(mu, y.mean(dim=1))
    assert torch.equal(var, torch.square(y - y.mean(dim=1, keepdim=True))
                       .sum(dim=1) / 50)


# ------------------------------------------------------------- chunked K1b
def _k1b_inputs(shape, seed, dtype):
    rng = _rng(seed)
    x = rng.normal(0.5, 1.5, size=shape)
    x[..., 0] = 3.0 + 1e-6 * x[..., 0]
    g = rng.normal(size=shape)
    x, g = torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype)
    _, mean, var = instance_norm._fwd_plain(x, torch.tensor([0.25], dtype=dtype))
    return x, g, mean, var


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("alpha", [0.25, -0.1, 0.0])
@pytest.mark.parametrize("shape,chunk", [
    ((3, 16, 16, 10), 64),    # C = 10, the top decoder level's width
    ((2, 7, 9, 10), 16),      # S = 63, no multiple of the chunk
    ((2, 12, 10, 32), 50),    # ragged last chunk
    ((1, 5, 5, 3), 1),        # one pixel a chunk
    ((2, 6, 6, 64), 36),      # one chunk: the plain order
])
def test_chunked_k1b_matches_plain(shape, chunk, alpha, dtype):
    x, g, mean, var = _k1b_inputs(shape, seed=len(shape) + chunk, dtype=dtype)
    a = torch.tensor([alpha], dtype=dtype)
    dx, da = instance_norm.instance_norm_prelu_bwd_chunked(
        x, g, mean, var, a, chunk)
    pdx, pda = instance_norm.instance_norm_prelu_bwd_plain(x, g, mean, var, a)
    assert dx.shape == x.shape and dx.dtype == dtype and da.shape == (1,)
    if dtype == torch.float64:
        # Channel 0 is near-constant: dx carries rsqrt(var + eps) = 316.
        np.testing.assert_allclose(dx.numpy(), pdx.numpy(), rtol=1e-12,
                                   atol=1e-12 * 316)
        np.testing.assert_allclose(da.numpy(), pda.numpy(), rtol=1e-12,
                                   atol=1e-12)
    else:
        atol, rtol = BWD_TOL
        scale = torch.clamp_min(torch.rsqrt(var + instance_norm.EPS), 1.0)
        scale = scale.reshape((shape[0],) + (1,) * (len(shape) - 2) + (-1,))
        err = (dx - pdx).abs()
        assert bool((err <= atol * scale + rtol * pdx.abs()).all())
        terms = float((g * torch.clamp_max(
            (x - mean.reshape(scale.shape)) * torch.rsqrt(
                var.reshape(scale.shape) + instance_norm.EPS), 0.0)).abs().sum())
        assert abs(float(da) - float(pda)) <= 1e-5 + 1e-5 * terms


# ------------------------------------------------- K1b's plan (pure function)
K1B_SHAPES = [
    # (n, s, c, itemsize)
    (128, 256 * 256, 10, 4), (128, 256 * 256, 10, 2),
    (128, 128 * 128, 64, 4), (128, 64 * 64, 128, 2),
    (128, 32 * 32, 256, 4), (128, 16 * 16, 512, 4), (128, 16 * 16, 1024, 2),
    (32, 16 * 16, 1024, 4), (1, 256 * 256, 10, 4), (2, 35, 3, 4),
    (5, 36, 10, 4), (5, 16, 1030, 4), (3, 7, 2051, 2), (1, 1, 1, 4),
    (4, 6, 4100, 4), (7, 1000, 24, 2),
]


@pytest.mark.parametrize("n,s,c,itemsize", K1B_SHAPES)
def test_k1b_plan_covers_the_sample_once(n, s, c, itemsize):
    plan = instance_norm.bwd_plan(n, s, c, itemsize)
    vec, q, wc, rr = plan["vec"], plan["q"], plan["wc"], plan["rr"]
    assert vec in (1, 16 // itemsize)
    assert vec == 16 // itemsize or (s * c) % (16 // itemsize) != 0
    # a super-row: lcm(c, vec) elements, after which the channels repeat
    assert plan["lcm"] == q * vec == math.lcm(c, vec)
    assert plan["rows_total"] * plan["lcm"] == s * c
    # the block: at most 256 threads, all columns covered by the tiles
    assert 1 <= wc * rr <= instance_norm.BWD_THREADS
    assert wc * plan["coltiles"] >= q > wc * (plan["coltiles"] - 1)
    # the chunks cover the super-rows once, the last one not empty
    chunks, per = plan["chunks"], plan["rows_per_chunk"]
    edges = [(i * per, min((i + 1) * per, plan["rows_total"]))
             for i in range(chunks)]
    assert edges[0][0] == 0 and edges[-1][1] == plan["rows_total"]
    assert all(a < b for a, b in edges)
    assert all(edges[i][1] == edges[i + 1][0] for i in range(chunks - 1))
    assert plan["grid"] == (plan["coltiles"], chunks, n)
    assert plan["workspace"] == (n, chunks, 3, plan["lcm"])
    assert chunks <= 65535


def test_k1b_plan_fills_the_card_at_the_train_step_sites():
    """Every IN+PReLU site of Model L's step gets at least 8 blocks an SM,
    and at C = 10 all but one of a block's 256 lanes work."""
    for s, c in [(65536, 10), (16384, 64), (4096, 128), (1024, 256),
                 (256, 512)]:
        for itemsize in (4, 2):
            plan = instance_norm.bwd_plan(128, s, c, itemsize)
            blocks = plan["grid"][0] * plan["grid"][1] * plan["grid"][2]
            assert blocks >= 132 * 8
            assert plan["vec"] == 16 // itemsize
    top = instance_norm.bwd_plan(128, 65536, 10, 4)
    assert (top["q"], top["wc"], top["rr"]) == (5, 5, 51)
    assert top["wc"] * top["rr"] == 255


def test_k1b_plan_goes_scalar_for_unaligned_samples():
    assert instance_norm.bwd_plan(2, 35, 3, 4)["vec"] == 1       # 105 % 4
    assert instance_norm.bwd_plan(2, 36, 3, 4)["vec"] == 4
    assert instance_norm.bwd_plan(2, 36, 3, 4, aligned=False)["vec"] == 1
    assert instance_norm.bwd_plan(2, 36, 3, 2)["vec"] == 1       # 108 % 8
    assert instance_norm.bwd_plan(2, 40, 3, 2)["vec"] == 8


@pytest.mark.parametrize("s,c,itemsize,size,wcc", [
    (64 * 64, 128, 4, 8, 8), (64 * 64, 128, 2, 8, 8),
    (32 * 32, 256, 4, 8, 32), (16 * 16, 512, 4, 8, 128),
    (16 * 16, 512, 2, 8, 64), (16 * 16, 1024, 4, 8, 128),
    (128 * 128, 64, 4, 16, 4), (128 * 128, 64, 2, 16, 4), (100, 64, 4, 8, 16),
])
def test_k1b_cluster_plan_holds_the_tile_in_shared_memory(s, c, itemsize,
                                                          size, wcc):
    plan = instance_norm.bwd_cluster_plan(128, s, c, itemsize)
    assert (plan["size"], plan["wcc"]) == (size, wcc)
    vec = 16 // itemsize
    assert plan["vec"] == vec and plan["q"] * vec == c
    # the tiles cover the channels once, the blocks the pixels once
    assert plan["coltiles"] * wcc == plan["q"]
    assert (size - 1) * plan["rows_per_cta"] < s <= size * plan["rows_per_cta"]
    assert plan["grid"] == (size * plan["coltiles"], 1, 128)
    assert plan["workspace"] == (128, size, 3, c)
    # a block's rows of x and g fit, each row at least 64 bytes
    assert 2 * plan["rows_per_cta"] * wcc * 16 <= instance_norm.CLUSTER_TILE_BYTES
    assert wcc * 16 >= (128 if size == 8 else 64)
    assert instance_norm.CLUSTER_THREADS % wcc == 0
    assert plan["rr"] * wcc == instance_norm.CLUSTER_THREADS


@pytest.mark.parametrize("s,c,itemsize,aligned", [
    (256 * 256, 10, 4, True),   # 40-byte pixel rows
    (256 * 256, 10, 2, True),
    (36, 3, 4, True), (16, 1030, 4, True),  # channels are no whole vectors
    (64 * 64, 128, 4, False),   # a view off the 16-byte grid
    (512 * 512, 64, 4, True),   # 16 blocks cannot hold 64-byte rows of it
])
def test_k1b_cluster_plan_leaves_the_rest_to_two_phases(s, c, itemsize, aligned):
    assert instance_norm.bwd_cluster_plan(4, s, c, itemsize, aligned) is None
    plan = instance_norm.bwd_plan(4, s, c, itemsize, aligned)
    assert plan["chunks"] >= 1 and plan["rows_total"] * plan["lcm"] == s * c


# ---------------------------------------- K2's route and grid (pure functions)
@pytest.mark.parametrize("cin,cout,h,w,aligned,route", [
    (64, 64, 128, 128, True, "tc"), (1024, 1024, 16, 16, True, "tc"),
    (512, 1024, 16, 16, True, "tc"), (8, 8, 1, 1, True, "tc"),
    (24, 40, 20, 12, True, "tc"),
    (3, 64, 256, 256, True, "simt"),    # the stem's 3 input channels
    (64, 10, 256, 256, True, "simt"),   # 10 classes out
    (6, 5, 9, 7, True, "simt"), (12, 16, 8, 8, True, "simt"),
    (64, 64, 40000, 4, True, "simt"),   # a row index past 15 bits
    (64, 64, 128, 128, False, "simt"),  # a view off the 16-byte grid
])
def test_conv_route_is_a_shape_rule(cin, cout, h, w, aligned, route):
    assert conv_block.conv_route(cin, cout, h, w, aligned) == route


@pytest.mark.parametrize("n,h,w,cout", [
    (32, 128, 128, 64), (32, 16, 16, 1024), (128, 64, 64, 128), (3, 20, 12, 40),
    (3, 7, 9, 136), (1, 1, 1, 8), (5, 129, 1, 192),
])
def test_conv_tiles_never_straddle_two_samples(n, h, w, cout):
    grid, stats = conv_block.conv_grid(n, h, w, cout)
    tiles, ctiles, gn = grid
    m = conv_block.TILE_M
    assert gn == n and stats == (n, tiles, cout, 2)
    # tiles are cut inside one sample: together they cover its pixels once,
    # only the last is ragged, and there is one grid plane a sample
    assert (tiles - 1) * m < h * w <= tiles * m
    block_n = 128 if cout % 128 == 0 else 64
    assert (ctiles - 1) * block_n < cout <= ctiles * block_n
    # the counts the finalize kernel derives from the tile's index
    counts = [min(m, h * w - t * m) for t in range(tiles)]
    assert sum(counts) == h * w and min(counts) >= 1


@pytest.mark.parametrize("cin,cout,itemsize,shape", [
    (64, 64, 4, (2, 9, 64, 64)), (64, 64, 2, (1, 9, 64, 64)),
    (1024, 1024, 4, (2, 9, 1024, 1024)), (1024, 512, 2, (1, 9, 1024, 512)),
    (8, 136, 4, (2, 9, 32, 136)), (8, 136, 2, (1, 9, 64, 136)),
    (72, 40, 4, (2, 9, 96, 40)), (72, 40, 2, (1, 9, 128, 40)),
])
def test_conv_weights_workspace_holds_whole_pipeline_steps(cin, cout,
                                                           itemsize, shape):
    """The re-laid weights: Cin rounded up to steps of 128 bytes, and the
    big and small planes for float32 only."""
    got = conv_block.weights_workspace(cin, cout, itemsize)
    assert got == shape
    step = 128 // itemsize
    assert got[2] % step == 0 and 0 <= got[2] - cin < step


def test_cpu_tensors_never_count_a_launch():
    x, w, b = _conv_inputs(1, 4, 4, 8, 8, seed=0)
    before = (conv_block.conv3x3_in_prelu.launches,
              conv_block.conv3x3_in_prelu.launches_simt,
              instance_norm.instance_norm_prelu_bwd.launches)
    conv_block.conv3x3_in_prelu(x, w, b, torch.tensor([0.25]))
    xs, g, mean, var = _k1b_inputs((1, 4, 4, 10), 1, torch.float32)
    instance_norm.instance_norm_prelu_bwd(xs, g, mean, var,
                                          torch.tensor([0.25]))
    assert before == (conv_block.conv3x3_in_prelu.launches,
                      conv_block.conv3x3_in_prelu.launches_simt,
                      instance_norm.instance_norm_prelu_bwd.launches)
