"""The training slice's kernel modules and losses against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version (chip_smoke.py
holds the CUDA kernels to those on the card). Inputs are made with numpy
from a seed and go through both packages:

  - K1b (ops/instance_norm.py) and K1's autograd gradients vs jax.vjp of
    instance_norm.fused_instance_norm_prelu (Pallas, interpret mode), at a
    resident and a streaming tile shape, alpha > 0, < 0 and = 0: 1e-5
    (float32 sums over H*W terms in another order).
  - K2b (ops/conv_block.py) and all four K2 gradients vs jax.vjp of
    conv_block.fused_conv3x3_in_prelu and its in_prelu_bwd (interpret
    mode): 1e-4 (float32 sums over 9*Cin products and H*W terms).
  - K4 (ops/preprocess.py): with identity draws vs
    preprocess.fused_window_normalize (interpret mode), and with the draws
    JAX's own calls make from each key vs pipelines._degree_2, every
    (k, flip) pair occurring: equal to float32 rounding of the divisions
    (2e-7 relative; in practice bit-equal), labels exactly.
  - Every loss, apply_missing_mask, MultiLoss and the Dice metric vs the
    JAX functions in float64, with and without a sample mask: 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.losses import segmentation as jax_losses
from ctseg_tpu.metrics import dice as jax_dice
from ctseg_tpu.ops.pallas import conv_block as jax_conv_block
from ctseg_tpu.ops.pallas import preprocess as jax_preprocess
from ctseg_tpu.ops.pallas.instance_norm import (
    _pick_tile,
    fused_instance_norm_prelu,
)
from ctseg_tpu.transforms import pipelines as jax_pipelines
from ctseg_tpu_torch.losses import segmentation as losses
from ctseg_tpu_torch.metrics import dice
from ctseg_tpu_torch.ops import conv_block, instance_norm, preprocess
from ctseg_tpu_torch.transforms import augment
from ctseg_tpu_torch.transforms.pipelines import get_transform

ALPHAS = [0.25, -0.1, 0.0]
K1_SHAPES = {
    "resident": (2, 16, 12, 8),
    "streaming": (1, 160, 128, 4),  # h*w*32*4 bytes > the 2 MiB budget
}
K2_SHAPES = [(2, 12, 12, 8, 16), (1, 9, 7, 6, 5)]


def _normal(shape, seed, loc=0.0, scale=1.0):
    return np.random.default_rng(seed).normal(loc, scale, size=shape).astype(
        np.float32
    )


# --------------------------------------------------------------------- K1b
@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("form", sorted(K1_SHAPES))
def test_k1b_and_k1_grads_match_pallas_vjp(form, alpha):
    shape = K1_SHAPES[form]
    n, h, w, c = shape
    assert _pick_tile(c, h, w)[2] == (form == "resident")
    x = _normal(shape, 1, 0.5, 2.0)
    g = _normal(shape, 2)
    a = np.asarray([alpha], np.float32)

    _, vjp = jax.vjp(
        lambda x, a: fused_instance_norm_prelu(x, a, True),
        jnp.asarray(x), jnp.asarray(a),
    )
    dx_ref, da_ref = (np.asarray(v) for v in vjp(jnp.asarray(g)))

    xt = torch.from_numpy(x)
    at = torch.from_numpy(a)
    _, mean, var = instance_norm._fwd_plain(xt, at)
    dx, da = instance_norm.instance_norm_prelu_bwd(
        xt, torch.from_numpy(g), mean, var, at
    )
    np.testing.assert_allclose(dx.numpy(), dx_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(da.numpy(), da_ref, rtol=1e-5, atol=1e-5)

    # autograd: the same numbers through the Function
    xg = xt.clone().requires_grad_()
    ag = at.clone().requires_grad_()
    instance_norm.instance_norm_prelu(xg, ag).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xg.grad.numpy(), dx_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ag.grad.numpy(), da_ref, rtol=1e-5, atol=1e-5)


def test_k1_training_forward_saves_one_pass_statistics():
    x = torch.from_numpy(_normal((2, 5, 6, 3), 3, 1.0, 2.0)).double()
    y, mean, var = instance_norm._fwd_plain(x, torch.tensor([0.25]))
    flat = x.reshape(2, -1, 3)
    torch.testing.assert_close(mean, flat.mean(1), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(var, flat.var(1, unbiased=False),
                               rtol=1e-10, atol=1e-12)
    assert y.dtype == mean.dtype == torch.float64


# --------------------------------------------------------------------- K2b
def _k2_inputs(n, h, w, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    wgt = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    g = rng.normal(size=(n, h, w, cout)).astype(np.float32)
    return x, wgt, b, g


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2b_and_k2_grads_match_pallas_vjp(shape, alpha):
    x, wgt, b, g = _k2_inputs(*shape, seed=4)
    a = np.asarray([alpha], np.float32)
    j = [jnp.asarray(v) for v in (x, wgt, b, a)]
    _, vjp = jax.vjp(
        lambda *t: jax_conv_block.fused_conv3x3_in_prelu(*t, True), *j
    )
    refs = [np.asarray(v) for v in vjp(jnp.asarray(g))]

    # K2b alone, on the residuals of the JAX training forward
    _, xhat, rsinv = jax_conv_block._run_forward(*j, train=True, interpret=True)
    dy_ref, da_ref = jax_conv_block.in_prelu_bwd(
        jnp.asarray(g), xhat, rsinv, j[3], interpret=True
    )
    dy, da = conv_block.in_prelu_bwd(
        torch.from_numpy(g), torch.from_numpy(np.array(xhat)),
        torch.from_numpy(np.array(rsinv)), torch.from_numpy(a),
    )
    np.testing.assert_allclose(dy.numpy(), np.asarray(dy_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(da.numpy(), np.asarray(da_ref), rtol=1e-4,
                               atol=1e-4)

    # the training forward's residuals
    _, pxhat, prsinv = conv_block._fwd_plain(
        *[torch.from_numpy(v) for v in (x, wgt, b, a)]
    )
    np.testing.assert_allclose(pxhat.numpy(), np.asarray(xhat), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(prsinv.numpy(), np.asarray(rsinv), rtol=1e-4,
                               atol=1e-6)

    # all four gradients through the autograd Function
    ts = [torch.from_numpy(v).requires_grad_() for v in (x, wgt, b, a)]
    conv_block.conv3x3_in_prelu(*ts).backward(torch.from_numpy(g))
    for name, t, ref in zip(("dx", "dw", "db", "dalpha"), ts, refs):
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_cpu_backward_launches_no_kernel():
    x, wgt, b, g = _k2_inputs(1, 6, 6, 4, 4, seed=5)
    before = (instance_norm.instance_norm_prelu_bwd.launches,
              conv_block.in_prelu_bwd.launches,
              preprocess.window_normalize_degree2.launches)
    ts = [torch.from_numpy(v).requires_grad_() for v in (x, wgt, b)]
    a = torch.tensor([0.25], requires_grad=True)
    y = conv_block.conv3x3_in_prelu(*ts, a)
    instance_norm.instance_norm_prelu(y, a).sum().backward()
    preprocess.window_normalize_degree2(
        torch.zeros(2, 8, 8), preprocess.identity_draws(2), 8
    )
    assert all(t.grad is not None for t in ts) and a.grad is not None
    after = (instance_norm.instance_norm_prelu_bwd.launches,
             conv_block.in_prelu_bwd.launches,
             preprocess.window_normalize_degree2.launches)
    assert after == before


# ---------------------------------------------------------------------- K4
def test_k4_identity_draws_match_fused_window_normalize():
    images = np.random.default_rng(6).uniform(-1200, 2200, size=(3, 24, 24))
    images = images.astype(np.float32)
    ours = preprocess.window_normalize_degree2(
        torch.from_numpy(images), preprocess.identity_draws(3), 24
    ).numpy()
    ref = np.asarray(jax_preprocess.fused_window_normalize(
        jnp.asarray(images), interpret=True
    ))
    assert ours.shape == ref.shape == (3, 24, 24, 3)
    np.testing.assert_allclose(ours, ref, rtol=2e-7, atol=2e-7)


def _jax_degree2_draws(keys, h, w, size):
    """The parameters pipelines._degree_2 draws from each key
    (augment.py:69-71, 82, 92-93), as the port's Degree2Draws."""
    tops, lefts, ks, flips = [], [], [], []
    for key in keys:
        k1, k2, k3 = jax.random.split(key, 3)
        kh, kw = jax.random.split(k1)
        tops.append(int(jax.random.randint(kh, (), 0, h - size + 1)))
        lefts.append(int(jax.random.randint(kw, (), 0, w - size + 1)))
        kp, kk = jax.random.split(k2)
        ks.append(int(jnp.where(jax.random.bernoulli(kp, 0.5),
                                jax.random.randint(kk, (), 0, 4), 0)))
        flips.append(int(jax.random.bernoulli(k3, 0.5)))
    return augment.Degree2Draws(*(
        torch.tensor(v, dtype=torch.int32) for v in (tops, lefts, ks, flips)
    ))


def test_k4_and_label_moves_match_jax_degree2():
    n, h, w, size = 24, 30, 34, 20
    rng = np.random.default_rng(7)
    images = rng.uniform(-1200, 2200, size=(n, h, w)).astype(np.float32)
    labels = rng.integers(0, 10, size=(n, h, w)).astype(np.int32)
    keys = jax.random.split(jax.random.key(11), n)
    draws = _jax_degree2_draws(keys, h, w, size)
    pairs = set(zip(draws.k.tolist(), draws.flip.tolist()))
    assert pairs == {(k, f) for k in range(4) for f in range(2)}

    ref_img, ref_lab = jax.vmap(
        functools.partial(jax_pipelines._degree_2, size=(size, size))
    )(keys, jnp.asarray(images), jnp.asarray(labels))
    ours_img, ours_lab = get_transform(2, train=True, size=(size, size))(
        torch.from_numpy(images), torch.from_numpy(labels), draws
    )
    assert ours_img.shape == (n, size, size, 3) and ours_img.is_contiguous()
    np.testing.assert_allclose(ours_img.numpy(), np.asarray(ref_img),
                               rtol=2e-7, atol=2e-7)
    np.testing.assert_array_equal(ours_lab.numpy(), np.asarray(ref_lab))


def test_degree2_draws_are_in_range_and_seeded():
    a = augment.draw_degree2(torch.Generator().manual_seed(3), 4000, 40, 33, 32)
    b = augment.draw_degree2(torch.Generator().manual_seed(3), 4000, 40, 33, 32)
    for x, y in zip(a, b):
        assert torch.equal(x, y) and x.dtype == torch.int32
    assert 0 <= int(a.top.min()) and int(a.top.max()) == 8
    assert 0 <= int(a.left.min()) and int(a.left.max()) == 1
    assert set(a.k.tolist()) == {0, 1, 2, 3} and set(a.flip.tolist()) == {0, 1}
    # k = 0 with p = 0.5 + 0.5/4; a flip with p = 0.5
    assert abs(float((a.k == 0).float().mean()) - 0.625) < 0.03
    assert abs(float(a.flip.float().mean()) - 0.5) < 0.03
    with pytest.raises(ValueError):
        augment.draw_degree2(None, 2, 20, 40, 32)


# ------------------------------------------------------------------ losses
LOSS_NAMES = ["CrossEntropy", "WeightedCrossEntropy", "Focal", "Dice",
              "GeneralizedDice"]


def _loss_inputs(seed=8, n=4, hw=(6, 5), c=10):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, *hw, c)) * 2.0
    labels = rng.integers(0, c, size=(n, *hw))
    labels[0] = 0  # a sample with only background: empty classes
    indicators = rng.integers(0, 2, size=(n, c - 1)).astype(np.float64)
    indicators[1] = 1.0  # all structures present: Focal's background column
    mask = np.array([True, True, False, True])
    return logits, labels, indicators, mask


def _port(logits):
    return torch.from_numpy(np.moveaxis(logits, -1, 1).copy())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_losses_match_jax(name, reduction, masked):
    logits, labels, _, mask = _loss_inputs()
    kw = {"sample_mask": mask} if masked else {}
    ref = np.asarray(jax_losses.LOSSES[name](
        jnp.asarray(logits), jnp.asarray(labels), reduction=reduction,
        **{k: jnp.asarray(v) for k, v in kw.items()},
    ))
    ours = losses.LOSSES[name](
        _port(logits), torch.from_numpy(labels), reduction=reduction,
        **{k: torch.from_numpy(v) for k, v in kw.items()},
    ).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["Focal", "Dice"])
def test_missing_mask_and_multiloss_match_jax(name, masked):
    logits, labels, indicators, mask = _loss_inputs(seed=9)
    sm_j = jnp.asarray(mask) if masked else None
    sm_t = torch.from_numpy(mask) if masked else None
    matrix = np.asarray(jax_losses.LOSSES[name](
        jnp.asarray(logits), jnp.asarray(labels), reduction="none"))
    ref = jax_losses.apply_missing_mask(name, jnp.asarray(matrix),
                                        jnp.asarray(indicators), sm_j)
    ours = losses.apply_missing_mask(name, torch.from_numpy(matrix),
                                     torch.from_numpy(indicators), sm_t)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)

    for exclude in (False, True):
        ref = jax_losses.MultiLoss(["Focal", "Dice", "CrossEntropy"], exclude)(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(indicators),
            sample_mask=sm_j)
        ours = losses.MultiLoss(["Focal", "Dice", "CrossEntropy"], exclude)(
            _port(logits), torch.from_numpy(labels),
            torch.from_numpy(indicators), sample_mask=sm_t)
        assert list(ours) == list(ref) == ["CrossEntropy", "Dice", "Focal"]
        for k in ref:
            np.testing.assert_allclose(float(ours[k]), float(ref[k]),
                                       rtol=1e-12, atol=1e-12, err_msg=k)


def test_boundary_loss_waits_for_the_edt_kernel():
    """It waited for K5; now it only asks for its distance maps (its
    values are held to the JAX loss in tests/test_torch_eval_kernels.py)."""
    logits, labels, _, _ = _loss_inputs()
    with pytest.raises(ValueError, match="distance maps"):
        losses.MultiLoss(["Boundary"])(_port(logits), torch.from_numpy(labels))
    maps = torch.zeros((4, 9, 6, 5), dtype=torch.float64)
    values = losses.MultiLoss(["Boundary"])(
        _port(logits), torch.from_numpy(labels), dist_maps=maps)
    assert float(values["Boundary"]) == 0.0


def test_dice_metric_matches_jax():
    rng = np.random.default_rng(10)
    target = rng.integers(0, 10, size=(5, 7, 6))
    pred = np.where(rng.random(target.shape) < 0.6, target,
                    rng.integers(0, 10, size=target.shape))
    target[2] = 0  # a sample with no structure: all invalid
    pred[3] = 0
    d_ref, v_ref = jax_dice.dice_per_sample_class(jnp.asarray(pred),
                                                  jnp.asarray(target))
    d, v = dice.dice_per_sample_class(torch.from_numpy(pred),
                                      torch.from_numpy(target))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-6)
    row_valid = np.array([True, False, True, True, True])
    m_ref, c_ref = jax_dice.masked_mean_batch(
        d_ref, jnp.logical_and(v_ref, jnp.asarray(row_valid)[:, None]))
    m, cnt = dice.masked_mean_batch(d, v & torch.from_numpy(row_valid)[:, None])
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-6)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(c_ref))
    mean_ref, per_ref = jax_dice.DiceMetric()(jnp.asarray(pred),
                                              jnp.asarray(target))
    mean, per = dice.DiceMetric()(torch.from_numpy(pred),
                                  torch.from_numpy(target))
    np.testing.assert_allclose(per.numpy(), np.asarray(per_ref), rtol=1e-6)
    np.testing.assert_allclose(float(mean), float(mean_ref), rtol=1e-6)
