"""The train transforms of degrees 0, 1, 3 and 4 against the JAX package.

Inputs are made with numpy from a seed and go through both packages on the
CPU. The port's warps are 1D gathers of two taps; the reference's are
interpolation matmuls of the same weights (augment.py:136-181, 337-358):

  - `_reflect_101` equal for negative, large and length-1 coordinates.
  - Each shear pass at the same coordinates: order 1 within 1e-6 (the
    einsum may fuse a tap's product into the sum), order 0 equal.
  - `_distortion_map` equal at lengths 64, 97, 256 and 512, 5 and 7 steps,
    and where the stretch overshoots the length and the last cell folds
    back; `grid_distortion` equal (images 1e-6, labels exactly) on the
    reference's own draws, replayed from its `jax.random` calls.
  - The elastic fast branch on replayed draws. The port solves the affine
    in closed form in float64 and rounds the six shear parameters once;
    the reference solves it by LU in float32. Its parameters are held to
    the reference's at 1e-5 relative (their coordinates within 1e-4 px),
    its images within 1e-3 (a coordinate's error times an intensity step
    of up to 1 per pixel, over the std), and its labels equal except at
    pixels whose source coordinate lies within 1e-3 of a half-integer in
    either pass. At the reference's own parameters the warp is equal
    (images 1e-6, labels exactly).
  - The general branch (alpha >= sigma / 10): `map_coordinates` against
    jax.scipy.ndimage.map_coordinates at the same coordinates, orders 1
    (1e-6) and 0 (equal); the Gaussian blur to 1e-6; the whole branch on
    replayed fields within 1e-3 and labels equal except near halves.
  - Degrees 0, 1, 3 and 4 end to end against the eager JAX
    `batched_transform` on replayed draws, each with its tolerance below.
  - The draws' distributions: ranges, p = 0.5, a uniform choice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.ndimage import map_coordinates as jax_map_coordinates

from ctseg_tpu.transforms import augment as jax_augment
from ctseg_tpu.transforms import pipelines as jax_pipelines
from ctseg_tpu_torch.transforms import augment
from ctseg_tpu_torch.transforms.pipelines import get_transform

RAW, SIZE, N = 72, 64, 6


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _images(seed, n=N, h=RAW, w=RAW):
    rng = np.random.default_rng(seed)
    images = rng.normal(40, 300, size=(n, h, w)).astype(np.float32)
    labels = rng.integers(0, 10, size=(n, h, w)).astype(np.int32)
    return images, labels


def _windowed(seed, n=N, size=SIZE, channels=3):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, size=(n, size, size, channels))
    return (images.astype(np.float32),
            rng.integers(0, 10, size=(n, size, size)).astype(np.int32))


# ------------------------------------------------------------ replayed draws
def _jax_elastic(key):
    """(apply, jitter) of elastic_transform's calls (augment.py:240, 252-254,
    301)."""
    k_apply, k_aff, _, _ = jax.random.split(key, 4)
    jitter = jax.random.uniform(k_aff, (3, 2), jnp.float32, -50.0, 50.0)
    return bool(jax.random.bernoulli(k_apply, 0.5)), np.asarray(jitter)


def _jax_grid(key):
    """(apply, steps_x, steps_y) of grid_distortion's calls (augment.py:
    316-318, 376, 389)."""
    k_apply, kx, ky = jax.random.split(key, 3)
    steps = [np.asarray(1.0 + jax.random.uniform(k, (6,), jnp.float32,
                                                 -0.3, 0.3))
             for k in (kx, ky)]
    return bool(jax.random.bernoulli(k_apply, 0.5)), steps[0], steps[1]


def _elastic_draws(keys):
    got = [_jax_elastic(k) for k in keys]
    return augment.ElasticDraws(_t([a for a, _ in got]),
                                _t(np.stack([j for _, j in got])))


def _grid_draws(keys):
    got = [_jax_grid(k) for k in keys]
    return augment.GridDraws(_t([a for a, _, _ in got]),
                             _t(np.stack([x for _, x, _ in got])),
                             _t(np.stack([y for _, _, y in got])))


def _crop(key, h, w, size):
    kh, kw = jax.random.split(key)
    return (int(jax.random.randint(kh, (), 0, h - size + 1)),
            int(jax.random.randint(kw, (), 0, w - size + 1)))


def _rot_flip(k_rot, k_flip):
    kp, kk = jax.random.split(k_rot)
    k = int(jnp.where(jax.random.bernoulli(kp, 0.5),
                      jax.random.randint(kk, (), 0, 4), 0))
    return k, int(jax.random.bernoulli(k_flip, 0.5))


def _degree4_draws(keys, h, w, size):
    """The draws of pipelines._degree_4 (and _degree_0) from each key."""
    crops, choices, ops = [], [], []
    for key in keys:
        k1, k2 = jax.random.split(key)
        crops.append(_crop(k1, h, w, size))
        k_pick, k_op = jax.random.split(k2)
        choices.append(int(jax.random.randint(k_pick, (), 0, 2)))
        ops.append(k_op)
    i32 = torch.int32
    return augment.Degree4Draws(
        _t([c[0] for c in crops], i32), _t([c[1] for c in crops], i32),
        _t(choices, i32), _elastic_draws(ops), _grid_draws(ops))


def _degree3_draws(keys, h, w, size):
    """The draws of pipelines._degree_3 from each key."""
    rows = []
    for key in keys:
        k1, k2, k3, k4 = jax.random.split(key, 4)
        rows.append((_crop(k1, h, w, size), k2, _rot_flip(k3, k4)))
    i32 = torch.int32
    return augment.Degree3Draws(
        _t([r[0][0] for r in rows], i32), _t([r[0][1] for r in rows], i32),
        _elastic_draws([r[1] for r in rows]),
        _t([r[2][0] for r in rows], i32), _t([r[2][1] for r in rows], i32))


def _keys(seed, n=N):
    return list(jax.random.split(jax.random.key(seed), n))


def _jax_batched(degree, keys, images, labels, size=SIZE):
    fn = jax_pipelines.get_transform(degree, True, (size, size))
    img, lab = jax.vmap(fn)(jnp.stack(keys), jnp.asarray(images),
                            jnp.asarray(labels))
    return np.asarray(img), np.asarray(lab)


# --------------------------------------------- the label rule near a half
def _near_half(c, eps):
    return np.abs(c - np.floor(c) - 0.5) < eps


def _label_risk(cy, cx, eps):
    """Output pixels whose label may round either way: the horizontal
    coordinate near a half, or a mid-pass pixel it may read whose vertical
    coordinate is near a half. cy, cx (N, H, W) numpy."""
    risk_v = _near_half(cy, eps)
    n, h, w = cy.shape
    rows = np.arange(h)[None, :, None]
    samples = np.arange(n)[:, None, None]
    lo = np.clip(np.floor(cx).astype(int), 0, w - 1)
    hi = np.clip(lo + 1, 0, w - 1)
    return (_near_half(cx, eps) | risk_v[samples, rows, lo]
            | risk_v[samples, rows, hi])


def _assert_labels(ours, theirs, risk):
    differ = ours != theirs
    assert not np.any(differ & ~risk), int(np.sum(differ & ~risk))


# ------------------------------------------------------------------- tests
def test_reflect_101_is_equal():
    coords = np.array([-1e4, -513.25, -256.0, -255.5, -3.75, -1.0, -0.25, 0.0,
                       0.5, 62.99, 63.0, 63.5, 126.0, 127.3, 1e4 + 0.125,
                       3.5e5], np.float32)
    for length in (1, 2, 64, 97):
        np.testing.assert_array_equal(
            augment._reflect_101(_t(coords), length).numpy(),
            np.asarray(jax_augment._reflect_101(jnp.asarray(coords), length)))


@pytest.mark.parametrize("order", [1, 0])
@pytest.mark.parametrize("channels", [3, 1])
def test_shear_passes_match_the_einsum_form(order, channels):
    img, lab = _windowed(0, n=3, channels=channels)
    rng = np.random.default_rng(1)
    params = rng.uniform([0.8, -0.2, -10.0], [1.2, 0.2, 10.0], size=(3, 3))
    x = lab.astype(np.float32) if order == 0 else img
    ar = jnp.arange(SIZE, dtype=jnp.float32)
    ys, xs = ar[:, None], ar[None, :]
    for n, (a, b, t) in enumerate(params.astype(np.float32)):
        a, b, t = (np.float32(v) for v in (a, b, t))
        ref_v = np.asarray(jax_augment._shear_pass_vertical(
            jnp.asarray(x[n]), a, b, t, order))
        ref_h = np.asarray(jax_augment._shear_pass_horizontal(
            jnp.asarray(x[n]), a, b, t, order))
        # the reference's coordinates, (y, x) order
        cy = jax_augment._reflect_101(a * ys + b * xs + t, SIZE)
        cx = jax_augment._reflect_101(a * xs + b * ys + t, SIZE)
        src = _t(x[n:n + 1]) if order == 1 else _t(lab[n:n + 1])
        ours_v = augment.shear_pass(src, _t(np.asarray(cy))[None], 1, order)
        ours_h = augment.shear_pass(src, _t(np.asarray(cx))[None], 2, order)
        if order == 1:
            np.testing.assert_allclose(ours_v[0].numpy(), ref_v, atol=1e-6)
            np.testing.assert_allclose(ours_h[0].numpy(), ref_h, atol=1e-6)
        else:
            np.testing.assert_array_equal(ours_v[0].numpy(), ref_v)
            np.testing.assert_array_equal(ours_h[0].numpy(), ref_h)


@pytest.mark.parametrize("length", [64, 97, 256, 512])
@pytest.mark.parametrize("num_steps", [5, 7])
def test_distortion_map_is_equal(length, num_steps):
    keys = _keys(length + num_steps, 8)
    steps = [np.asarray(1.0 + jax.random.uniform(k, (num_steps + 1,),
                                                 jnp.float32, -0.3, 0.3))
             for k in keys]
    ours = augment.distortion_map(_t(np.stack(steps)), length).numpy()
    for k, row in zip(keys, ours):
        np.testing.assert_array_equal(
            row, np.asarray(jax_augment._distortion_map(k, length, num_steps,
                                                        0.3)))


def test_distortion_map_folds_back_as_the_reference(monkeypatch):
    """Every step at 1.3: the cells overshoot the length and the forced last
    segment runs backwards (augment.py:311-317). The reference's draw is
    replaced by that vector."""
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.full((6,), 0.3, jnp.float32))
    want = np.asarray(jax_augment._distortion_map(jax.random.key(0), 97, 5,
                                                  0.3))
    ours = augment.distortion_map(_t(np.full((1, 6), 1.3, np.float32)), 97)
    np.testing.assert_array_equal(ours[0].numpy(), want)
    assert np.any(np.diff(want) < 0)  # it folds back


def test_grid_distortion_matches_on_replayed_draws():
    img, lab = _windowed(2)
    keys = _keys(3)
    draws = _grid_draws(keys)
    ours_img, ours_lab = augment.grid_distortion(_t(img), _t(lab), draws)
    for n, k in enumerate(keys):
        ref_img, ref_lab = jax_augment.grid_distortion(
            k, jnp.asarray(img[n]), jnp.asarray(lab[n]))
        np.testing.assert_allclose(ours_img[n].numpy(), np.asarray(ref_img),
                                   atol=1e-6)
        np.testing.assert_array_equal(ours_lab[n].numpy(), np.asarray(ref_lab))
    assert set(draws.apply.tolist()) == {True, False}


def _jax_shear_parameters(jitter, h, w):
    """The reference's six parameters from its own float32 solve."""
    center = jnp.array([w // 2, h // 2], jnp.float32)
    square = min(h, w) // 3
    src = jnp.stack([center + jnp.array([square, square], jnp.float32),
                     center + jnp.array([square, -square], jnp.float32),
                     center + jnp.array([-square, square], jnp.float32)])
    m = jax_augment._solve_affine(src, src + jnp.asarray(jitter))
    ainv = jnp.linalg.inv(m[:, :2])
    b = m[:, 2]
    minv = jnp.array([[ainv[1, 1], ainv[1, 0]], [ainv[0, 1], ainv[0, 0]]])
    binv = jnp.array([-(ainv[1, 0] * b[0] + ainv[1, 1] * b[1]),
                      -(ainv[0, 0] * b[0] + ainv[0, 1] * b[1])])
    beta = minv[0, 1] / minv[1, 1]
    return np.array([minv[0, 0] - beta * minv[1, 0], beta,
                     binv[0] - beta * binv[1], minv[1, 1], minv[1, 0],
                     binv[1]], np.float32)


def _reference_parameters(jitter, h, w):
    """The six parameters of the reference's own float32 solve, as the
    port's `_shear_parameters` returns them."""
    params = np.stack([_jax_shear_parameters(j, h, w) for j in jitter.numpy()])
    return tuple(_t(params[:, i])[:, None, None] for i in range(6))


def _float64_parameters(jitter, h, w):
    """The same system solved by numpy in float64, decomposed in float64."""
    center = np.array([w // 2, h // 2], np.float64)
    s = min(h, w) // 3
    src = np.stack([center + [s, s], center + [s, -s], center + [-s, s]])
    out = []
    for j in jitter.numpy():
        dst = (src.astype(np.float32) + j).astype(np.float64)
        m = np.linalg.solve(np.concatenate([src, np.ones((3, 1))], 1), dst).T
        ainv = np.linalg.inv(m[:, :2])
        b = m[:, 2]
        m00, m01, m10, m11 = ainv[1, 1], ainv[1, 0], ainv[0, 1], ainv[0, 0]
        b0 = -(ainv[1, 0] * b[0] + ainv[1, 1] * b[1])
        b1 = -(ainv[0, 0] * b[0] + ainv[0, 1] * b[1])
        beta = m01 / m11
        out.append([m00 - beta * m10, beta, b0 - beta * b1, m11, m10, b1])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("size", [SIZE, 256])
def test_elastic_parameters_are_the_float64_solve(size):
    """The closed form is the float64 solution rounded once (within one
    float32 ulp); the reference's float32 LU agrees with it to 2e-5
    relative."""
    draws = _elastic_draws(_keys(4, 32))
    ours = torch.stack([p[:, 0, 0] for p in augment._shear_parameters(
        draws.jitter, size, size)], 1).numpy()
    exact = _float64_parameters(draws.jitter, size, size)
    ulp = np.spacing(np.abs(exact))
    assert np.all(np.abs(ours - exact) <= ulp), \
        np.max(np.abs(ours - exact) / ulp)
    ref = torch.stack([p[:, 0, 0] for p in _reference_parameters(
        draws.jitter, size, size)], 1).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-5)


def test_elastic_fast_branch_is_equal_at_the_reference_parameters(monkeypatch):
    img, lab = _windowed(5)
    keys = _keys(6)
    draws = _elastic_draws(keys)
    monkeypatch.setattr(augment, "_shear_parameters", _reference_parameters)
    ours_img, ours_lab = augment.elastic_transform(_t(img), _t(lab), draws)
    for n, k in enumerate(keys):
        ref_img, ref_lab = jax_augment.elastic_transform(
            k, jnp.asarray(img[n]), jnp.asarray(lab[n]))
        np.testing.assert_allclose(ours_img[n].numpy(), np.asarray(ref_img),
                                   atol=1e-6)
        np.testing.assert_array_equal(ours_lab[n].numpy(), np.asarray(ref_lab))
    assert set(draws.apply.tolist()) == {True, False}


def test_elastic_fast_branch_matches_on_replayed_draws():
    """Without the reference's parameters: each image within the two
    passes' coordinate gap (values in [0, 1] change by at most the gap per
    pass) plus 1e-6, each label equal except where a coordinate lies
    within that gap of a half-integer."""
    img, lab = _windowed(7, n=16)
    keys = _keys(8, 16)
    draws = _elastic_draws(keys)
    ours_img, ours_lab = augment.elastic_transform(_t(img), _t(lab), draws)
    cy, cx = (c.numpy() for c in augment.elastic_coords(draws, SIZE, SIZE))
    ry, rx = (c.numpy() for c in augment.shear_coords(
        _reference_parameters(draws.jitter, SIZE, SIZE), draws.apply, SIZE,
        SIZE))
    for n, k in enumerate(keys):
        gap_y = np.max(np.abs(cy[n] - ry[n]))
        gap_x = np.max(np.abs(cx[n] - rx[n]))
        ref_img, ref_lab = jax_augment.elastic_transform(
            k, jnp.asarray(img[n]), jnp.asarray(lab[n]))
        np.testing.assert_allclose(ours_img[n].numpy(), np.asarray(ref_img),
                                   atol=gap_y + gap_x + 1e-6)
        risk = _label_risk(cy[n:n + 1], cx[n:n + 1],
                           max(gap_y, gap_x) + 1e-6)[0]
        _assert_labels(ours_lab[n].numpy(), np.asarray(ref_lab), risk)


# ------------------------------------------------------- the general branch
@pytest.mark.parametrize("order", [1, 0])
def test_map_coordinates_matches_jax(order):
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, size=(3, 20, 24)).astype(np.float32)
    cy = rng.uniform(-30, 50, size=(3, 16, 18)).astype(np.float32)
    cx = rng.uniform(-30, 50, size=(3, 16, 18)).astype(np.float32)
    # exact halves, where the rounding conventions part
    cy[:, 0, :6] = [-2.5, -0.5, 0.5, 1.5, 2.5, 19.5]
    cx[:, 0, :6] = [3.5, -1.5, 22.5, 23.5, -0.5, 0.5]
    ours = augment.map_coordinates(_t(x), _t(cy), _t(cx), order).numpy()
    for n in range(3):
        want = np.asarray(jax_map_coordinates(
            jnp.asarray(x[n]), [jnp.asarray(cy[n]), jnp.asarray(cx[n])],
            order=order, mode="mirror"))
        if order == 1:
            np.testing.assert_allclose(ours[n], want, atol=1e-6)
        else:
            np.testing.assert_array_equal(ours[n], want)


@pytest.mark.parametrize("sigma", [3.0, 50.0])
def test_gaussian_blur_matches_jax(sigma):
    x = np.random.default_rng(10).uniform(-1, 1, size=(2, 40, 64))
    x = x.astype(np.float32)
    for dim in (1, 2):
        ours = augment._gaussian_blur_1d(_t(x), sigma, dim).numpy()
        for n in range(2):
            want = np.asarray(jax_augment._gaussian_blur_1d(
                jnp.asarray(x[n]), sigma, dim - 1))
            np.testing.assert_allclose(ours[n], want, atol=1e-6)


def test_elastic_general_branch_matches_on_replayed_draws():
    """alpha=20, sigma=4, alpha_affine=10: the field is no longer sub-pixel.
    Fields and jitter replayed from the reference's calls (augment.py:240,
    252-254, 280-281, 301). The coordinates differ by the affine's
    solve and the blur's sums (float32, in another order): images within
    1e-3, labels equal except within 1e-3 of a half-integer."""
    alpha, sigma, affine = 20.0, 4.0, 10.0
    img, lab = _windowed(11, n=4, size=48)
    keys = _keys(12, 4)
    rows = []
    for k in keys:
        k_apply, k_aff, k_dx, k_dy = jax.random.split(k, 4)
        rows.append((bool(jax.random.bernoulli(k_apply, 0.5)),
                     np.asarray(jax.random.uniform(k_aff, (3, 2), jnp.float32,
                                                   -affine, affine)),
                     np.asarray(jax.random.uniform(k_dx, (48, 48), jnp.float32,
                                                   -1.0, 1.0)),
                     np.asarray(jax.random.uniform(k_dy, (48, 48), jnp.float32,
                                                   -1.0, 1.0))))
    draws = augment.ElasticDraws(*(_t(np.stack([r[i] for r in rows]))
                                   for i in range(4)))
    ours_img, ours_lab = augment.elastic_transform(_t(img), _t(lab), draws,
                                                   alpha=alpha, sigma=sigma)
    cy, cx = (c.numpy() for c in augment.general_coords(draws, 48, 48, alpha,
                                                        sigma))
    for n, k in enumerate(keys):
        ref_img, ref_lab = jax_augment.elastic_transform(
            k, jnp.asarray(img[n]), jnp.asarray(lab[n]), alpha=alpha,
            sigma=sigma, alpha_affine=affine)
        np.testing.assert_allclose(ours_img[n].numpy(), np.asarray(ref_img),
                                   atol=1e-3)
        risk = rows[n][0] & (_near_half(cy[n], 1e-3) | _near_half(cx[n], 1e-3))
        _assert_labels(ours_lab[n].numpy(), np.asarray(ref_lab), risk)
    assert {r[0] for r in rows} == {True, False}


# ------------------------------------------------------- degrees end to end
@pytest.mark.parametrize("degree", [0, 3, 4])
def test_degree_matches_the_eager_jax_transform(degree, monkeypatch):
    """On replayed draws with the reference's six elastic parameters (the
    only values the port computes another way, held above): images within
    2e-6 (one float32 rounding of a tap's sum, over the std), labels
    exactly."""
    images, labels = _images(13 + degree, n=8)
    keys = _keys(14 + degree, 8)
    draws = (_degree3_draws if degree == 3 else _degree4_draws)(
        keys, RAW, RAW, SIZE)
    monkeypatch.setattr(augment, "_shear_parameters", _reference_parameters)
    ours_img, ours_lab = get_transform(degree, True, (SIZE, SIZE))(
        _t(images), _t(labels), draws)
    ref_img, ref_lab = _jax_batched(degree, keys, images, labels)
    assert ours_img.shape == (8, SIZE, SIZE, 1 if degree == 0 else 3)
    np.testing.assert_allclose(ours_img.numpy(), ref_img, atol=2e-6)
    np.testing.assert_array_equal(ours_lab.numpy(), ref_lab)
    if degree != 3:  # both branches and both apply bits occur
        assert set(draws.choice.tolist()) == {0, 1}


def test_degree_1_trains_on_its_test_transform():
    """Images within 1e-6 (float32 resize sums), labels exactly; no draws."""
    images, labels = _images(15, n=4)
    transform = get_transform(1, True, (SIZE, SIZE))
    draws = transform.draw(torch.Generator().manual_seed(0), images.shape)
    assert draws is None
    ours_img, ours_lab = transform(_t(images), _t(labels), draws)
    ref_img, ref_lab = _jax_batched(1, _keys(16, 4), images, labels)
    np.testing.assert_allclose(ours_img.numpy(), ref_img, atol=1e-6)
    np.testing.assert_array_equal(ours_lab.numpy(), ref_lab)


# ------------------------------------------------------------------ draws
def test_degree4_draws_have_the_reference_distributions():
    n = 20000
    d = get_transform(4, True, (SIZE, SIZE)).draw(
        torch.Generator().manual_seed(1), (n, RAW, RAW))
    assert isinstance(d, augment.Degree4Draws)
    for v in (d.top, d.left):
        assert v.dtype == torch.int32
        assert v.min() == 0 and v.max() == RAW - SIZE
    assert abs(d.choice.float().mean() - 0.5) < 0.02
    assert set(d.choice.unique().tolist()) == {0, 1}
    for apply in (d.elastic.apply, d.grid.apply):
        assert apply.dtype == torch.bool
        assert abs(apply.float().mean() - 0.5) < 0.02
    j = d.elastic.jitter
    assert j.shape == (n, 3, 2) and j.dtype == torch.float32
    assert -50 <= j.min() < -49.9 and 49.9 < j.max() < 50
    assert abs(j.mean()) < 0.5 and d.elastic.dx is None
    for steps in (d.grid.steps_x, d.grid.steps_y):
        assert steps.shape == (n, 6)
        assert 0.7 <= steps.min() < 0.701 and 1.299 < steps.max() <= 1.3
        assert abs(steps.mean() - 1.0) < 0.005
    # the same seed draws the same parameters; degree 0 draws as degree 4
    again = get_transform(0, True, (SIZE, SIZE)).draw(
        torch.Generator().manual_seed(1), (n, RAW, RAW))
    leaves = [[v for v in torch.utils._pytree.tree_leaves(x) if v is not None]
              for x in (d, again)]
    assert len(leaves[0]) == 8
    assert all(torch.equal(a, b) for a, b in zip(*leaves))


def test_degree3_draws_and_the_general_branch_fields():
    n = 20000
    d = get_transform(3, True, (SIZE, SIZE)).draw(
        torch.Generator().manual_seed(2), (n, RAW, RAW))
    assert isinstance(d, augment.Degree3Draws)
    assert set(d.k.unique().tolist()) == {0, 1, 2, 3}
    assert abs((d.k == 0).float().mean() - 0.625) < 0.02  # 1/2 + 1/2 * 1/4
    assert abs(d.flip.float().mean() - 0.5) < 0.02
    assert abs(d.elastic.apply.float().mean() - 0.5) < 0.02
    general = augment.draw_elastic(torch.Generator().manual_seed(3), 4, 8, 9,
                                   alpha=20.0, sigma=4.0)
    assert general.dx.shape == general.dy.shape == (4, 8, 9)
    assert -1 <= general.dx.min() and general.dx.max() < 1


def test_move_draws_keeps_the_structure():
    d = augment.draw_degree4(torch.Generator().manual_seed(4), 3, 20, 20, 16)
    moved = augment.move_draws(d, "cpu")
    assert type(moved) is augment.Degree4Draws
    assert type(moved.grid) is augment.GridDraws
    assert moved.elastic.dx is None
    assert augment.move_draws(None, "cpu") is None
