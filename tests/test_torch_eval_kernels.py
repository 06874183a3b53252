"""The min-plus kernel module (K5), the EDT, the Boundary loss and HD95 of the
port against the JAX package.

On the CPU the wrapper runs the kernel's plain PyTorch version (chip_smoke.py
holds the CUDA kernel to it on the card, bit for bit). Inputs are made with
numpy from a seed and go through both packages:

  - `min_plus` vs min_plus.min_plus_2d (Pallas, interpret mode) and the jnp
    all-pairs `_min_plus`: equal bit for bit (the same three float32
    roundings per pair, then `min`), K not a multiple of the Pallas tile,
    three scales, rows and columns at BIG.
  - `edt_squared` vs the JAX one, 2D and 3D, with and without spacing, one
    spacing per map: equal bit for bit; vs scipy's
    distance_transform_edt(...)**2 at 1e-6 relative (float32 rounding of
    the squares and their sums).
  - signed distance maps vs signed_distance_maps_from_labels and the host
    data/distance.compute_distance_map: 1e-6 absolute (one float32 sqrt and
    division).
  - `boundary_loss` and MultiLoss with Boundary and exclude_missing vs the
    JAX losses: 1e-12 in float64, 1e-6 in float32.
  - `hd95_per_structure_device` vs the JAX device function and the scipy
    host path, unit and anisotropic spacing, 2D batched and 3D, empty masks
    included: 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import distance_transform_edt

from ctseg_tpu.data.distance import compute_distance_map
from ctseg_tpu.losses import segmentation as jax_losses
from ctseg_tpu.metrics import hd95 as jax_hd95
from ctseg_tpu.ops import edt as jax_edt
from ctseg_tpu.ops.pallas.min_plus import min_plus_2d
from ctseg_tpu_torch.losses import segmentation as losses
from ctseg_tpu_torch.metrics import hd95
from ctseg_tpu_torch.ops import edt
from ctseg_tpu_torch.ops import min_plus as k5

BIG32 = float(np.float32(1e12))


def _slab(seed, k, l=40):
    rng = np.random.default_rng(seed)
    x = np.floor(rng.random((k, l)) * 2000).astype(np.float32)
    x[rng.random((k, l)) < 0.2] = 1e12
    x[k // 2] = 1e12   # a row with no site
    x[:, 5] = 1e12     # a column with no site in any row
    return x


# --------------------------------------------------------------------- K5
@pytest.mark.parametrize("scale", [1.0, 0.5, 3.0])
@pytest.mark.parametrize("k", [7, 32, 50])
def test_min_plus_is_bit_equal_to_pallas_and_jnp(k, scale):
    x = _slab(k, k)
    pallas = np.asarray(min_plus_2d(jnp.asarray(x), jnp.float32(scale),
                                    interpret=True))
    all_pairs = np.asarray(jax_edt._min_plus(jnp.asarray(x), 0,
                                             jnp.float32(scale)))
    ours = k5.min_plus(torch.from_numpy(x)[None],
                       torch.tensor([scale], dtype=torch.float32))[0].numpy()
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, all_pairs)
    assert ours.max() == BIG32 and (ours[:, 5] == BIG32).all()


def test_min_plus_takes_one_scale_per_map_and_chunks():
    """A batch with its own scale per map equals the maps one by one, also
    when the plain version splits its intermediate into chunks."""
    scales = np.array([1.0, 0.3, 2.7, 1.1], np.float32)
    x = np.stack([_slab(20 + i, 19, 33) for i in range(4)])
    whole = k5.min_plus(torch.from_numpy(x), torch.from_numpy(scales)).numpy()
    for i, s in enumerate(scales):
        ref = np.asarray(min_plus_2d(jnp.asarray(x[i]), jnp.float32(s),
                                     interpret=True))
        np.testing.assert_array_equal(whole[i], ref)
    saved = k5._PLAIN_CHUNK
    try:
        k5._PLAIN_CHUNK = 19 * 33 * 5  # a few output rows of one map a chunk
        chunked = k5.min_plus_plain(torch.from_numpy(x),
                                    torch.from_numpy(scales)).numpy()
    finally:
        k5._PLAIN_CHUNK = saved
    np.testing.assert_array_equal(chunked, whole)


def test_min_plus_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 4, 5))
    with pytest.raises(ValueError, match="B, K, L"):
        k5.min_plus(x[0], torch.ones(2))
    with pytest.raises(ValueError, match="scale"):
        k5.min_plus(x, torch.ones(3))
    assert k5.min_plus(x[:0], torch.ones(0)).shape == (0, 4, 5)
    before = k5.min_plus.launches
    k5.min_plus(x, torch.ones(2))
    assert k5.min_plus.launches == before  # no launch is counted on the CPU


# --------------------------------------------------------------------- EDT
def _masks(seed, shape, p=0.3):
    return np.random.default_rng(seed).random(shape) > p


@pytest.mark.parametrize("spacing", [None, (1.5, 0.7)])
def test_edt_squared_2d_is_bit_equal_to_jax_and_matches_scipy(spacing):
    masks = _masks(1, (4, 20, 24))
    masks[2] = True   # no zero anywhere: BIG
    masks[3] = False  # zero everywhere: 0
    ours = edt.edt_squared(torch.from_numpy(masks), spacing,
                           spatial_dims=2).numpy()
    for i, m in enumerate(masks):
        ref = np.asarray(jax_edt.edt_squared(jnp.asarray(m), spacing))
        np.testing.assert_array_equal(ours[i], ref)
    assert (ours[2] == BIG32).all() and (ours[3] == 0).all()
    for i in (0, 1):
        np.testing.assert_allclose(
            ours[i], distance_transform_edt(masks[i], sampling=spacing) ** 2,
            rtol=1e-6)


@pytest.mark.parametrize("spacing", [None, (3.0, 1.1, 0.9)])
def test_edt_squared_3d_is_bit_equal_to_jax_and_matches_scipy(spacing):
    mask = _masks(2, (6, 9, 8), p=0.2)
    ours = edt.edt_squared(torch.from_numpy(mask), spacing).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jax_edt.edt_squared(jnp.asarray(mask), spacing)))
    np.testing.assert_allclose(
        ours, distance_transform_edt(mask, sampling=spacing) ** 2, rtol=1e-6)
    # two volumes in a batch, the second with another spacing
    both = torch.from_numpy(np.stack([mask, ~mask]))
    sp = torch.tensor([[1.0, 1.0, 1.0], [2.0, 0.5, 1.5]])
    batched = edt.edt_squared(both, sp).numpy()
    np.testing.assert_array_equal(batched[1], np.asarray(
        jax_edt.edt_squared(jnp.asarray(~mask), jnp.asarray(sp[1].numpy()))))


def test_edt_squared_takes_one_spacing_per_map():
    masks = _masks(3, (3, 12, 14))
    sp = np.array([[1.0, 2.0], [0.5, 0.7], [3.0, 1.0]], np.float32)
    ours = edt.edt_squared(torch.from_numpy(masks), torch.from_numpy(sp)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(ours[i], np.asarray(
            jax_edt.edt_squared(jnp.asarray(masks[i]), jnp.asarray(sp[i]))))
    np.testing.assert_array_equal(
        edt.edt(torch.from_numpy(masks[0]), sp[0]).numpy(),
        np.asarray(jax_edt.edt(jnp.asarray(masks[0]), jnp.asarray(sp[0]))))
    with pytest.raises(ValueError, match="spacing"):
        edt.edt_squared(torch.from_numpy(masks), sp, spatial_dims=3)


def _labels(seed, n=3, hw=(18, 16)):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=(n, *hw)).astype(np.uint8)
    labels[1][labels[1] == 3] = 0   # a class missing from one sample
    labels[2] = 0                   # a sample with background only
    return labels


def test_signed_distance_maps_match_jax_and_the_host_maps():
    labels = _labels(4)
    ours = edt.signed_distance_maps_from_labels(torch.from_numpy(labels))
    assert ours.shape == (3, 9, 18, 16) and ours.dtype == torch.float32
    ref = np.asarray(jax_edt.signed_distance_maps_from_labels(
        jnp.asarray(labels)))  # (N, H, W, 9)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=0, atol=1e-6)
    for i, lab in enumerate(labels):
        host = compute_distance_map(
            np.stack([lab == c for c in range(1, 10)]))
        np.testing.assert_allclose(ours[i].numpy(), host, rtol=0, atol=1e-6)
    assert not ours[2].any() and not ours[1, 2].any()  # empty masks: zeros
    one = edt.signed_distance_map(torch.from_numpy(labels[0] == 4))
    np.testing.assert_array_equal(one.numpy(), ours[0, 3].numpy())


# ----------------------------------------------------------- Boundary loss
def _loss_inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    n, hw, c = 4, (10, 9), 10
    logits = (rng.normal(size=(n, *hw, c)) * 2.0).astype(dtype)
    labels = rng.integers(0, c, size=(n, *hw))
    labels[0] = 0
    indicators = rng.integers(0, 2, size=(n, c - 1)).astype(dtype)
    indicators[1] = 1.0
    maps = np.asarray(jax_edt.signed_distance_maps_from_labels(
        jnp.asarray(labels))).astype(dtype)  # (N, H, W, 9)
    return logits, labels, indicators, maps, np.array([True, True, False, True])


def _cf(a):
    """Channel-last numpy -> the port's channel-first tensor."""
    return torch.from_numpy(np.moveaxis(a, -1, 1).copy())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_boundary_loss_matches_jax(dtype, tol, reduction, masked):
    logits, _, _, maps, mask = _loss_inputs(5, dtype)
    ref = jax_losses.boundary_loss(
        jnp.asarray(logits), jnp.asarray(maps), reduction=reduction,
        sample_mask=jnp.asarray(mask) if masked else None)
    ours = losses.boundary_loss(
        _cf(logits), _cf(maps), reduction=reduction,
        sample_mask=torch.from_numpy(mask) if masked else None)
    assert ours.dtype == torch.from_numpy(logits).dtype
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_multiloss_with_boundary_matches_jax(dtype, tol, exclude, masked):
    """Model M's loss set, from the port's own maps of the labels."""
    logits, labels, indicators, _, mask = _loss_inputs(6, dtype)
    names = ["Boundary", "Dice", "Focal"]
    ref = jax_losses.MultiLoss(names, exclude)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(indicators),
        jax_edt.signed_distance_maps_from_labels(jnp.asarray(labels)),
        jnp.asarray(mask) if masked else None)
    ours = losses.MultiLoss(names, exclude)(
        _cf(logits), torch.from_numpy(labels), torch.from_numpy(indicators),
        edt.signed_distance_maps_from_labels(torch.from_numpy(labels)),
        torch.from_numpy(mask) if masked else None)
    assert list(ours) == list(ref) == names
    for k in names:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=tol,
                                   atol=tol, err_msg=k)


# -------------------------------------------------------------------- HD95
def _blobs(seed, n, h, w):
    """Label maps of rectangles; some classes missing from some samples."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        for c in range(1, 10):
            if rng.random() < 0.2:
                continue
            y, x = rng.integers(2, h - 8), rng.integers(2, w - 8)
            lab[i, y:y + rng.integers(1, 8), x:x + rng.integers(1, 8)] = c
    return lab


@pytest.mark.parametrize("anisotropic", [False, True])
def test_hd95_device_matches_jax_and_scipy_2d(anisotropic):
    pred, target = _blobs(7, 4, 32, 40), _blobs(8, 4, 32, 40)
    pred[3] = 0  # a sample whose prediction is empty: nothing valid
    sp = np.array([[1.0, 1.0], [0.8, 2.5], [3.0, 0.4], [1.2, 1.2]], np.float32)
    value, valid = hd95.hd95_per_structure_device(
        torch.from_numpy(pred), torch.from_numpy(target),
        spacing=torch.from_numpy(sp) if anisotropic else None, spatial_dims=2)
    assert value.shape == valid.shape == (4, 9) and value.dtype == torch.float32
    assert not valid[3].any() and valid.any()
    for i in range(4):
        spacing = sp[i] if anisotropic else None
        jv, jok = jax_hd95.hd95_per_structure_device(
            jnp.asarray(pred[i]), jnp.asarray(target[i]),
            spacing=None if spacing is None else jnp.asarray(spacing))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jok))
        np.testing.assert_allclose(value[i].numpy(), np.asarray(jv), rtol=1e-5)
        host = hd95.hd95_per_structure(pred[i], target[i], spacing=spacing)
        np.testing.assert_array_equal(valid[i].numpy(), ~np.isnan(host))
        np.testing.assert_allclose(value[i].numpy(), np.nan_to_num(host),
                                   rtol=1e-5)


def test_hd95_device_matches_scipy_3d_and_one_map():
    pred = _blobs(9, 6, 14, 16).transpose(1, 2, 0).copy()    # (H, W, D)
    target = _blobs(10, 6, 14, 16).transpose(1, 2, 0).copy()
    spacing = (1.1, 1.1, 3.0)
    value, valid = hd95.hd95_per_structure_device(
        torch.from_numpy(pred), torch.from_numpy(target), spacing=spacing)
    jv, jok = jax_hd95.hd95_per_structure_device(
        jnp.asarray(pred), jnp.asarray(target), spacing=jnp.asarray(spacing))
    host = hd95.hd95_per_structure(pred, target, spacing=spacing)
    np.testing.assert_array_equal(valid.numpy(), ~np.isnan(host))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jok))
    np.testing.assert_allclose(value.numpy(), np.nan_to_num(host), rtol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jv), rtol=1e-5)
    # a single pixel against a single pixel: the distance between them
    a, b = np.zeros((9, 9), np.uint8), np.zeros((9, 9), np.uint8)
    a[2, 3], b[6, 6] = 1, 1
    v, ok = hd95.hd95_per_structure_device(torch.from_numpy(a),
                                           torch.from_numpy(b), n_classes=2)
    assert bool(ok[0]) and float(v[0]) == 5.0


def test_surface_matches_scipy_erosion():
    masks = _masks(11, (3, 12, 13), p=0.35)
    ours = hd95._surface_device(torch.from_numpy(masks), 2).numpy()
    for i, m in enumerate(masks):
        np.testing.assert_array_equal(ours[i], hd95._surface(m))
    vol = _masks(12, (7, 8, 9), p=0.2)
    np.testing.assert_array_equal(
        hd95._surface_device(torch.from_numpy(vol), 3).numpy(),
        hd95._surface(vol))
