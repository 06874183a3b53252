"""The last gaps between the port's API and the JAX package's, each held to
the JAX function on the same numpy inputs, on the CPU.

  - `sliding_window_inference(mesh=)`: on two gloo ranks
    (tests/_torch_dist_workers.py), every rank's blend of a channel mix
    within float32 round-off (rtol 1e-5, atol 1e-6: the blend is summed
    over the ranks) of the one-process call and of the JAX call on
    make_mesh(2), in 2D and 3D.
  - `evaluate_3d_sliding_window(window=)`: True and False, on a
    resize-mode and a patch-mode config (float64 models), Dice within 1e-12
    relative of the JAX function with the same `window`; None takes the
    config's rule (windowed for patch mode only).
  - `apply_window`, `windowed_channels`, `soft_tissue_window` with `shift`
    True and False and `windows` reordered: equal to the JAX functions
    element for element (float32; the same clip, subtraction and true
    division).
  - `ops.masks.squash_masks` (overlapping structures: the highest class id
    wins) and `one_hot` (labels outside the classes give zero rows):
    equal to the JAX functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.data.datasets import PackedDataset3D as JaxPackedDataset3D
from ctseg_tpu.inference import sliding_window as jax_sw
from ctseg_tpu.inference.evaluate import (
    evaluate_3d_sliding_window as jax_evaluate_3d,
)
from ctseg_tpu.ops import masks as jax_masks
from ctseg_tpu.parallel import make_mesh as jax_make_mesh
from ctseg_tpu.transforms import windowing as jax_windowing
from ctseg_tpu_torch import ops
from ctseg_tpu_torch.data.datasets import PackedDataset3D
from ctseg_tpu_torch.inference import evaluate
from ctseg_tpu_torch.inference import sliding_window as sw
from ctseg_tpu_torch.ops import masks
from ctseg_tpu_torch.transforms import windowing
from tests import _torch_dist_workers as workers
from tests.test_torch_3d_infer import PATCH, _eval_split, _pair

# ------------------------------------------- sliding_window_inference(mesh=)
SHAPES = {"2d": ((70, 70), (32, 32), 8), "3d": ((40, 33, 20), (16, 16, 8), 3)}
C_IN, C_OUT = 2, 3


@pytest.fixture(scope="module")
def on_mesh(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("window_mesh")
    rng = np.random.default_rng(7)
    weights = rng.normal(size=(C_IN, C_OUT)).astype(np.float32)
    np.save(tmp / "weights.npy", weights)
    jobs, volumes = [], {}
    for name, (shape, patch, batch) in SHAPES.items():
        volumes[name] = rng.random(shape + (C_IN,)).astype(np.float32)
        np.save(tmp / f"{name}.npy", volumes[name])
        jobs.append((name, "window_inference", dict(
            volume=f"{name}.npy", patch=patch, weights="weights.npy",
            batch_size=batch)))
    return {"weights": weights, "volumes": volumes,
            "results": workers.run(2, tmp, jobs)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_sliding_window_inference_on_a_mesh_matches_one_process_and_jax(
        on_mesh, name):
    shape, patch, batch = SHAPES[name]
    vol, w = on_mesh["volumes"][name], on_mesh["weights"]
    theirs = np.asarray(jax_sw.sliding_window_inference(
        jnp.asarray(vol), lambda p: jnp.tanh(p @ w), patch,
        batch_size=batch, mesh=jax_make_mesh(2)))
    ours = sw.sliding_window_inference(
        torch.from_numpy(vol), lambda p: torch.tanh(p @ torch.from_numpy(w)),
        patch, batch_size=batch)
    assert theirs.shape == shape + (C_OUT,)
    for rank in workers.ranks(on_mesh["results"], name):
        np.testing.assert_allclose(rank["mesh"], rank["alone"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(rank["mesh"], theirs, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(rank["alone"], ours.numpy())


# ------------------------------------ evaluate_3d_sliding_window(window=)
@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("mode", ["resize", "patch"])
def test_evaluate_3d_window_flag_matches_jax(mode, window):
    cfg, model, jtr, params = _pair(mode, seed=3)
    arrays = _eval_split(9, depths=(12, 6))
    theirs = jax_evaluate_3d(jtr, params, JaxPackedDataset3D(*arrays[:3]),
                             patch_size=PATCH, overlap=0.5, batch_size=3,
                             window=window)
    ours = evaluate.evaluate_3d_sliding_window(
        model, cfg, PackedDataset3D(*arrays[:3]), PATCH, 0.5, 3,
        window=window, device="cpu")
    assert ours["num_volumes"] == 2
    for s, v in theirs["per_structure_dice"].items():
        assert ours["per_structure_dice"][s] == pytest.approx(v, rel=1e-12), s
    by_rule = evaluate.evaluate_3d_sliding_window(
        model, cfg, PackedDataset3D(*arrays[:3]), PATCH, 0.5, 3,
        device="cpu")
    if window == (mode == "patch"):  # None is the config's rule
        assert by_rule["per_structure_dice"] == ours["per_structure_dice"]


# ----------------------------------------------------------------- windows
def _hu(seed=0, shape=(3, 17, 19)):
    return np.random.default_rng(seed).uniform(-1500, 2500, shape).astype(
        np.float32)


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("width,level", [(350, 20), (80, 40), (2800, 600),
                                         (351, -5)])
def test_apply_window_matches_jax(width, level, shift):
    img = _hu()
    ours = windowing.apply_window(torch.from_numpy(img), width, level,
                                  shift=shift)
    theirs = np.asarray(jax_windowing.apply_window(jnp.asarray(img), width,
                                                   level, shift=shift))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("windows", [
    None, ("bone", "brain", "soft_tissue"), ("soft_tissue",), ("brain", "bone")])
def test_windowed_channels_match_jax(windows, shift):
    img = _hu(1)
    kw = {"shift": shift} if windows is None else {"windows": windows,
                                                   "shift": shift}
    ours = windowing.windowed_channels(torch.from_numpy(img), **kw)
    theirs = np.asarray(jax_windowing.windowed_channels(jnp.asarray(img),
                                                        **kw))
    assert ours.shape == theirs.shape == img.shape + (
        3 if windows is None else len(windows),)
    np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("shift", [True, False])
def test_soft_tissue_window_matches_jax(shift):
    img = _hu(2)
    ours = windowing.soft_tissue_window(torch.from_numpy(img), shift=shift)
    theirs = np.asarray(jax_windowing.soft_tissue_window(jnp.asarray(img),
                                                         shift=shift))
    assert ours.shape == img.shape + (1,)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # the default shifts, as the reference's does
    np.testing.assert_array_equal(
        windowing.soft_tissue_window(torch.from_numpy(img)).numpy(),
        np.asarray(jax_windowing.soft_tissue_window(jnp.asarray(img))))


# ------------------------------------------------------------------- masks
@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.float32])
def test_squash_masks_matches_jax_where_structures_overlap(dtype):
    rng = np.random.default_rng(4)
    stack = (rng.random((2, 12, 10, 9)) < 0.3).astype(dtype)
    assert (stack.astype(np.int32).sum(-1) > 1).any()  # overlaps exist
    ours = masks.squash_masks(torch.from_numpy(stack), 10)
    theirs = np.asarray(jax_masks.squash_masks(jnp.asarray(stack), 10))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # the highest structure's class id wins
    top = np.where(stack.astype(bool).any(-1),
                   9 - np.argmax(stack[..., ::-1].astype(bool), axis=-1), 0)
    np.testing.assert_array_equal(ours.numpy(), top)
    with pytest.raises(ValueError, match="9 structure masks"):
        masks.squash_masks(torch.from_numpy(stack[..., :8]), 10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.float64])
def test_one_hot_matches_jax(dtype):
    labels = np.random.default_rng(5).integers(-2, 12, (3, 7, 5))
    jdtype = {torch.float32: jnp.float32, torch.int32: jnp.int32,
              torch.float64: jnp.float64}[dtype]
    ours = masks.one_hot(torch.from_numpy(labels), 10, dtype)
    theirs = np.asarray(jax_masks.one_hot(jnp.asarray(labels), 10, jdtype))
    assert ours.shape == (3, 7, 5, 10) and ours.dtype == dtype
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert float(ours[torch.from_numpy(labels) >= 10].abs().sum()) == 0.0


def test_ops_exports_what_the_jax_ops_package_exports():
    for name in ("one_hot", "squash_masks", "squash_predictions"):
        assert getattr(ops, name) is getattr(masks, name)
    logits = np.random.default_rng(6).normal(size=(4, 6, 10)).astype(
        np.float32)
    np.testing.assert_array_equal(
        ops.squash_predictions(torch.from_numpy(logits)).numpy(),
        np.asarray(jax_masks.squash_predictions(jnp.asarray(logits))))
