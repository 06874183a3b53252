"""The port's 3D inference and evaluation against the JAX package, on the
CPU.

  - Window grids bit-equal to `compute_window_grid` (2D and 3D, several
    overlaps, axes equal to the patch), the Gaussian importance map equal,
    `pad_volume_dhw`'s fill rule the same.
  - Blended logits against `sliding_window_inference` at float32
    round-off: a constant model (every voxel's logits are the constant), an
    identity model (blending returns the input), and a channel mix whose
    windows see different data, in 2D and 3D.
  - `predict_scan` of 3D checkpoints (both modes; float64 models, so the
    two argmaxes see the same float32 logits) equal to the JAX
    `predict_scan` on a `make_patient` scan, one axis shorter than the
    patch; the server answers with the same labels.
  - `evaluate_3d_sliding_window(with_hd95=True)` on 3 volumes of mixed
    depths (one shorter than the patch) with spacings and exclude_missing:
    Dice equal and HD95 in mm within 1e-6 relative of the JAX function;
    the same result keys; then the evaluate CLI on a 3D checkpoint.
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
from ctseg_tpu.inference.predict import predict_scan as jax_predict_scan
from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.training.trainer import TrainConfig as JaxTrainConfig
from ctseg_tpu.training.trainer import Trainer as JaxTrainer
from ctseg_tpu_torch.data.datasets import PackedDataset3D
from ctseg_tpu_torch.inference import evaluate, sliding_window as sw
from ctseg_tpu_torch.inference.predict import predict_labels_3d, predict_scan
from ctseg_tpu_torch.inference.serve import SegmentationService
from ctseg_tpu_torch.testing.synth import make_patient
from ctseg_tpu_torch.training.config import (
    TrainConfig,
    build_model,
    save_checkpoint,
)
from ctseg_tpu_torch.utils.miccai import Volume

FILTERS = (4, 8, 16)
STRIDES = (2, 2)
PATCH = (16, 16, 8)


# ------------------------------------------------------------ window grids
@pytest.mark.parametrize("overlap", [0.0, 0.25, 0.5, 0.75])
@pytest.mark.parametrize("shape,patch", [
    ((40, 40, 24), (16, 16, 8)), ((16, 33, 8), (16, 16, 8)),
    ((280, 280, 120), (128, 128, 48)), ((100, 100), (64, 64)),
])
def test_window_grids_are_the_jax_grids(shape, patch, overlap):
    ours = sw.compute_window_grid(shape, patch, overlap)
    theirs = jax_sw.compute_window_grid(shape, patch, overlap)
    assert ours.dtype == theirs.dtype == np.int32
    np.testing.assert_array_equal(ours, theirs)
    for p in patch:
        assert sw.window_step(p, overlap) == jax_sw.window_step(p, overlap)


@pytest.mark.parametrize("patch", [(16, 16, 8), (128, 128, 48), (7, 64)])
def test_gaussian_importance_is_the_jax_map(patch):
    ours = sw.gaussian_importance(patch)
    theirs = np.asarray(jax_sw.gaussian_importance(patch))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert float(ours.min()) >= np.float32(1e-6) and float(ours.max()) == 1.0


@pytest.mark.parametrize("dtype,fill", [(np.uint16, -1024.0),
                                        (np.uint8, -1024.0),
                                        (np.int16, -1024.0),
                                        (np.int16, 0.0),
                                        (np.float32, -1024.0)])
def test_pad_volume_fill_rule_is_the_jax_rule(dtype, fill):
    arr = np.full((4, 8, 8), 50, dtype=dtype)  # (D, H, W)
    ours = sw.pad_volume_dhw(arr, (16, 8, 8), fill)
    theirs = jax_sw.pad_volume_dhw(arr, (16, 8, 8), fill)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    assert sw.pad_volume_dhw(arr, (8, 8, 4), fill) is arr


# -------------------------------------------------------------- blending
def _models(c_in, c_out, seed):
    w = np.random.default_rng(seed).normal(size=(c_in, c_out)).astype(
        np.float32)
    const = np.arange(c_out, dtype=np.float32)
    return {
        "constant": (lambda p: torch.zeros(p.shape[:-1] + (c_out,)) +
                     torch.from_numpy(const),
                     lambda p: jnp.zeros(p.shape[:-1] + (c_out,)) + const),
        "identity": (lambda p: p, lambda p: p),
        # a nonlinear channel mix: each window's logits depend on its data
        "mix": (lambda p: torch.tanh(p @ torch.from_numpy(w)),
                lambda p: jnp.tanh(p @ w)),
    }


@pytest.mark.parametrize("model", ["constant", "identity", "mix"])
@pytest.mark.parametrize("shape,patch", [((40, 33, 24), (16, 16, 8)),
                                         ((50, 37), (16, 16))])
def test_blended_logits_match_sliding_window_inference(shape, patch, model):
    c_in = 3
    c_out = c_in if model == "identity" else 4
    vol = np.random.default_rng(0).normal(size=shape + (c_in,)).astype(
        np.float32)
    ours_fn, theirs_fn = _models(c_in, c_out, 1)[model]
    ours = sw.sliding_window_inference(torch.from_numpy(vol), ours_fn, patch,
                                       overlap=0.5, batch_size=3)
    theirs = np.asarray(jax_sw.sliding_window_inference(
        jnp.asarray(vol), theirs_fn, patch, overlap=0.5, batch_size=3))
    assert ours.shape == shape + (c_out,) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6, atol=1e-6)
    if model == "identity":
        np.testing.assert_allclose(ours.numpy(), vol, rtol=1e-6, atol=1e-6)
    if model == "constant":
        np.testing.assert_allclose(ours.numpy()[..., 3], 3.0, rtol=1e-6)


# ------------------------------------------------------- predict and serve
def _jax_config(mode, **kw):
    return JaxTrainConfig(
        filters=FILTERS, num_res_units=2, transform_degree=0, spatial_dims=3,
        input_shape=PATCH, in_channels=1, volumetric_mode=mode,
        compute_dtype="float64", **kw)


def _pair(mode, seed=0, **kw):
    """A float64 3D model of the port and the JAX trainer and params with
    its weights."""
    jcfg = _jax_config(mode, **kw)
    cfg = TrainConfig.from_dict(jcfg.as_dict())
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(seed))
    params = import_monai_state_dict(model.state_dict(), 1, FILTERS,
                                     strides=STRIDES, num_res_units=2,
                                     dtype=jnp.float64)
    return cfg, model.eval(), JaxTrainer(jcfg), params


@pytest.fixture(scope="module")
def patient(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_scans_3d")
    return make_patient(root / "0522c0003", shape=(6, 36, 30), seed=4)


@pytest.mark.parametrize("mode", ["patch", "resize"])
def test_predict_scan_of_a_3d_checkpoint_matches_jax(patient, mode,
                                                     tmp_path):
    cfg, model, jtr, params = _pair(mode)
    volume = Volume.from_nrrd(patient / "img.nrrd")
    theirs = jax_predict_scan(jtr, params, volume, crop=False,
                              patch_size=PATCH, overlap=0.5)
    ours = predict_scan(model, cfg, volume, "cpu", crop=False,
                        patch_size=PATCH, overlap=0.5)
    assert ours.shape == theirs.shape == (6, 36, 30) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        predict_labels_3d(model, cfg, volume.as_numpy()[0], "cpu", PATCH),
        ours)

    save_checkpoint(tmp_path / "m3d.ckpt", cfg, model)
    service = SegmentationService(str(tmp_path / "m3d.ckpt"), device="cpu",
                                  crop=False, patch_size=PATCH, overlap=0.5)
    np.testing.assert_array_equal(service.segment(volume), ours)
    assert service.info()["spatial_dims"] == 3 and service.served == 1


# ---------------------------------------------------------------- evaluate
def _eval_split(seed, depths=(12, 10, 6), h=24, w=20):
    rng = np.random.default_rng(seed)
    images, labels, indicators, spacings = [], [], [], []
    for d in depths:
        lab = np.zeros((d, h, w), np.uint8)
        for c in range(1, 10):
            if rng.random() < 0.15:
                continue
            z, y, x = (rng.integers(0, max(d - 3, 1)), rng.integers(0, h - 8),
                       rng.integers(0, w - 8))
            lab[z:z + rng.integers(2, 5), y:y + rng.integers(3, 8),
                x:x + rng.integers(3, 8)] = c
        images.append((rng.normal(40, 120, (d, h, w)) + 60.0 * lab)
                      .astype(np.int16))
        labels.append(lab)
        ind = (np.bincount(lab.ravel(), minlength=10)[1:] > 0)
        ind[rng.integers(0, 9)] = False  # one structure not annotated
        indicators.append(ind.astype(np.float32))
        spacings.append(rng.uniform(0.5, 3.0, 3).astype(np.float32))
    return images, labels, indicators, spacings


def test_evaluate_3d_matches_jax_with_hd95_in_mm():
    cfg, model, jtr, params = _pair("patch", seed=1, exclude_missing=True)
    arrays = _eval_split(5)
    theirs = jax_evaluate_3d(jtr, params, JaxPackedDataset3D(
        *arrays[:3], spacings=arrays[3]), patch_size=PATCH, overlap=0.5,
        batch_size=3, window=True, with_hd95=True)
    ours = evaluate.evaluate_3d_sliding_window(
        model, cfg, PackedDataset3D(*arrays[:3], spacings=arrays[3]),
        patch_size=PATCH, overlap=0.5, batch_size=3, with_hd95=True,
        device="cpu")
    assert set(ours) == set(theirs)
    assert ours["hd95_unit"] == "mm" and ours["num_volumes"] == 3
    assert ours["compiled_programs"] == 3  # three window grids
    for s, v in theirs["per_structure_dice"].items():
        assert ours["per_structure_dice"][s] == pytest.approx(v, rel=1e-12)
    held = 0
    for s, v in theirs["per_structure_hd95"].items():
        if v is None:
            assert ours["per_structure_hd95"][s] is None, s
            continue
        held += 1
        np.testing.assert_allclose(ours["per_structure_hd95"][s], v,
                                   rtol=1e-6, err_msg=s)
    assert held >= 5
    # voxel units without spacings; the same Dice
    plain = evaluate.evaluate_3d_sliding_window(
        model, cfg, PackedDataset3D(*arrays[:3]), PATCH, 0.5, 3,
        with_hd95=True, device="cpu")
    assert plain["hd95_unit"] == "voxel"
    assert plain["per_structure_dice"] == ours["per_structure_dice"]
    with pytest.raises(ValueError, match="empty"):
        evaluate.evaluate_3d_sliding_window(
            model, cfg, PackedDataset3D([], [], []), PATCH, device="cpu")


def test_evaluate_cli_runs_a_3d_checkpoint(tmp_path, capsys):
    cfg, model, _, _ = _pair("patch", seed=2)
    save_checkpoint(tmp_path / "m3d.ckpt", cfg, model)
    arrays = _eval_split(6, depths=(8, 6))  # one grid: both run at depth 8
    PackedDataset3D(*arrays[:3], spacings=arrays[3]).save(
        tmp_path / "test_packed.npz")
    out = tmp_path / "report.json"
    evaluate.main(["--checkpoint", str(tmp_path / "m3d.ckpt"), "--data_dir",
                   str(tmp_path), "--hd95", "--throughput", "--device", "cpu",
                   "--patch_size", *map(str, PATCH), "--out", str(out)])
    text = capsys.readouterr().out
    assert "HD95(mm)" in text and "vols/min" in text
    import json

    report = json.loads(out.read_text())
    assert report["num_volumes"] == 2 and report["hd95_unit"] == "mm"
    assert report["throughput"]["num_volumes"] == 2
    assert report["throughput"]["compiled_programs"] == 1
