"""The port's 3D training slice against the JAX package, on the CPU.

  - `DevicePipeline3D` resizes each volume as `jax.image.resize(...,
    "nearest")` does, on odd sizes; `PatchPipeline3D` gathers the JAX
    pipeline's patches exactly, given the JAX draws (volume, top, left and
    the front from its uniform, in float32 as the reference rounds it).
  - Trajectory: 3 Trainer steps of each mode, in float64 at filters (4, 8,
    16), 2 residual units, one input channel, on (16, 16, 8) volumes or
    patches (the bottom level keeps 4 x 4 x 2 voxels: below that the
    one-pass variance drifts under Adam's eps): the port's
    `make_trainer_3d` against the JAX `make_trainer_3d` Trainer's jitted
    step from the same weights, the patch transform's flips drawn by the
    reference's own calls (trainer3d.py:42-45) and fed to the port; every
    parameter within 1e-8 after every step, the losses within 1e-9, the
    (float32) Dice within 1e-6. Then an eval step on a padded batch, the
    same; in patch mode with the flips of the reference's eval key 0.
    Resize mode trains CrossEntropy (the reference's parity settings),
    patch mode Focal+Dice with exclude_missing. Under jit, XLA rounds the
    soft-tissue window by up to one float32 ulp away from its eager form
    (as the 2D degree-2 transform, tests/test_torch_train_step.py), which
    Adam's first steps lift past 1e-8; so in patch mode the JAX step and
    eval step take the port's transform output through identity
    transforms, and the port's transform is held equal to the eager JAX
    transform and within one ulp of the jitted one.
  - The 3D Trainer's transforms (a config's mode, overrides), the patch size
    rule of make_trainer_3d, and the `train_3d` CLI: both modes train, save
    and resume through Trainer.fit, on a tiny packed 3D split.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.data.datasets import PackedDataset3D as JaxPackedDataset3D
from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.training import schedule as jax_schedule
from ctseg_tpu.training.optimizer import adam_init
from ctseg_tpu.training.trainer import TrainConfig as JaxTrainConfig
from ctseg_tpu.training.trainer import Trainer as JaxTrainer
from ctseg_tpu.training.trainer import TrainState as JaxTrainState
from ctseg_tpu.transforms.pipelines import batched_transform
from ctseg_tpu.volumetric import pipeline3d as jax_pipeline3d
from ctseg_tpu.volumetric.trainer3d import (
    _windowed_patch_transform as jax_patch_transform,
)
from ctseg_tpu.volumetric.trainer3d import make_trainer_3d as jax_make_trainer_3d
from ctseg_tpu_torch.data.datasets import PackedDataset3D
from ctseg_tpu_torch.training import checkpoint, cli
from ctseg_tpu_torch.training.config import TrainConfig
from ctseg_tpu_torch.training.trainer import Trainer
from ctseg_tpu_torch.transforms import volumetric
from ctseg_tpu_torch.transforms.volumetric import FlipDraws
from ctseg_tpu_torch.volumetric import pipeline3d
from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d

FILTERS = (4, 8, 16)
STRIDES = (2, 2)
PATCH = (16, 16, 8)
BATCH, STEPS = 4, 3


def _volumes(seed, depths, h=40, w=40):
    """(D, H, W) int16 HU volumes with box structures, uint8 labels, 0/1
    indicators and z-first spacings."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for d in depths:
        lab = np.zeros((d, h, w), np.uint8)
        for c in range(1, 10):
            if rng.random() < 0.2:
                continue
            z, y, x = (rng.integers(0, max(d - 3, 1)),
                       rng.integers(0, h - 9), rng.integers(0, w - 9))
            lab[z:z + rng.integers(2, 6), y:y + rng.integers(3, 9),
                x:x + rng.integers(3, 9)] = c
        images.append((rng.normal(40, 200, (d, h, w)) + 50.0 * lab)
                      .astype(np.int16))
        labels.append(lab)
    indicators = [rng.integers(0, 2, 9).astype(np.float32)
                  for _ in depths]
    indicators[0][:] = 1.0
    spacings = [rng.uniform(0.5, 3.0, 3).astype(np.float32) for _ in depths]
    return images, labels, indicators, spacings


# ---------------------------------------------------------------- pipelines
def test_device_pipeline_3d_resize_matches_jax():
    images, labels, indicators, _ = _volumes(0, (13, 9), h=37, w=29)
    shape = (17, 23, 11)  # (H, W, D): up along H, down along W and D
    ours = pipeline3d.DevicePipeline3D(
        PackedDataset3D(images, labels, indicators), 2, shape, "cpu")
    theirs = jax_pipeline3d.DevicePipeline3D(
        JaxPackedDataset3D(images, labels, indicators), 2, shape)
    np.testing.assert_array_equal(ours.images.numpy(),
                                  np.asarray(theirs.images))
    np.testing.assert_array_equal(ours.labels.numpy(),
                                  np.asarray(theirs.labels))
    assert ours.images.shape == (2,) + shape
    assert ours.num_batches() == 1
    batch = next(ours.padded_epoch())
    assert len(batch) == 4 and bool(batch[3].all())
    with pytest.raises(ValueError, match="smaller than one batch"):
        pipeline3d.DevicePipeline3D(
            PackedDataset3D(images, labels, indicators), 3, shape, "cpu")


def _jax_patch_draws(key, depths, n_volumes, h, w, patch, b):
    """The draws of the JAX PatchPipeline3D's batch at `key`
    (pipeline3d.py:146-154), and its uniform."""
    ph, pw, pd = patch
    kv, kh, kw, kd = jax.random.split(key, 4)
    vol = jax.random.randint(kv, (b,), 0, n_volumes)
    top = jax.random.randint(kh, (b,), 0, h - ph + 1)
    left = jax.random.randint(kw, (b,), 0, w - pw + 1)
    u = jax.random.uniform(kd, (b,))
    dmax = jnp.maximum(jnp.take(jnp.asarray(depths), vol) - pd, 0)
    front = (u * (dmax + 1)).astype(jnp.int32)
    return [torch.from_numpy(np.asarray(v).astype(np.int64))
            for v in (vol, top, left, front)], np.array(u)


def test_patch_pipeline_gathers_the_jax_patches_given_its_draws():
    depths = (20, 12, 6)
    images, labels, indicators, _ = _volumes(1, depths)
    ours = pipeline3d.PatchPipeline3D(
        PackedDataset3D(images, labels, indicators), BATCH, PATCH, 3, "cpu")
    theirs = jax_pipeline3d.PatchPipeline3D(
        JaxPackedDataset3D(images, labels, indicators), BATCH, PATCH,
        steps_per_epoch=3)
    for s in range(3):
        key = jax.random.key(s)
        (vol, top, left, front), u = _jax_patch_draws(
            key, depths, 3, 40, 40, PATCH, BATCH)
        np.testing.assert_array_equal(
            pipeline3d.front_from_uniform(
                torch.from_numpy(u), ours.depths[vol], PATCH[2]).numpy(),
            front.numpy())
        batch = ours.gather(pipeline3d.PatchDraws(vol, top, left, front))
        for a, b in zip(batch, theirs._sample(key)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port's own draws stay inside each volume's own depth
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        d = ours.draw(gen)
        room = torch.clamp_min(ours.depths[d.volume] - PATCH[2], 0)
        assert bool((d.front >= 0).all() and (d.front <= room).all())
        assert bool((d.top <= 40 - PATCH[0]).all())
    assert ours.num_batches() == 3
    batches = list(ours.padded_epoch())
    assert len(batches) == 3 and batches[0][0].shape == (BATCH,) + PATCH
    # no generator: the fixed draws of seed 0, as the reference's key 0
    again = list(ours.epoch())
    assert all(torch.equal(a[0], b[0]) for a, b in zip(batches, again))


# --------------------------------------------------------------- trajectory
def _jax_flips(key, n):
    """The per-sample flips `_windowed_patch_transform` draws from `key`
    under batched_transform (trainer3d.py:42-45)."""
    hs, ws = [], []
    for k in jax.random.split(key, n):
        k1, k2 = jax.random.split(k)
        hs.append(bool(jax.random.bernoulli(k1, 0.5)))
        ws.append(bool(jax.random.bernoulli(k2, 0.5)))
    return FlipDraws(torch.tensor(hs), torch.tensor(ws))


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    images = rng.normal(40, 300, size=(n,) + PATCH).astype(np.float32)
    labels = rng.integers(0, 10, size=(n,) + PATCH).astype(np.uint8)
    indicators = rng.integers(0, 2, size=(n, 9)).astype(np.float32)
    indicators[0] = 1.0
    return images, labels, indicators


MODES = {
    "resize": dict(loss_fx=("CrossEntropy",), exclude_missing=False),
    "patch": dict(loss_fx=("Focal", "Dice"), exclude_missing=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trajectory_and_eval_match_the_jax_3d_trainer(mode):
    jcfg = JaxTrainConfig(
        filters=FILTERS, num_res_units=2, transform_degree=0,
        batch_size=BATCH, spatial_dims=3, input_shape=PATCH, in_channels=1,
        plateau_patience=10_000, compute_dtype="float64", **MODES[mode])
    jtr = jax_make_trainer_3d(jcfg, mode=mode, patch_size=PATCH)
    if mode == "patch":
        ident = lambda key, img, lab: (img, lab)  # noqa: E731
        jtr = JaxTrainer(jtr.config, train_transform=ident,
                         test_transform=ident)
    tr = make_trainer_3d(TrainConfig.from_dict(jcfg.as_dict()), mode, PATCH,
                         device="cpu")
    assert tr.config.as_dict() == jtr.config.as_dict()
    state = tr.init_state()
    params = import_monai_state_dict(state.model.state_dict(), 1, FILTERS,
                                     strides=STRIDES, num_res_units=2,
                                     dtype=jnp.float64)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           opt_state=adam_init(params),
                           plateau=jax_schedule.plateau_init(jcfg.lr))
    images, labels, indicators = _batch(0)
    batch = tuple(torch.from_numpy(a) for a in (images, labels, indicators))
    jbatch = (jnp.asarray(images), jnp.asarray(labels, jnp.int32),
              jnp.asarray(indicators))
    key = jax.random.key(1)
    names = ["loss/total"] + [f"loss/{k}" for k in jcfg.loss_fx]
    for step in range(STEPS):
        k_transform, _ = jax.random.split(jax.random.fold_in(key, step))
        draws = None
        if mode == "patch":
            draws = _jax_flips(k_transform, BATCH)
            jbatch = _held_patch_transform(k_transform, tr, batch, draws)
        jstate, jm = jtr._train_step(jstate, jbatch, key)
        state, m = tr.train_step(state, batch, draws)
        for k in names:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-9,
                                       atol=1e-9, err_msg=f"step {step} {k}")
        np.testing.assert_allclose(float(m["dice/mean"]),
                                   float(jm["dice/mean"]), rtol=1e-6,
                                   err_msg=f"step {step}")
        ref = {k: v.numpy() for k, v in state_dict(jstate.params).items()}
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=0, atol=1e-8,
                                       err_msg=f"step {step}: {k}")
    assert state.step == int(jstate.step) == STEPS

    ev_images, ev_labels, ev_ind = _batch(1)
    row_valid = np.array([True, True, True, False])
    ev = tuple(torch.from_numpy(a) for a in (ev_images, ev_labels, ev_ind))
    jev = (jnp.asarray(ev_images), jnp.asarray(ev_labels, jnp.int32),
           jnp.asarray(ev_ind))
    draws = None
    if mode == "patch":
        draws = _jax_flips(jax.random.key(0), BATCH)
        jev = _held_patch_transform(jax.random.key(0), tr, ev, draws)
    jmetrics, jn = jtr._eval_step(jstate.params,
                                  jev + (jnp.asarray(row_valid),))
    metrics, n_valid = tr.eval_step(
        state.model, ev + (torch.from_numpy(row_valid),), draws)
    assert float(n_valid) == float(jn) == 3.0
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        tol = 1e-6 if k.startswith("dice/") else 1e-9
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=tol, atol=1e-9, err_msg=k)


def _held_patch_transform(key, tr, batch, draws):
    """The port's patch transform of `batch` with the flips of `key`, held
    equal to the eager JAX transform and within one float32 ulp of the
    jitted one; returned as the JAX step's (pre-transformed) batch."""
    images, labels, indicators = batch
    t_img, t_lab = tr.train_transform(images, labels, draws)
    args = (jax_patch_transform, key, jnp.asarray(images.numpy()),
            jnp.asarray(labels.numpy(), jnp.int32))
    e_img, e_lab = batched_transform(*args)
    j_img, _ = jax.jit(batched_transform, static_argnums=0)(*args)
    np.testing.assert_array_equal(t_img.numpy(), np.asarray(e_img))
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(e_lab))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=0,
                               atol=2.0 ** -23)
    return (jnp.asarray(t_img.numpy()), jnp.asarray(e_lab),
            jnp.asarray(indicators.numpy()))


def state_dict(params):
    from ctseg_tpu_torch.models.jax_import import state_dict_from_jax_params

    return state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), 1, FILTERS, STRIDES,
        num_res_units=2)


# ---------------------------------------------------------------- the trainer
def test_3d_trainers_take_their_modes_transforms():
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, spatial_dims=3,
                      in_channels=1, input_shape=PATCH)
    resize = Trainer(cfg, "cpu")
    assert resize.train_transform is volumetric._identity_transform
    assert resize.test_transform is volumetric._identity_transform
    patch = Trainer(dataclasses.replace(cfg, volumetric_mode="patch"), "cpu")
    assert patch.test_transform is volumetric._windowed_patch_transform
    # each side falls back on its own
    own = lambda images, labels, draws: (images[..., None], labels)  # noqa: E731
    mixed = Trainer(dataclasses.replace(cfg, volumetric_mode="patch"), "cpu",
                    train_transform=own)
    assert mixed.train_transform is own
    assert mixed.test_transform is volumetric._windowed_patch_transform
    assert mixed.draw(None, torch.zeros((2,) + PATCH)) is None

    images, labels, _ = _batch(2, n=2)
    draws = FlipDraws(torch.tensor([True, False]), torch.tensor([True, True]))
    img, lab = volumetric._windowed_patch_transform(
        torch.from_numpy(images), torch.from_numpy(labels), draws)
    assert img.shape == (2,) + PATCH + (1,)
    np.testing.assert_array_equal(lab[0].numpy(), labels[0][::-1, ::-1])
    np.testing.assert_array_equal(lab[1].numpy(), labels[1][:, ::-1])
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


def test_make_trainer_3d_patch_size_sets_the_grid():
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, spatial_dims=3,
                      in_channels=1, input_shape=(32, 32, 16))
    tr = make_trainer_3d(cfg, "patch", PATCH, device="cpu")
    assert tr.config.input_shape == PATCH
    assert tr.config.volumetric_mode == "patch"
    assert make_trainer_3d(cfg, "resize", PATCH, device="cpu"
                           ).config.input_shape == (32, 32, 16)
    default = make_trainer_3d(device="cpu")
    assert default.config.input_shape == pipeline3d.RESIZE_SHAPE
    assert default.config.loss_fx == ("CrossEntropy",)
    with pytest.raises(ValueError, match="divide"):
        make_trainer_3d(cfg, "patch", (16, 16, 6), device="cpu").init_state()


# ------------------------------------------------------------------------ CLI
def _split(tmp_path, depths=(12, 10, 9)):
    for split, seed in (("train", 3), ("valid", 4), ("test", 5)):
        images, labels, indicators, spacings = _volumes(seed, depths, 24, 24)
        PackedDataset3D(images, labels, indicators,
                        spacings=spacings).save(tmp_path / f"{split}_packed.npz")


def test_train_3d_cli_trains_saves_and_resumes_both_modes(tmp_path):
    _split(tmp_path)
    common = ["--data_dir", str(tmp_path), "--device", "cpu", "--filters",
              *map(str, FILTERS)]
    ck = tmp_path / "patch"
    cli.main(["train_3d", *common, "--volumetric_mode", "patch",
              "--patch_size", *map(str, PATCH), "--batch_size", "2",
              "--steps_per_epoch", "2", "--max_epochs", "1",
              "--loss_fx", "Focal", "Dice", "--exclude_missing",
              "--checkpoint_dir", str(ck)])
    cfg, state = checkpoint.load(ck / "model.ckpt", "cpu")
    assert state.step == 2 and cfg.spatial_dims == 3
    assert cfg.volumetric_mode == "patch" and cfg.input_shape == PATCH
    assert cfg.steps_per_epoch == 2
    # the checkpoint's schedule wins over a conflicting flag
    with pytest.warns(UserWarning, match="steps_per_epoch 5 ignored"):
        cli.main(["train_3d", *common, "--volumetric_mode", "patch",
                  "--steps_per_epoch", "5", "--max_epochs", "2",
                  "--resume", str(ck / "model.ckpt"),
                  "--checkpoint_dir", str(ck)])
    _, state = checkpoint.load(ck / "model.ckpt", "cpu")
    assert state.step == 4
    assert (ck / "metrics.jsonl").read_text().count("val/dice/mean") == 2

    rk = tmp_path / "resize"
    cli.main(["train_3d", *common, "--resize_shape", "16", "16", "8",
              "--batch_size", "2", "--max_epochs", "1",
              "--checkpoint_dir", str(rk)])
    cfg, state = checkpoint.load(rk / "model.ckpt", "cpu")
    assert state.step == 1 and cfg.volumetric_mode == "resize"
    assert cfg.loss_fx == ("Focal", "Dice") and cfg.input_shape == (16, 16, 8)
    with pytest.raises(SystemExit, match="2D configuration"):
        cli.main(["train_3d", *common, "--preset", "model_l"])
