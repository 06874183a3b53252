"""The port's train step, Trainer and train CLI against the JAX package.

  - Trajectory: 3 Trainer steps of the port (degree 2 with injected draws,
    Focal+Dice, exclude_missing, Adam) against the JAX Trainer's jitted
    step from the same weights (carried by models/jax_import) and the draws
    the JAX step's own calls make from its keys, in float64 at filters
    (4, 8, 16, 32, 64) on 72x72 slices cropped to 64 (at 32 the bottom
    level is 2x2 pixels, where the JAX unit's one-pass variance and K2's
    two-pass variance drift apart under Adam): every parameter
    within 1e-8 after every step (tests/test_trajectory_oracle.py's bound),
    the step's losses within 1e-9 and its (float32) Dice within 1e-6. Then
    an eval step on a padded batch against the JAX eval step, the same.
    Under jit, XLA rounds the JAX degree-2 transform differently from its
    eager form by up to one float32 ulp (4.8e-7 measured); Adam's first
    steps divide by sqrt(v) + 1e-8, so a gradient near 1e-8 turns that into
    a 1e-6 parameter difference. The JAX step therefore trains on the
    port's transform output (an identity train_transform), which is held
    to the JAX jitted transform at one ulp here and to the eager one in
    tests/test_torch_train_kernels.py.
  - A bfloat16 config keeps float32 parameters and computes in bfloat16,
    like the JAX model's dtype/param_dtype split; its logits stay within
    the bfloat16 bound below of the JAX bfloat16 model's.
  - The plateau transition, the device pipeline, checkpoints, resume,
    preemption and the `train` and `train_mixup` CLIs, on the CPU.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.models import SegmentationModel as JaxSegmentationModel
from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.training import schedule as jax_schedule
from ctseg_tpu.training.optimizer import adam_init
from ctseg_tpu.training.trainer import TrainConfig as JaxTrainConfig
from ctseg_tpu.training.trainer import Trainer as JaxTrainer
from ctseg_tpu.training.trainer import TrainState as JaxTrainState
from ctseg_tpu.transforms import pipelines as jax_pipelines
from ctseg_tpu.transforms.pipelines import batched_transform
from ctseg_tpu_torch.data.datasets import PackedDataset2D
from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
from ctseg_tpu_torch.models.jax_import import state_dict_from_jax_params
from ctseg_tpu_torch.training import checkpoint, cli, schedule
from ctseg_tpu_torch.training.config import (
    TrainConfig,
    build_model,
    load_checkpoint,
)
from ctseg_tpu_torch.training.trainer import Preempted, Trainer
from ctseg_tpu_torch.transforms.augment import Degree2Draws, draw_degree2

FILTERS = (4, 8, 16, 32, 64)
RAW, SIZE, BATCH, STEPS = 72, 64, 4, 3


def _jax_draws(key, step, n, h, w, size):
    """The draws of the JAX Trainer's step `step` (trainer.py:308, then
    pipelines.batched_transform and _degree_2, augment.py:69-71,82,92-93)."""
    k_transform, _ = jax.random.split(jax.random.fold_in(key, step))
    tops, lefts, ks, flips = [], [], [], []
    for k in jax.random.split(k_transform, n):
        k1, k2, k3 = jax.random.split(k, 3)
        kh, kw = jax.random.split(k1)
        tops.append(int(jax.random.randint(kh, (), 0, h - size + 1)))
        lefts.append(int(jax.random.randint(kw, (), 0, w - size + 1)))
        kp, kk = jax.random.split(k2)
        ks.append(int(jnp.where(jax.random.bernoulli(kp, 0.5),
                                jax.random.randint(kk, (), 0, 4), 0)))
        flips.append(int(jax.random.bernoulli(k3, 0.5)))
    return Degree2Draws(*(torch.tensor(v, dtype=torch.int32)
                          for v in (tops, lefts, ks, flips)))


def _data(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    images = rng.normal(40, 300, size=(n, RAW, RAW)).astype(np.float32)
    labels = rng.integers(0, 10, size=(n, RAW, RAW)).astype(np.uint8)
    indicators = rng.integers(0, 2, size=(n, 9)).astype(np.float32)
    indicators[0] = 1.0
    return images, labels, indicators


def _port_params(params):
    return state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), 3, FILTERS, num_res_units=2
    )


def _jax_params(model, dtype):
    """The port's weights as JAX params (flax init on the CPU takes tens of
    seconds at this depth; the importer none)."""
    return import_monai_state_dict(model.state_dict(), 3, FILTERS,
                                   num_res_units=2, dtype=dtype)


def test_trajectory_and_eval_match_the_jax_trainer():
    jcfg = JaxTrainConfig(filters=FILTERS, num_res_units=2, transform_degree=2,
                          input_size=SIZE, batch_size=BATCH,
                          exclude_missing=True, compute_dtype="float64")
    jtr = JaxTrainer(jcfg, train_transform=lambda key, img, lab: (img, lab))
    tr = Trainer(TrainConfig.from_dict(jcfg.as_dict()), "cpu")
    state = tr.init_state()
    params = _jax_params(state.model, jnp.float64)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           opt_state=adam_init(params),
                           plateau=jax_schedule.plateau_init(jcfg.lr))

    images, labels, indicators = _data(0)
    batch = tuple(torch.from_numpy(a) for a in (images, labels, indicators))
    key = jax.random.key(1)
    jax_degree_2 = jax.jit(lambda k: batched_transform(
        jax_pipelines.get_transform(2, True, (SIZE, SIZE)),
        jax.random.split(jax.random.fold_in(key, k))[0],
        jnp.asarray(images), jnp.asarray(labels, jnp.int32)))
    for step in range(STEPS):
        draws = _jax_draws(key, step, BATCH, RAW, RAW, SIZE)
        t_images, t_labels = tr.train_transform(batch[0], batch[1], draws)
        j_images, j_labels = jax_degree_2(step)
        np.testing.assert_allclose(t_images.numpy(), np.asarray(j_images),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t_labels.numpy(), np.asarray(j_labels))
        jstate, jm = jtr._train_step(jstate, (
            jnp.asarray(t_images.numpy()), jnp.asarray(j_labels),
            jnp.asarray(indicators)), key)
        state, m = tr.train_step(state, batch, draws)
        for k in ("loss/Focal", "loss/Dice", "loss/total"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-9,
                                       atol=1e-9, err_msg=f"step {step} {k}")
        # Dice is a float32 metric in both packages
        np.testing.assert_allclose(float(m["dice/mean"]), float(jm["dice/mean"]),
                                   rtol=1e-6, err_msg=f"step {step}")
        ref = _port_params(jstate.params)
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                       atol=1e-8, err_msg=f"step {step}: {k}")
    assert state.step == int(jstate.step) == STEPS

    # an evaluation batch padded with two invalid rows
    ev_images, ev_labels, ev_ind = _data(1, n=BATCH)
    row_valid = np.array([True, True, False, False])
    jmetrics, jn = jtr._eval_step(jstate.params, (
        jnp.asarray(ev_images), jnp.asarray(ev_labels, jnp.int32),
        jnp.asarray(ev_ind), jnp.asarray(row_valid)))
    metrics, n_valid = tr.eval_step(state.model, tuple(
        torch.from_numpy(a) for a in (ev_images, ev_labels, ev_ind, row_valid)))
    assert float(n_valid) == float(jn) == 2.0
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        tol = 1e-6 if k.startswith("dice/") else 1e-9
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=tol, atol=1e-9, err_msg=k)


def test_bfloat16_config_keeps_float32_parameters():
    """A bfloat16 model computes in bfloat16 on float32 parameters, like the
    JAX model's dtype/param_dtype split. The two round at other places (the
    port's fused units add the bias and normalise in float32 before one
    rounding), so they are held to each other on average and by the size of
    their bfloat16 error: over 3 seeds the mean |port - JAX| was 0.13-0.22%
    of max |logit| and each model's mean distance from the float32 logits
    0.15-0.19%. The weights come from the port's initialiser."""
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, transform_degree=2,
                      input_size=32, compute_dtype="bfloat16")
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(4))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    params = _jax_params(model, jnp.float32)
    kw = dict(out_channels=10, channels=FILTERS, strides=(2,) * 4,
              num_res_units=2, param_dtype=jnp.float32)
    jm32 = JaxSegmentationModel(**kw)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JaxSegmentationModel(dtype=jnp.bfloat16, **kw)
    ref = np.asarray(jax.jit(jm.apply)(params, x).astype(jnp.float32))
    ref32 = np.asarray(jax.jit(jm32.apply)(params, x))
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.bfloat16
    ours = out.float().permute(0, 2, 3, 1).numpy()
    scale = float(np.abs(ref32).max())
    assert np.abs(ours - ref).mean() <= 5e-3 * scale
    assert np.abs(ours - ref32).mean() <= 2 * np.abs(ref - ref32).mean()


def test_building_a_model_turns_tf32_off():
    """Every entry point (Trainer, SegmentationService, predict, the train
    CLI) builds its model through build_model, which keeps cuDNN and cuBLAS
    from rounding float32 to TF32 on the card."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        build_model(TrainConfig(filters=FILTERS, transform_degree=2), "cpu")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.parametrize("metrics", [
    [0.1, 0.2, 0.2, 0.2, 0.2, 0.2, 0.3, 0.301, 0.3, 0.3, 0.3, 0.3],
    [0.5] * 9 + [0.0] * 6,
])
def test_plateau_matches_jax(metrics):
    ours = schedule.plateau_init(1e-3)
    theirs = jax_schedule.plateau_init(1e-3)
    for m in metrics:
        ours, lr = schedule.reduce_on_plateau(ours, m, patience=2)
        theirs, jlr = jax_schedule.reduce_on_plateau(theirs, m, patience=2)
        np.testing.assert_allclose(lr, float(jlr), rtol=1e-7)
        assert ours.num_bad_epochs == int(theirs.num_bad_epochs)
    assert ours.lr < 1e-3


def test_pipeline_epochs_cover_the_split():
    images, labels, indicators = _data(3, n=10)
    pipe = DevicePipeline2D(PackedDataset2D(images, labels, indicators), 4,
                            "cpu")
    assert pipe.num_batches() == 2 and pipe.num_batches(False) == 3
    seen = torch.cat([b[2] for b in pipe.epoch(torch.Generator().manual_seed(0))])
    assert seen.shape == (8, 9)
    batches = list(pipe.padded_epoch(None))
    assert [int(b[3].sum()) for b in batches] == [4, 4, 2]
    got = torch.cat([b[0] for b in batches])[:10]
    np.testing.assert_array_equal(got.numpy(), images)
    with pytest.raises(ValueError):
        DevicePipeline2D(PackedDataset2D(images, labels, indicators), 11,
                         "cpu")


def _tiny_trainer(**kw):
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, transform_degree=2,
                      input_size=SIZE, batch_size=BATCH, exclude_missing=True,
                      **kw)
    return Trainer(cfg, "cpu")


def test_checkpoint_resumes_the_same_trajectory(tmp_path):
    tr = _tiny_trainer()
    batch = tuple(torch.from_numpy(a) for a in _data(4))
    gen = torch.Generator().manual_seed(1)
    draws = [draw_degree2(gen, BATCH, RAW, RAW, SIZE) for _ in range(3)]

    state = tr.init_state()
    state, _ = tr.train_step(state, batch, draws[0])
    tr.save(tmp_path / "m.ckpt", state)
    for d in draws[1:]:
        state, _ = tr.train_step(state, batch, d)

    tr2, resumed = Trainer.restore(tmp_path / "m.ckpt", "cpu")
    assert resumed.step == 1 and tr2.config == tr.config
    for d in draws[1:]:
        resumed, _ = tr2.train_step(resumed, batch, d)
    for (k, a), b in zip(state.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)

    # the inference loader reads the same file: float32, MONAI keys
    cfg, model = load_checkpoint(tmp_path / "m.ckpt", "cpu")
    assert {v.dtype for v in model.state_dict().values()} == {torch.float32}
    assert not model.training and cfg.filters == FILTERS


def test_fit_reduces_lr_on_plateau_and_saves_on_sigterm(tmp_path):
    images, labels, indicators = _data(5, n=8)
    ds = PackedDataset2D(images, labels, indicators)
    tr = _tiny_trainer(plateau_patience=0, plateau_threshold=10.0, epochs=2)
    state = tr.fit(tr.init_state(), DevicePipeline2D(ds, 4, "cpu"),
                   DevicePipeline2D(ds, 3, "cpu"), epochs=2)
    # threshold 10: no epoch counts as better after the first; patience 0
    assert state.step == 4 and tr.config.steps_per_epoch == 2
    assert state.plateau.lr == pytest.approx(5e-4)

    tr2 = _tiny_trainer(epochs=3)
    real_epoch = tr2.train_epoch

    def epoch_then_sigterm(*a, **k):
        out = real_epoch(*a, **k)
        signal.raise_signal(signal.SIGTERM)
        return out

    tr2.train_epoch = epoch_then_sigterm
    with pytest.raises(Preempted) as exc:
        tr2.fit(tr2.init_state(), DevicePipeline2D(ds, 4, "cpu"), epochs=3,
                checkpoint_path=tmp_path / "p.ckpt")
    assert exc.value.epoch == 0 and exc.value.state.step == 2
    _, saved = checkpoint.load(tmp_path / "p.ckpt", "cpu")
    assert saved.step == 2
    assert signal.getsignal(signal.SIGTERM) is not None


def test_train_cli_trains_resumes_and_names_what_waits(tmp_path):
    for split, seed in (("train", 6), ("valid", 7)):
        PackedDataset2D(*_data(seed, n=6)).save(tmp_path / f"{split}_packed.npz")
    ck = tmp_path / "run"
    common = ["--data_dir", str(tmp_path), "--device", "cpu", "--filters",
              *map(str, FILTERS), "--use_res_units", "--exclude_missing",
              "--input_size", str(SIZE), "--batch_size", "4",
              "--checkpoint_dir", str(ck)]
    cli.main(["train", *common, "--max_epochs", "1"])
    _, state = checkpoint.load(ck / "model.ckpt", "cpu")
    assert state.step == 1
    cli.main(["train", *common, "--max_epochs", "2", "--resume",
              str(ck / "model.ckpt")])
    cfg, state = checkpoint.load(ck / "model.ckpt", "cpu")
    assert state.step == 2 and cfg.exclude_missing and cfg.num_res_units == 2
    assert (ck / "metrics.jsonl").read_text().count("val/dice/mean") == 2
    # train_mixup trains (1 residual unit, weighted mixup, the Boundary loss
    # with its distance maps); train_3d reads 3D splits
    # (tests/test_torch_3d_train.py trains it), not this 2D one
    mk = tmp_path / "run_mixup"
    cli.main(["train_mixup", *common[:-1], str(mk), "--max_epochs", "1",
              "--loss_fx", "Boundary", "Dice", "Focal"])
    cfg, state = checkpoint.load(mk / "model.ckpt", "cpu")
    assert state.step == 1 and cfg.mixup and cfg.num_res_units == 1
    assert cfg.loss_fx == ("Boundary", "Dice", "Focal")
    assert "train/loss/Boundary" in (mk / "metrics.jsonl").read_text()
    with pytest.raises(KeyError, match="image_0"):
        cli.main(["train_3d", *common])
    with pytest.raises(SystemExit, match="3D configuration"):
        cli.main(["train", *common, "--preset", "model_3d"])
