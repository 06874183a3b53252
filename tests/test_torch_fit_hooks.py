"""Around the trainer: degree-0 training, fit's callbacks and asynchronous
checkpoints, the examples callback, profiling, and the train CLI's
defaults, against the JAX package where it has a counterpart.

  - Trajectory: 3 Trainer steps at degree 0 (one soft-tissue channel, crop
    and OneOf(elastic, grid), Focal+Dice, exclude_missing, Adam) against
    the JAX Trainer's jitted step from the same weights (models/jax_import)
    in float64 at filters (4, 8, 16, 32, 64) on 72x72 slices cropped to 64:
    every parameter within 1e-8 after every step, losses within 1e-9, Dice
    within 1e-6 (tests/test_torch_train_step.py's bounds). The JAX step
    trains on the port's transform output (an identity train_transform);
    the transform itself is held to the eager JAX one in
    tests/test_torch_augment_warps.py. Model M (weighted mixup,
    Boundary+Dice+Focal) takes one such step at degree 0, its mixup drawn
    by the JAX calls.
  - AsyncCheckpointer: the file holds the state at the save, not the
    state the loop reached meanwhile; a failure in the worker is raised by
    wait(); SIGTERM after an earlier async save failed still saves.
  - fit calls each callback once an epoch, after the epoch's save.
  - ExamplesLoggingCallback's panels equal the JAX callback's for the same
    weights (float64 models; images through float32 transforms, 1e-5).
  - profiling.trace writes a Chrome trace on the CPU, with the port's spans
    and their args in it; a span is a shared no-op with no profiler;
    debug_mode runs there.
  - The train CLI defaults to degree 0 and a 1-channel model, saves every
    --checkpoint_every epochs, writes the panels and, with --profile, a
    trace; train_mixup takes --transform_degree as train does.
"""

import json
import signal
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.training import mixup as jax_mixup
from ctseg_tpu.training import schedule as jax_schedule
from ctseg_tpu.training.callbacks import \
    ExamplesLoggingCallback as JaxExamplesCallback
from ctseg_tpu.training.optimizer import adam_init
from ctseg_tpu.training.trainer import TrainConfig as JaxTrainConfig
from ctseg_tpu.training.trainer import Trainer as JaxTrainer
from ctseg_tpu.training.trainer import TrainState as JaxTrainState
from ctseg_tpu_torch.data.datasets import PackedDataset2D
from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
from ctseg_tpu_torch.models.jax_import import state_dict_from_jax_params
from ctseg_tpu_torch.training import checkpoint, cli
from ctseg_tpu_torch.training.callbacks import ExamplesLoggingCallback
from ctseg_tpu_torch.training.config import TrainConfig
from ctseg_tpu_torch.training.trainer import Preempted, Trainer
from ctseg_tpu_torch.utils import profiling

FILTERS = (4, 8, 16, 32, 64)
RAW, SIZE, BATCH, STEPS = 72, 64, 4, 3


def _in_channels(model):
    """The stem conv's input channels (its weight is the first of rank 4)."""
    return next(v for v in model.state_dict().values() if v.ndim == 4).shape[1]


def _data(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    images = rng.normal(40, 300, size=(n, RAW, RAW)).astype(np.float32)
    labels = rng.integers(0, 10, size=(n, RAW, RAW)).astype(np.uint8)
    indicators = rng.integers(0, 2, size=(n, 9)).astype(np.float32)
    indicators[0] = 1.0
    return images, labels, indicators


def _jax_params(model, res_units, dtype=jnp.float64):
    return import_monai_state_dict(model.state_dict(), 1, FILTERS,
                                   num_res_units=res_units, dtype=dtype)


def _jax_state(params):
    return JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                         opt_state=adam_init(params),
                         plateau=jax_schedule.plateau_init(1e-3))


def _assert_params(state, jparams, res_units, step):
    ref = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jparams), 1, FILTERS,
        num_res_units=res_units)
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-8, err_msg=f"step {step}: {k}")


# -------------------------------------------------------------- trajectory
def test_degree0_trajectory_matches_the_jax_trainer():
    jcfg = JaxTrainConfig(filters=FILTERS, num_res_units=2, transform_degree=0,
                          input_size=SIZE, batch_size=BATCH,
                          exclude_missing=True, compute_dtype="float64")
    jtr = JaxTrainer(jcfg, train_transform=lambda key, img, lab: (img, lab))
    tr = Trainer(TrainConfig.from_dict(jcfg.as_dict()), "cpu")
    state = tr.init_state()
    assert _in_channels(state.model) == 1
    jstate = _jax_state(_jax_params(state.model, 2))
    images, labels, indicators = _data(0)
    batch = tuple(torch.from_numpy(a) for a in (images, labels, indicators))
    gen = torch.Generator().manual_seed(1)
    key = jax.random.key(1)
    choices = set()
    for step in range(STEPS):
        draws = tr.draw(gen, batch[0])
        choices |= set(draws.choice.tolist())
        t_images, t_labels = tr.train_transform(batch[0], batch[1], draws)
        assert t_images.shape == (BATCH, SIZE, SIZE, 1)
        jstate, jm = jtr._train_step(jstate, (
            jnp.asarray(t_images.numpy()), jnp.asarray(t_labels.numpy()),
            jnp.asarray(indicators)), key)
        state, m = tr.train_step(state, batch, draws)
        for k in ("loss/Focal", "loss/Dice", "loss/total"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-9,
                                       atol=1e-9, err_msg=f"step {step} {k}")
        np.testing.assert_allclose(float(m["dice/mean"]),
                                   float(jm["dice/mean"]), rtol=1e-6)
        _assert_params(state, jstate.params, 2, step)
    assert choices == {0, 1}


def test_model_m_step_at_degree0_matches_the_jax_trainer():
    alpha = 0.2
    jcfg = JaxTrainConfig(
        filters=FILTERS, num_res_units=1, transform_degree=0, input_size=SIZE,
        batch_size=BATCH, loss_fx=("Boundary", "Dice", "Focal"),
        exclude_missing=True, mixup=True, mixup_alpha=alpha,
        compute_dtype="float64")
    jtr = JaxTrainer(jcfg, train_transform=lambda key, img, lab: (img, lab))
    tr = Trainer(TrainConfig.from_dict(jcfg.as_dict()), "cpu")
    state = tr.init_state()
    jstate = _jax_state(_jax_params(state.model, 1))
    images, labels, indicators = _data(3)
    batch = tuple(torch.from_numpy(a) for a in (images, labels, indicators))
    key = jax.random.key(2)
    draws = tr.draw(torch.Generator().manual_seed(4), batch[0])
    t_images, t_labels = tr.train_transform(batch[0], batch[1], draws)
    # (index, lambda) of the JAX step's own mixup calls (trainer.py:308)
    _, k_mixup = jax.random.split(jax.random.fold_in(key, 0))
    _, index, lam = jax_mixup.weighted_mixup(
        k_mixup, jnp.zeros((BATCH, 1)), jnp.asarray(t_labels.numpy()), alpha)
    mixup_draws = (torch.from_numpy(np.array(index)),
                   torch.tensor(float(lam), dtype=torch.float64))
    jstate, jm = jtr._train_step(jstate, (
        jnp.asarray(t_images.numpy()), jnp.asarray(t_labels.numpy(), jnp.int32),
        jnp.asarray(indicators)), key)
    state, m = tr.train_step(state, batch, draws, mixup_draws=mixup_draws)
    for k in ("loss/Boundary", "loss/Focal", "loss/Dice", "loss/total"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-9,
                                   atol=1e-9, err_msg=k)
    _assert_params(state, jstate.params, 1, 0)


# ------------------------------------------------------ fit and checkpoints
def _tiny_trainer(**kw):
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, input_size=SIZE,
                      batch_size=BATCH, exclude_missing=True, **kw)
    return Trainer(cfg, "cpu")


def _state_dicts(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            state.step)


def test_async_checkpoint_holds_the_state_at_the_save(tmp_path):
    tr = _tiny_trainer()
    batch = tuple(torch.from_numpy(a) for a in _data(4))
    gen = torch.Generator().manual_seed(1)
    state = tr.init_state()
    state, _ = tr.train_step(state, batch, generator=gen)
    want, step = _state_dicts(state)
    saver = checkpoint.AsyncCheckpointer()
    saver.save(tmp_path / "a.ckpt", tr.config, state)
    for _ in range(2):  # the loop goes on while the worker writes
        state, _ = tr.train_step(state, batch, generator=gen)
    saver.wait()
    _, saved = checkpoint.load(tmp_path / "a.ckpt", "cpu")
    assert saved.step == step == 1 and state.step == 3
    for k, v in saved.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert not all(torch.equal(v, state.model.state_dict()[k])
                   for k, v in want.items())
    # the optimizer's moments are those of step 1 too: resuming from the
    # file repeats the trajectory
    tr2, resumed = Trainer.restore(tmp_path / "a.ckpt", "cpu")
    assert resumed.optimizer.state_dict()["state"][0]["step"] == 1


def test_async_checkpoint_failure_surfaces_on_wait(tmp_path, monkeypatch):
    tr = _tiny_trainer()
    state = tr.init_state()
    saver = checkpoint.AsyncCheckpointer()
    (tmp_path / "file").write_text("")
    saver.save(tmp_path / "file" / "a.ckpt", tr.config, state)  # no dir
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.wait()
    saver.wait()  # raised once
    saver.save(tmp_path / "b.ckpt", tr.config, state)
    saver.wait()
    assert (tmp_path / "b.ckpt").exists()
    assert not (tmp_path / "b.ckpt.tmp").exists()


def test_fit_calls_back_each_epoch_and_saves_on_sigterm_after_a_failure(
        tmp_path, monkeypatch):
    ds = PackedDataset2D(*_data(5, n=8))
    calls = []
    tr = _tiny_trainer(epochs=2)
    state = tr.fit(tr.init_state(), DevicePipeline2D(ds, 4, "cpu"),
                   epochs=2, checkpoint_path=tmp_path / "c.ckpt",
                   checkpoint_every=1,
                   callbacks=[lambda t, s, e: calls.append((e, s.step))])
    assert calls == [(0, 2), (1, 4)] and state.step == 4
    _, saved = checkpoint.load(tmp_path / "c.ckpt", "cpu")
    assert saved.step == 4

    # The periodic save after epoch 0 fails in its worker; SIGTERM during
    # epoch 1 still saves, synchronously, and fit raises Preempted.
    real_write = checkpoint._write
    failed = []

    def write_once_failing(path, payload):
        if not failed:
            failed.append(path)
            raise OSError("disk full")
        real_write(path, payload)

    monkeypatch.setattr(checkpoint, "_write", write_once_failing)
    tr2 = _tiny_trainer(epochs=3)

    def sigterm_after_epoch_0(trainer, s, epoch):
        if epoch == 0:
            signal.raise_signal(signal.SIGTERM)

    with pytest.raises(Preempted) as exc:
        tr2.fit(tr2.init_state(), DevicePipeline2D(ds, 4, "cpu"), epochs=3,
                checkpoint_path=tmp_path / "p.ckpt", checkpoint_every=1,
                callbacks=[sigterm_after_epoch_0])
    assert failed and exc.value.epoch == 1 and exc.value.state.step == 4
    _, saved = checkpoint.load(tmp_path / "p.ckpt", "cpu")
    assert saved.step == 4
    assert signal.getsignal(signal.SIGTERM) is not None


# ------------------------------------------------------ examples callback
def test_examples_panels_equal_the_jax_callbacks(tmp_path):
    images, labels, indicators = _data(6, n=5)
    names = [f"0522c0001_{i}" for i in range(5)]
    jcfg = JaxTrainConfig(filters=FILTERS, num_res_units=2, transform_degree=0,
                          input_size=SIZE, exclude_missing=True,
                          compute_dtype="float64")
    tr = Trainer(TrainConfig.from_dict(jcfg.as_dict()), "cpu")
    state = tr.init_state()
    jtr = JaxTrainer(jcfg)
    jstate = SimpleNamespace(params=_jax_params(state.model, 2), step=0)

    from ctseg_tpu.data.datasets import PackedDataset2D as JaxPacked2D
    ours_ds = PackedDataset2D(images, labels, indicators, names=names)
    theirs_ds = JaxPacked2D(images, labels, indicators, names=names)
    ExamplesLoggingCallback(ours_ds, tmp_path / "port", every_n_epochs=2,
                            max_examples=3)(tr, state, 1)
    JaxExamplesCallback(theirs_ds, tmp_path / "jax", every_n_epochs=2,
                        max_examples=3)(jtr, jstate, 1)
    ours = sorted((tmp_path / "port" / "epoch_0002").glob("*.npy"))
    theirs = sorted((tmp_path / "jax" / "epoch_0002").glob("*.npy"))
    assert [p.name for p in ours] == [p.name for p in theirs] and len(ours) == 3
    for a, b in zip(ours, theirs):
        pa, pb = np.load(a), np.load(b)
        assert pa.shape == (SIZE, 3 * SIZE, 3)
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-5, err_msg=a.name)
    assert state.model.training  # the callback leaves the mode as it was
    # an epoch off the period writes nothing
    ExamplesLoggingCallback(ours_ds, tmp_path / "none", every_n_epochs=2)(
        tr, state, 0)
    assert not (tmp_path / "none").exists()


# --------------------------------------------------------------- profiling
def test_profiling_runs_on_the_cpu(tmp_path):
    # no profiler: one shared no-op context, whatever the name
    assert profiling.span("ctseg.a", {"step": 1}) is profiling.span("ctseg.b")
    with profiling.trace(str(tmp_path / "profile")) as prof:
        with profiling.span("ctseg.step", {"step": 7}):
            x = torch.ones(64, 64)
            profiling.to_host((x @ x).sum())
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())
    named = {e["name"]: e for e in trace["traceEvents"]
             if e.get("name", "").startswith("ctseg.")}
    assert set(named) == {"ctseg.step", "ctseg.sync"}
    assert named["ctseg.step"]["args"]["step"] == 7
    step, sync = named["ctseg.step"], named["ctseg.sync"]
    assert step["ts"] <= sync["ts"] and \
        sync["ts"] + sync["dur"] <= step["ts"] + step["dur"]

    model = torch.nn.Linear(2, 2)
    with profiling.debug_mode():
        model(torch.ones(1, 2)).sum().backward()
        with pytest.raises(profiling.NonFiniteError, match="Linear"):
            model(torch.full((1, 2), float("nan")))
    model(torch.full((1, 2), float("nan")))  # the hook is gone


# ---------------------------------------------------------------------- CLI
def test_train_cli_defaults_to_degree0_with_panels_and_a_profile(tmp_path):
    for split, seed in (("train", 7), ("valid", 8)):
        PackedDataset2D(*_data(seed, n=6)).save(tmp_path / f"{split}_packed.npz")
    ck = tmp_path / "run"
    cli.main(["train", "--data_dir", str(tmp_path), "--device", "cpu",
              "--filters", *map(str, FILTERS), "--use_res_units",
              "--exclude_missing", "--input_size", str(SIZE), "--batch_size",
              "4", "--checkpoint_dir", str(ck), "--max_epochs", "2",
              "--checkpoint_every", "1", "--profile"])
    cfg, state = checkpoint.load(ck / "model.ckpt", "cpu")
    assert cfg.transform_degree == 0 and state.step == 2
    assert _in_channels(state.model) == 1
    for epoch in (1, 2):
        assert len(list((ck / "examples" / f"epoch_{epoch:04d}").glob(
            "*.npy"))) == 6
    assert json.loads((ck / "profile" / "trace.json").read_text())[
        "traceEvents"]
    assert (ck / "metrics.jsonl").read_text().count("val/dice/mean") == 2
    # train_mixup takes the degree as train does
    mk = tmp_path / "mixup"
    cli.main(["train_mixup", "--data_dir", str(tmp_path), "--device", "cpu",
              "--filters", *map(str, FILTERS), "--input_size", str(SIZE),
              "--batch_size", "4", "--checkpoint_dir", str(mk),
              "--max_epochs", "1", "--transform_degree", "3", "--loss_fx",
              "Boundary", "Dice", "Focal"])
    cfg, state = checkpoint.load(mk / "model.ckpt", "cpu")
    assert cfg.mixup and cfg.transform_degree == 3 and state.step == 1
    assert _in_channels(state.model) == 3
