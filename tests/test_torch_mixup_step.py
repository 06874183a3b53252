"""Model M's train step (weighted mixup, Boundary+Dice+Focal), the 2D
evaluation with HD95 and their CLIs, against the JAX package.

  - `mixup_probability` vs the expression inside the JAX weighted_mixup
    (1e-6: float32 sums), and the mix from (index, lambda) drawn by the
    reference's own jax.random calls (mixup.py:48-52) fed to the port.
  - Trajectory: 3 Trainer steps of a narrow Model M (1 residual unit,
    degree 2 with injected draws, weighted mixup with the draws the JAX
    step makes from its key, trainer.py:308, Boundary+Dice+Focal with
    exclude_missing, Adam) against the JAX Trainer's jitted step from the
    same weights, in float64 on 72x72 slices cropped to 64: every
    parameter within 1e-8 after every step, the losses within 1e-9, the
    float32 Dice within 1e-6; then an eval step on a padded batch. As in
    tests/test_torch_train_step.py the JAX step trains on the port's
    transform output (XLA's jit rounds its own by one float32 ulp).
  - `evaluate_2d` with HD95 vs the JAX evaluate_2d on a packed split with
    per-slice spacings and a padded last batch: Dice 1e-6, HD95 1e-4
    relative, unit and slice count equal.
  - The generator's draws follow Beta(alpha, alpha) and the partner
    probabilities; the presets equal the JAX package's; the entry points
    default to the card and raise without one; the `train_mixup` and
    evaluate CLIs run on the CPU.
"""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.constants import ANNOTATION_COUNT
from ctseg_tpu.data.datasets import PackedDataset2D as JaxPackedDataset2D
from ctseg_tpu.inference.evaluate import evaluate_2d as jax_evaluate_2d
from ctseg_tpu.models import presets as jax_presets
from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.training import mixup as jax_mixup
from ctseg_tpu.training import schedule as jax_schedule
from ctseg_tpu.training.optimizer import adam_init
from ctseg_tpu.training.trainer import TrainConfig as JaxTrainConfig
from ctseg_tpu.training.trainer import Trainer as JaxTrainer
from ctseg_tpu.training.trainer import TrainState as JaxTrainState
from ctseg_tpu_torch.data.datasets import PackedDataset2D
from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
from ctseg_tpu_torch.inference import evaluate
from ctseg_tpu_torch.inference.serve import SegmentationService
from ctseg_tpu_torch.models import layers, presets
from ctseg_tpu_torch.models.jax_import import state_dict_from_jax_params
from ctseg_tpu_torch.models.unet import SegmentationModel
from ctseg_tpu_torch.training import checkpoint, cli, config, mixup
from ctseg_tpu_torch.training.config import TrainConfig
from ctseg_tpu_torch.training.trainer import Trainer
from ctseg_tpu_torch.transforms.augment import Degree2Draws

FILTERS = (4, 8, 16, 32, 64)
RAW, SIZE, BATCH, STEPS = 72, 64, 4, 3
ALPHA = 0.2


def _data(seed, n=BATCH, raw=RAW):
    rng = np.random.default_rng(seed)
    images = rng.normal(40, 300, size=(n, raw, raw)).astype(np.float32)
    labels = rng.integers(0, 10, size=(n, raw, raw)).astype(np.uint8)
    labels[1][labels[1] > 4] = 0      # a sample with few structures
    labels[2][labels[2] % 2 == 1] = 0
    indicators = rng.integers(0, 2, size=(n, 9)).astype(np.float32)
    indicators[0] = 1.0
    return images, labels, indicators


# ------------------------------------------------------------------ mixup
def _jax_probability(labels):
    """The partner probabilities as ctseg_tpu/training/mixup.py:36-46
    computes them."""
    count = jnp.asarray(ANNOTATION_COUNT, jnp.float32)
    indicator = jax_mixup.structure_presence(jnp.asarray(labels)) * count
    empty = jnp.sum(indicator, axis=1, keepdims=True) == 0
    indicator = indicator + empty * jnp.sum(count)
    nonzero = jnp.sum(indicator > 0, axis=1)
    probability = 1.0 / (jnp.sum(indicator, axis=1) / nonzero)
    return np.asarray(probability / jnp.sum(probability))


def test_mixup_probability_matches_jax():
    _, labels, _ = _data(0, n=6, raw=20)
    labels[3] = 0  # no structure at all: the full count row
    presence = mixup.structure_presence(torch.from_numpy(labels))
    np.testing.assert_array_equal(
        presence.numpy(),
        np.asarray(jax_mixup.structure_presence(jnp.asarray(labels))))
    ours = mixup.mixup_probability(torch.from_numpy(labels))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), _jax_probability(labels),
                               rtol=1e-6)
    assert len(set(ours.tolist())) > 2  # the samples do differ


def test_mix_with_the_reference_draws_matches_jax():
    images, labels, _ = _data(1, n=6, raw=20)
    key = jax.random.key(5)
    mixed, index, lam = jax_mixup.weighted_mixup(
        key, jnp.asarray(images), jnp.asarray(labels), ALPHA)
    # the reference's own calls, from the same key
    k_lambda, k_index = jax.random.split(key)
    assert float(jax.random.beta(k_lambda, ALPHA, ALPHA)) == float(lam)
    again = jax.random.categorical(
        k_index, jnp.log(_jax_probability(labels)), shape=(6,))
    np.testing.assert_array_equal(np.asarray(again), np.asarray(index))
    x = torch.from_numpy(images)
    idx = torch.from_numpy(np.array(index))
    ours = mixup.mixup_tensors(x, x[idx], torch.tensor(float(lam)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(mixed), rtol=1e-6,
                               atol=1e-4)  # |HU| up to 1e3 in float32


def test_draws_follow_beta_and_the_partner_probabilities():
    gen = torch.Generator().manual_seed(0)
    lam = mixup.sample_beta(gen, ALPHA, (20000,))
    assert lam.dtype == torch.float32 and lam.shape == (20000,)
    assert bool(((lam >= 0) & (lam <= 1)).all())
    # Beta(a, a): mean 1/2, variance 1 / (4 (2a + 1)) = 0.17857 at a = 0.2
    assert abs(float(lam.mean()) - 0.5) < 0.01
    assert abs(float(lam.var()) - 1 / (4 * (2 * ALPHA + 1))) < 0.005
    prob = torch.tensor([0.5, 0.25, 0.125, 0.125])
    picks = torch.cat([mixup.draw_mixup(gen, prob, ALPHA)[0]
                       for _ in range(2000)])
    freq = torch.bincount(picks, minlength=4).float() / picks.numel()
    np.testing.assert_allclose(freq.numpy(), prob.numpy(), atol=0.02)
    index, one = mixup.draw_mixup(gen, prob, ALPHA)
    assert index.shape == (4,) and index.dtype == torch.int64
    assert one.shape == () and one.dtype == torch.float32
    # the same seed gives the same draws
    a = mixup.draw_mixup(torch.Generator().manual_seed(3), prob, ALPHA)
    b = mixup.draw_mixup(torch.Generator().manual_seed(3), prob, ALPHA)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    images = torch.arange(8.0).reshape(4, 2)
    mixed, perm, lam1 = mixup.plain_mixup(gen, images, ALPHA)
    assert sorted(perm.tolist()) == [0, 1, 2, 3]
    torch.testing.assert_close(mixed, lam1 * images + (1 - lam1) * images[perm])
    labels = torch.from_numpy(_data(2, n=4, raw=12)[1])
    mixed, index, lam1 = mixup.weighted_mixup(gen, images, labels, ALPHA)
    torch.testing.assert_close(mixed, lam1 * images + (1 - lam1) * images[index])


# -------------------------------------------------------------- trajectory
def _jax_mixup_draws(key, step, labels):
    """(index, lambda) of the JAX Trainer's step `step` (trainer.py:308,
    314-317) for the transformed `labels`."""
    _, k_mixup = jax.random.split(jax.random.fold_in(key, step))
    _, index, lam = jax_mixup.weighted_mixup(
        k_mixup, jnp.zeros((labels.shape[0], 1)), jnp.asarray(labels), ALPHA)
    return (torch.from_numpy(np.array(index)),
            torch.tensor(float(lam), dtype=torch.float64))


def _jax_params(model, dtype):
    return import_monai_state_dict(model.state_dict(), 3, FILTERS,
                                   num_res_units=1, dtype=dtype)


def test_model_m_trajectory_and_eval_match_the_jax_trainer():
    jcfg = JaxTrainConfig(
        filters=FILTERS, num_res_units=1, transform_degree=2, input_size=SIZE,
        batch_size=BATCH, loss_fx=("Boundary", "Dice", "Focal"),
        exclude_missing=True, mixup=True, mixup_alpha=ALPHA,
        compute_dtype="float64")
    jtr = JaxTrainer(jcfg, train_transform=lambda key, img, lab: (img, lab))
    tr = Trainer(TrainConfig.from_dict(jcfg.as_dict()), "cpu")
    assert tr.needs_dist_maps and tr.config.mixup
    state = tr.init_state()
    params = _jax_params(state.model, jnp.float64)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           opt_state=adam_init(params),
                           plateau=jax_schedule.plateau_init(jcfg.lr))

    images, labels, indicators = _data(3)
    batch = tuple(torch.from_numpy(a) for a in (images, labels, indicators))
    key = jax.random.key(2)
    rng = np.random.default_rng(4)
    for step in range(STEPS):
        draws = Degree2Draws(*(
            torch.from_numpy(rng.integers(0, hi, size=BATCH).astype(np.int32))
            for hi in (RAW - SIZE + 1, RAW - SIZE + 1, 4, 2)))
        t_images, t_labels = tr.train_transform(batch[0], batch[1], draws)
        mixup_draws = _jax_mixup_draws(key, step, t_labels.numpy())
        jstate, jm = jtr._train_step(jstate, (
            jnp.asarray(t_images.numpy()),
            jnp.asarray(t_labels.numpy(), jnp.int32),
            jnp.asarray(indicators)), key)
        state, m = tr.train_step(state, batch, draws, mixup_draws=mixup_draws)
        assert set(m) == set(jm)
        for k in ("loss/Boundary", "loss/Focal", "loss/Dice", "loss/total"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-9,
                                       atol=1e-9, err_msg=f"step {step} {k}")
        # Dice is a float32 metric in both packages
        np.testing.assert_allclose(float(m["dice/mean"]), float(jm["dice/mean"]),
                                   rtol=1e-6, err_msg=f"step {step}")
        ref = state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, jstate.params), 3, FILTERS,
            num_res_units=1)
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                       atol=1e-8, err_msg=f"step {step}: {k}")
    assert state.step == int(jstate.step) == STEPS

    # an evaluation batch padded with two invalid rows: the Boundary loss
    # takes its maps from the resized labels
    ev_images, ev_labels, ev_ind = _data(5)
    row_valid = np.array([True, True, False, False])
    jmetrics, jn = jtr._eval_step(jstate.params, (
        jnp.asarray(ev_images), jnp.asarray(ev_labels, jnp.int32),
        jnp.asarray(ev_ind), jnp.asarray(row_valid)))
    metrics, n_valid = tr.eval_step(state.model, tuple(
        torch.from_numpy(a) for a in (ev_images, ev_labels, ev_ind, row_valid)))
    assert float(n_valid) == float(jn) == 2.0
    assert set(metrics) == set(jmetrics) and "loss/Boundary" in metrics
    for k in jmetrics:
        tol = 1e-6 if k.startswith("dice/") else 1e-9
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=tol, atol=1e-9, err_msg=k)


def test_a_step_draws_its_own_mixup_and_boundary_works_without_mixup():
    cfg = TrainConfig(filters=FILTERS, num_res_units=1, transform_degree=2,
                      input_size=32, batch_size=BATCH, exclude_missing=True,
                      loss_fx=("Boundary", "Dice", "Focal"), mixup=True)
    batch = tuple(torch.from_numpy(a) for a in _data(6, raw=40))
    losses = {}
    for mix in (True, False):
        tr = Trainer(TrainConfig.from_dict({**cfg.as_dict(), "mixup": mix}),
                     "cpu")
        state = tr.init_state()
        for seed in (0, 0):  # the same generator state: the same step
            state2 = tr.init_state()
            _, m = tr.train_step(state2, batch,
                                 generator=torch.Generator().manual_seed(seed))
            losses.setdefault(mix, []).append(float(m["loss/total"]))
        state, m = tr.train_step(state, batch,
                                 generator=torch.Generator().manual_seed(1))
        assert np.isfinite(float(m["loss/Boundary"])) and state.step == 1
    assert losses[True][0] == losses[True][1]
    assert losses[False][0] == losses[False][1]
    assert losses[True][0] != losses[False][0]


def test_model_m_topology_calls_each_kernel_at_its_sites(monkeypatch):
    """Per forward, Model M's layout (1 residual unit) runs 8 IN+PReLU sites
    (4 strided encoder convs, 4 transposed convs) and 4 stride-1 conv3x3
    units (the bottom's, and the 3 non-top decoder levels')."""
    calls = {"k1": 0, "k2": 0}

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(layers, "instance_norm_prelu",
                        count("k1", layers.instance_norm_prelu))
    monkeypatch.setattr(layers, "conv3x3_in_prelu",
                        count("k2", layers.conv3x3_in_prelu))
    model = SegmentationModel(3, 10, FILTERS, num_res_units=1)
    with torch.inference_mode():
        out = model(torch.zeros((2, 3, 32, 32)))
    assert out.shape == (2, 10, 32, 32)
    assert calls == {"k1": 8, "k2": 4}


# -------------------------------------------------- presets and defaults
def test_presets_equal_the_jax_package():
    assert sorted(presets.PRESETS) == sorted(jax_presets.PRESETS)
    for name, preset in presets.PRESETS.items():
        assert preset.as_dict() == jax_presets.PRESETS[name].as_dict(), name
    m = presets.MODEL_M
    assert m.mixup and m.num_res_units == 1 and "Boundary" in m.loss_fx


@pytest.mark.parametrize("fn", [
    Trainer.__init__, Trainer.restore.__func__, config.build_model,
    config.model_from_checkpoint, config.load_checkpoint,
    DevicePipeline2D.__init__, SegmentationService.__init__,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_without_a_card_the_defaults_raise():
    """Nothing carries on on the CPU when the caller did not ask for it."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = TrainConfig(filters=FILTERS, transform_degree=2, input_size=32)
    with pytest.raises((RuntimeError, AssertionError)):
        config.build_model(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        Trainer(cfg).init_state()
    images, labels, indicators = _data(7, raw=16)
    with pytest.raises((RuntimeError, AssertionError)):
        DevicePipeline2D(PackedDataset2D(images, labels, indicators), 2)


# ---------------------------------------------------------------- evaluate
def _blob_labels(rng, n, h, w):
    labels = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        for c in range(1, 10):
            if rng.random() < 0.15:
                continue
            y, x = rng.integers(1, h - 9), rng.integers(1, w - 9)
            labels[i, y:y + rng.integers(3, 9), x:x + rng.integers(3, 9)] = c
    return labels


def _eval_split(seed, n=10, h=40, w=48):
    rng = np.random.default_rng(seed)
    labels = _blob_labels(rng, n, h, w)
    images = (rng.normal(40, 60, size=(n, h, w)) + 40.0 * labels).astype(
        np.float32)
    indicators = rng.integers(0, 2, size=(n, 9)).astype(np.float32)
    indicators[:3] = 1.0
    spacings = rng.uniform(0.4, 2.5, size=(n, 2)).astype(np.float32)
    return images, labels, indicators, spacings


@pytest.mark.parametrize("with_spacing", [True, False])
def test_evaluate_2d_matches_jax(with_spacing):
    """10 slices of 40x48 resized to 32x32 (so the header spacing is scaled
    by 1.25 and 1.5), batches of 4 (a padded last batch), a float64 model
    from the JAX initialiser on both sides."""
    jcfg = JaxTrainConfig(filters=FILTERS, num_res_units=1, transform_degree=2,
                          input_size=32, batch_size=4, exclude_missing=True,
                          compute_dtype="float64")
    jtr = JaxTrainer(jcfg)
    params = jtr.init_state().params
    tr = Trainer(TrainConfig.from_dict(jcfg.as_dict()), "cpu")
    model = tr.init_state().model
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), 3, FILTERS,
        num_res_units=1))

    images, labels, indicators, spacings = _eval_split(8)
    sp = spacings if with_spacing else None
    ref = jax_evaluate_2d(
        jtr, params, JaxPackedDataset2D(images, labels, indicators,
                                        spacings=sp),
        batch_size=4, with_hd95=True)
    ours = evaluate.evaluate_2d(
        tr, model, PackedDataset2D(images, labels, indicators, spacings=sp),
        batch_size=4, with_hd95=True)
    assert ours["num_slices"] == ref["num_slices"] == 10
    assert ours["hd95_unit"] == ref["hd95_unit"] == (
        "mm" if with_spacing else "voxel")
    np.testing.assert_allclose(ours["mean_dice"], ref["mean_dice"], rtol=1e-6)
    measured = 0
    for s, v in ref["per_structure_dice"].items():
        np.testing.assert_allclose(ours["per_structure_dice"][s], v,
                                   rtol=1e-6, atol=1e-9, err_msg=s)
        h = ref["per_structure_hd95"][s]
        if h is None:
            assert ours["per_structure_hd95"][s] is None
        else:
            measured += 1
            np.testing.assert_allclose(ours["per_structure_hd95"][s], h,
                                       rtol=1e-4, err_msg=s)
    assert measured >= 5 and ours["slices_per_sec"] > 0
    assert evaluate.format_table(ours).splitlines()[0].split() == \
        evaluate.format_table(ref).splitlines()[0].split()
    plain = evaluate.evaluate_2d(
        tr, model, PackedDataset2D(images, labels, indicators), batch_size=64)
    assert "per_structure_hd95" not in plain
    assert plain["per_structure_dice"] == ours["per_structure_dice"]


def test_evaluate_2d_carries_each_slices_own_spacing():
    """A permuted split gives the same report: the spacing rows follow the
    sample indices, not the batch counter."""
    tr = Trainer(TrainConfig(filters=FILTERS, num_res_units=1,
                             transform_degree=2, input_size=32), "cpu")
    model = tr.init_state().model
    images, labels, indicators, spacings = _eval_split(9, n=6)
    order = np.array([4, 2, 5, 0, 3, 1])
    a = evaluate.evaluate_2d(
        tr, model, PackedDataset2D(images, labels, indicators,
                                   spacings=spacings),
        batch_size=4, with_hd95=True)
    b = evaluate.evaluate_2d(
        tr, model, PackedDataset2D(images[order], labels[order],
                                   indicators[order],
                                   spacings=spacings[order]),
        batch_size=4, with_hd95=True)
    for s, v in a["per_structure_hd95"].items():
        if v is None:
            assert b["per_structure_hd95"][s] is None
        else:
            np.testing.assert_allclose(b["per_structure_hd95"][s], v,
                                       rtol=1e-5)
    with pytest.raises(ValueError, match="empty"):
        evaluate.evaluate_2d(tr, model, PackedDataset2D(
            images[:0], labels[:0], indicators[:0]))


# -------------------------------------------------------------------- CLIs
def test_train_mixup_and_evaluate_clis_run_on_the_cpu(tmp_path, capsys):
    for split, seed in (("train", 10), ("valid", 11), ("test", 12)):
        images, labels, indicators, spacings = _eval_split(seed, n=6, h=40,
                                                           w=40)
        PackedDataset2D(images, labels, indicators, spacings=spacings).save(
            tmp_path / f"{split}_packed.npz")
    ck = tmp_path / "run"
    cli.main(["train_mixup", "--data_dir", str(tmp_path), "--device", "cpu",
              "--filters", *map(str, FILTERS), "--use_res_units",
              "--exclude_missing", "--loss_fx", "Boundary", "Dice", "Focal",
              "--input_size", "32", "--batch_size", "4", "--max_epochs", "2",
              "--checkpoint_dir", str(ck)])
    cfg, state = checkpoint.load(ck / "model.ckpt")
    assert state.step == 2 and cfg.mixup and cfg.num_res_units == 1
    log = (ck / "metrics.jsonl").read_text()
    assert "train/loss/Boundary" in log and "val/loss/Boundary" in log

    capsys.readouterr()
    out = tmp_path / "report.json"
    evaluate.main(["--checkpoint", str(ck / "model.ckpt"), "--data_dir",
                   str(tmp_path), "--split", "test", "--batch_size", "4",
                   "--hd95", "--device", "cpu", "--out", str(out)])
    table = capsys.readouterr().out
    assert "HD95(mm)" in table and "Mean" in table
    report = json.loads(out.read_text())
    assert report["num_slices"] == 6 and report["hd95_unit"] == "mm"
    assert set(report["per_structure_hd95"]) == set(report["per_structure_dice"])

    # a 3D checkpoint names the ROADMAP's 3D item
    cfg3d = TrainConfig(filters=FILTERS, spatial_dims=3, in_channels=1)
    torch.save({"hyper_parameters": cfg3d.as_dict(), "state_dict": {}},
               str(tmp_path / "m3d.ckpt"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        evaluate.main(["--checkpoint", str(tmp_path / "m3d.ckpt"),
                       "--device", "cpu"])
