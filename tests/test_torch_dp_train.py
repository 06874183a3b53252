"""Data-parallel training and evaluation of the port, on the CPU over gloo
(2 spawned ranks, tests/_torch_dist_workers.py), against the JAX package's
mesh Trainer and the port's single process.

  - Model L (Focal+Dice, exclude_missing) and Model M (weighted mixup,
    Boundary+Dice+Focal): 3 data-parallel steps in float64 at the global
    batch of 4 (2 rows a rank) against the JAX Trainer on make_mesh(2) (the
    conftest's virtual CPU devices) from the same weights, on the port's
    degree-2 transform of the replayed draws (the JAX step trains on it
    through an identity transform, as in tests/test_torch_train_step.py):
    loss/total within 1e-9 and every parameter within 1e-8 after every
    step, on both ranks. In Model L's batch structure 3 is annotated only on
    rank 0's rows; the loss the rank-local normalisation would give (the
    mean of the ranks' own MultiLoss) is shown to differ there by more than
    1e-3. In Model M's draws a partner index crosses ranks.
  - `evaluate_2d(mesh=)`: Dice and HD95 equal to the port's single-process
    result (the rows are gathered in sample order before the same
    reduction); against the JAX evaluate_2d on make_mesh(2), HD95 within
    1e-6 relative and Dice within 1e-6 relative (the float32 Dice of the
    two packages differ in the last ulp on one device already, 1.2e-7
    relative here).
  - A 3D patch-mode eval step on the mesh (its flips drawn for the global
    batch) equals the single-process one (1e-9, float64).
  - Window-parallel 3D: `volume_logits(mesh=)` within float32 round-off of
    the single process (rtol 1e-5, atol 1e-6: the blend is summed over the
    ranks), the labels and `evaluate_3d_sliding_window(mesh=)`'s Dice and
    HD95 equal.
  - `Trainer.fit` on the mesh (2 epochs, validation, plateau, a save every
    epoch) equals the single-process fit at the global batch in float64
    (1e-10): the pipeline's rows and the draws are the global batch's; only
    rank 0 logs and saves.
  - The entry points on 2 ranks, as torchrun starts them: the `train` CLI
    with --n_devices 2 (one checkpoint and one log, from rank 0) and
    `parity --checkpoint` (the data-parallel evaluation; rank 0 writes the
    report, equal to the single-process one).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.data.datasets import PackedDataset2D as JaxPackedDataset2D
from ctseg_tpu.inference.evaluate import evaluate_2d as jax_evaluate_2d
from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.parallel import make_mesh as jax_make_mesh
from ctseg_tpu.training import mixup as jax_mixup
from ctseg_tpu.training import schedule as jax_schedule
from ctseg_tpu.training.optimizer import adam_init
from ctseg_tpu.training.trainer import TrainConfig as JaxTrainConfig
from ctseg_tpu.training.trainer import Trainer as JaxTrainer
from ctseg_tpu.training.trainer import TrainState as JaxTrainState
from ctseg_tpu_torch.data.datasets import PackedDataset2D, PackedDataset3D
from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
from ctseg_tpu_torch.inference import evaluate
from ctseg_tpu_torch.inference.sliding_window import volume_logits
from ctseg_tpu_torch.models.jax_import import state_dict_from_jax_params
from ctseg_tpu_torch.training.config import (
    TrainConfig,
    load_checkpoint,
    save_checkpoint,
)
from ctseg_tpu_torch.training.logging import MetricLogger
from ctseg_tpu_torch.training.trainer import Trainer
from ctseg_tpu_torch.transforms.augment import Degree2Draws
from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d
from tests import _torch_dist_workers as workers
from tests.test_torch_mixup_step import _eval_split

FILTERS = (4, 8, 16, 32, 64)
RAW, SIZE, BATCH, STEPS, ALPHA = 72, 64, 4, 3, 0.2
PATCH_3D = (16, 16, 8)


def _model_l_config():
    return JaxTrainConfig(filters=FILTERS, num_res_units=2,
                          transform_degree=2, input_size=SIZE,
                          batch_size=BATCH, exclude_missing=True,
                          compute_dtype="float64")


def _model_m_config():
    return JaxTrainConfig(
        filters=FILTERS, num_res_units=1, transform_degree=2, input_size=SIZE,
        batch_size=BATCH, loss_fx=("Boundary", "Dice", "Focal"),
        exclude_missing=True, mixup=True, mixup_alpha=ALPHA,
        compute_dtype="float64")


def _train_data(seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(40, 300, size=(BATCH, RAW, RAW)).astype(np.float32)
    labels = rng.integers(0, 10, size=(BATCH, RAW, RAW)).astype(np.uint8)
    labels[1][labels[1] > 4] = 0      # a sample with few structures
    labels[3][labels[3] % 2 == 1] = 0
    indicators = np.ones((BATCH, 9), np.float32)
    indicators[2:, 3] = 0.0  # structure 3: annotated on rank 0's rows only
    indicators[3, 7] = 0.0
    return images, labels, indicators


def _draws(rng):
    return Degree2Draws(*(
        torch.from_numpy(rng.integers(0, hi, size=BATCH).astype(np.int32))
        for hi in (RAW - SIZE + 1, RAW - SIZE + 1, 4, 2)))


def _trajectory_inputs(tmp, name, jcfg, key):
    """The global batch, each step's draws and (under mixup) the JAX step's
    partner index and lambda, saved for the ranks; returns what the JAX
    side needs: the port-transformed batches and the port's weights."""
    tr = Trainer(TrainConfig.from_dict(jcfg.as_dict()), "cpu")
    model = tr.init_state().model
    images, labels, indicators = _train_data(7)
    raw = (torch.from_numpy(images), torch.from_numpy(labels))
    saved = {"images": images, "labels": labels, "indicators": indicators}
    transformed = []
    rng = np.random.default_rng(4)
    for step in range(STEPS):
        draws = _draws(rng)
        t_images, t_labels = tr.train_transform(*raw, draws)
        transformed.append((t_images.numpy(), t_labels.numpy()))
        for f, v in zip(Degree2Draws._fields, draws):
            saved[f"draws{step}_{f}"] = v.numpy()
        if jcfg.mixup:
            _, k_mixup = jax.random.split(jax.random.fold_in(key, step))
            _, index, lam = jax_mixup.weighted_mixup(
                k_mixup, jnp.zeros((BATCH, 1)), jnp.asarray(t_labels.numpy()),
                ALPHA)
            saved[f"index{step}"] = np.array(index, np.int64)
            saved[f"lam{step}"] = np.float64(lam)
    np.savez(tmp / f"{name}.npz", **saved)
    return transformed, indicators, model


def _jax_trajectory(jcfg, transformed, indicators, model, key):
    """The JAX Trainer on make_mesh(2): (loss/total, params) per step."""
    ident = lambda key, img, lab: (img, lab)  # noqa: E731
    jtr = JaxTrainer(jcfg, mesh=jax_make_mesh(2), train_transform=ident)
    params = import_monai_state_dict(model.state_dict(), 3, FILTERS,
                                     num_res_units=jcfg.num_res_units,
                                     dtype=jnp.float64)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           opt_state=adam_init(params),
                           plateau=jax_schedule.plateau_init(jcfg.lr))
    out = []
    for t_images, t_labels in transformed:
        batch = jtr.shard_batch((jnp.asarray(t_images),
                                 jnp.asarray(t_labels, jnp.int32),
                                 jnp.asarray(indicators)))
        jstate, jm = jtr._train_step(jstate, batch, key)
        out.append((float(jm["loss/total"]), state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, jstate.params), 3, FILTERS,
            num_res_units=jcfg.num_res_units)))
    return out


def _eval_3d_split(tmp):
    rng = np.random.default_rng(9)
    images, labels = [], []
    for d in (10, 12):
        lab = np.zeros((d, 20, 20), np.uint8)
        lab[2:8, 4:12, 5:15] = 1
        lab[3:9, 12:18, 2:9] = 4
        labels.append(lab)
        images.append((rng.normal(0, 80, size=(d, 20, 20))
                       + 60.0 * lab).astype(np.int16))
    ds = PackedDataset3D(images, labels, [np.ones(9, np.float32)] * 2,
                         spacings=[np.array([3.0, 1.1, 1.1], np.float32)] * 2)
    ds.save(tmp / "split3d.npz")
    cfg = TrainConfig(filters=(4, 8, 16), num_res_units=1, spatial_dims=3,
                      input_shape=PATCH_3D, in_channels=1, transform_degree=0)
    tr = make_trainer_3d(cfg, "patch", PATCH_3D, device="cpu")
    save_checkpoint(tmp / "model3d.ckpt", tr.config, tr.init_state().model)


def _eval_step_3d_config():
    return TrainConfig(filters=(4, 8, 16), num_res_units=1, spatial_dims=3,
                       input_shape=PATCH_3D, in_channels=1, batch_size=4,
                       loss_fx=("Dice", "Focal"), exclude_missing=True,
                       compute_dtype="float64")


def _eval_step_3d_setup(tmp):
    cfg = _eval_step_3d_config()
    tr = make_trainer_3d(cfg, "patch", PATCH_3D, device="cpu")
    torch.save(tr.init_state().model.state_dict(), tmp / "step3d.pt")
    rng = np.random.default_rng(21)
    np.savez(tmp / "step3d.npz",
             images=rng.normal(40, 300, size=(4,) + PATCH_3D).astype(
                 np.float32),
             labels=rng.integers(0, 10, size=(4,) + PATCH_3D).astype(
                 np.uint8),
             indicators=rng.integers(0, 2, size=(4, 9)).astype(np.float32),
             row_valid=np.array([True, True, True, False]))
    return cfg


def _fit_setup(tmp):
    cfg = TrainConfig(filters=(4, 8, 16), num_res_units=1, transform_degree=2,
                      input_size=32, batch_size=4, exclude_missing=True,
                      compute_dtype="float64", epochs=2, seed=3)
    images, labels, indicators, _ = _eval_split(11, n=8, h=40, w=40)
    PackedDataset2D(images, labels, indicators).save(tmp / "fit_split.npz")
    return cfg


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    key_l, key_m = jax.random.key(1), jax.random.key(2)
    runs = {}
    jobs = []
    for name, jcfg, key in (("model_l", _model_l_config(), key_l),
                            ("model_m", _model_m_config(), key_m)):
        runs[name] = (jcfg, key) + _trajectory_inputs(tmp, name, jcfg, key)
        jobs.append((name, "dp_train", dict(
            config=jcfg.as_dict(), inputs=f"{name}.npz", steps=STEPS)))

    # evaluation: a float64 Model L-shaped checkpoint, 10 slices, batch 4
    ecfg = TrainConfig(filters=FILTERS, num_res_units=1, transform_degree=2,
                       input_size=32, batch_size=4, exclude_missing=True,
                       compute_dtype="float64")
    save_checkpoint(tmp / "model2d.ckpt", ecfg,
                    Trainer(ecfg, "cpu").init_state().model)
    images, labels, indicators, spacings = _eval_split(8)
    PackedDataset2D(images, labels, indicators, spacings=spacings).save(
        tmp / "split2d.npz")
    jobs.append(("eval_2d", "dp_eval_2d", dict(
        model_file="model2d.ckpt", split="split2d.npz", batch_size=4)))
    _eval_3d_split(tmp)
    jobs.append(("eval_3d", "window_parallel", dict(
        model_file="model3d.ckpt", volume="split3d.npz", patch=PATCH_3D)))
    step_cfg = _eval_step_3d_setup(tmp)
    jobs.append(("eval_step_3d", "dp_eval_step_3d", dict(
        config=step_cfg.as_dict(), model_file="step3d.pt",
        inputs="step3d.npz")))
    fit_cfg = _fit_setup(tmp)
    jobs.append(("fit", "dp_fit", dict(config=fit_cfg.as_dict(),
                                       split="fit_split.npz", epochs=2)))
    data = tmp / "cli_data"
    data.mkdir()
    for split, seed in (("train", 12), ("valid", 13), ("test", 14)):
        images, labels, indicators, _ = _eval_split(seed, n=8, h=40, w=40)
        PackedDataset2D(images, labels, indicators).save(
            data / f"{split}_packed.npz")
    jobs.append(("cli_train", "entry_point", dict(
        module="ctseg_tpu_torch.training.cli", argv=[
            "train", "--device", "cpu", "--n_devices", "2", "--filters", "4",
            "8", "16", "--input_size", "32", "--batch_size", "5",
            "--max_epochs", "1", "--data_dir", "{tmp}/cli_data",
            "--checkpoint_dir", "{tmp}/cli_run", "--transform_degree", "2",
            "--exclude_missing"])))
    jobs.append(("parity", "entry_point", dict(
        module="ctseg_tpu_torch.parity_report", argv=[
            "--checkpoint", "{tmp}/model2d.ckpt", "--models", "model_l",
            "--data_dir", "{tmp}/cli_data", "--out_dir", "{tmp}/parity",
            "--device", "cpu"])))
    return {"tmp": tmp, "runs": runs, "fit_cfg": fit_cfg,
            "results": workers.run(2, tmp, jobs)}


@pytest.mark.parametrize("name", ["model_l", "model_m"])
def test_data_parallel_trajectory_matches_the_jax_mesh_trainer(dp, name):
    jcfg, key, transformed, indicators, model = dp["runs"][name]
    ranks = workers.ranks(dp["results"], name)
    ref = _jax_trajectory(jcfg, transformed, indicators, model, key)
    for step, (loss, params) in enumerate(ref):
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res[f"{step}/loss/total"], loss,
                                       rtol=1e-9, atol=1e-9,
                                       err_msg=f"rank {r} step {step}")
            for k, v in params.items():
                np.testing.assert_allclose(
                    res[f"{step}/param/{k}"], v.numpy(), rtol=0, atol=1e-8,
                    err_msg=f"rank {r} step {step}: {k}")
    if jcfg.mixup:  # some partner lives on the other rank
        index = np.load(dp["tmp"] / f"{name}.npz")
        crossing = [np.any(index[f"index{s}"][:2] >= 2)
                    or np.any(index[f"index{s}"][2:] < 2)
                    for s in range(STEPS)]
        assert any(crossing)


def test_rank_local_normalisation_would_differ(dp):
    ranks = workers.ranks(dp["results"], "model_l")
    global_loss = ranks[0]["0/loss/total"]
    assert ranks[1]["0/loss/total"] == global_loss
    local = np.mean([r["rank_local_total"] for r in ranks])
    assert abs(local - global_loss) > 1e-3, (local, global_loss)


def _result(dp, name):
    results = [json.loads(str(r["result"]))
               for r in workers.ranks(dp["results"], name)]
    for r in results[1:]:
        r.pop("slices_per_sec", None), r.pop("vols_per_min", None)
        assert {k: v for k, v in results[0].items()
                if k not in ("slices_per_sec", "vols_per_min")} == r
    return results[0]


def test_data_parallel_evaluate_2d_matches_one_process_and_jax(dp):
    ours = _result(dp, "eval_2d")
    tmp = dp["tmp"]
    tr, state = Trainer.restore(tmp / "model2d.ckpt", "cpu")
    ds = PackedDataset2D.load(tmp / "split2d.npz")
    single = evaluate.evaluate_2d(tr, state.model, ds, batch_size=4,
                                  with_hd95=True)
    assert ours["num_slices"] == single["num_slices"] == 10
    assert ours["per_structure_dice"] == single["per_structure_dice"]
    assert ours["per_structure_hd95"] == single["per_structure_hd95"]
    assert ours["hd95_unit"] == "mm"

    jcfg = JaxTrainConfig(filters=FILTERS, num_res_units=1,
                          transform_degree=2, input_size=32, batch_size=4,
                          exclude_missing=True, compute_dtype="float64")
    params = import_monai_state_dict(state.model.state_dict(), 3, FILTERS,
                                     num_res_units=1, dtype=jnp.float64)
    m2 = jax_make_mesh(2)
    ref = jax_evaluate_2d(JaxTrainer(jcfg, mesh=m2), params,
                          JaxPackedDataset2D(ds.images, ds.labels,
                                             ds.indicators,
                                             spacings=ds.spacings),
                          batch_size=4, with_hd95=True, mesh=m2)
    assert ref["num_slices"] == 10
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
                                       rtol=1e-6, err_msg=s)
    assert measured >= 5


def test_window_parallel_3d_matches_one_process(dp):
    tmp = dp["tmp"]
    ranks = workers.ranks(dp["results"], "eval_3d")
    config, model = load_checkpoint(tmp / "model3d.ckpt", "cpu")
    ds = PackedDataset3D.load(tmp / "split3d.npz")
    image = torch.from_numpy(np.asarray(ds.images[0], np.float32)).movedim(
        0, -1)
    with torch.no_grad():
        ref = volume_logits(model, image, PATCH_3D, 0.5, 3, True).numpy()
    for r in ranks:
        np.testing.assert_allclose(r["logits"], ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r["logits"].argmax(-1), ref.argmax(-1))
    ours = _result(dp, "eval_3d")
    single = evaluate.evaluate_3d_sliding_window(
        model, config, ds, PATCH_3D, 0.5, 3, with_hd95=True, device="cpu")
    assert ours["per_structure_dice"] == single["per_structure_dice"]
    assert ours["per_structure_hd95"] == single["per_structure_hd95"]


def test_data_parallel_3d_eval_step_draws_the_global_batch(dp):
    """The patch test transform's flips come from the fixed generator for
    the global batch; each rank takes its rows of them."""
    tmp = dp["tmp"]
    ranks = workers.ranks(dp["results"], "eval_step_3d")
    tr = make_trainer_3d(_eval_step_3d_config(), "patch", PATCH_3D,
                         device="cpu")
    model = tr.init_state().model
    model.load_state_dict(torch.load(tmp / "step3d.pt"))
    data = np.load(tmp / "step3d.npz")
    metrics, n_valid = tr.eval_step(model, tuple(torch.from_numpy(data[k])
                                                 for k in ("images", "labels",
                                                           "indicators",
                                                           "row_valid")))
    for r in ranks:
        assert r["n_valid"] == float(n_valid) == 3.0
        for k, v in metrics.items():
            np.testing.assert_allclose(r[k], float(v), rtol=1e-9, atol=1e-9,
                                       err_msg=k)


def test_data_parallel_fit_equals_the_single_process_fit(dp):
    tmp, cfg = dp["tmp"], dp["fit_cfg"]
    ranks = workers.ranks(dp["results"], "fit")
    tr = Trainer(cfg, "cpu")
    state = tr.init_state()
    pipe = DevicePipeline2D(PackedDataset2D.load(tmp / "fit_split.npz"), 4,
                            "cpu")
    logger = MetricLogger(log_dir=str(tmp / "single_logs"), stdout=False)
    state = tr.fit(state, pipe, pipe, epochs=2, logger=logger)
    logger.close()
    val = tr.eval_epoch(state.model, pipe)
    for r in ranks:
        assert int(r["step"]) == state.step == 4
        assert float(r["lr"]) == state.plateau.lr
        np.testing.assert_allclose(float(r["val_dice"]),
                                   val["val/dice/mean"], rtol=1e-6)
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(r[f"param/{k}"], v.numpy(), rtol=0,
                                       atol=1e-10, err_msg=k)
    # rank 0 alone logged and saved
    lines = (tmp / "dp_fit_logs" / "metrics.jsonl").read_text().splitlines()
    single = (tmp / "single_logs" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == len(single)
    _, saved = load_checkpoint(tmp / "dp_fit.ckpt", "cpu")
    for k, v in saved.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ranks[0][f"param/{k}"])


def test_train_cli_and_parity_report_on_two_ranks(dp):
    tmp = dp["tmp"]
    workers.ranks(dp["results"], "cli_train")
    workers.ranks(dp["results"], "parity")
    config, _ = load_checkpoint(tmp / "cli_run" / "model.ckpt", "cpu")
    assert config.batch_size == 5  # the config's; the pipeline's is 4
    records = [json.loads(line) for line in
               (tmp / "cli_run" / "metrics.jsonl").read_text().splitlines()]
    assert sum("train/loss/total" in r for r in records) == 1
    report = json.loads((tmp / "parity" / "parity_report.json").read_text())
    ours = report["models"]["model_l"]["result"]
    tr, state = Trainer.restore(tmp / "model2d.ckpt", "cpu")
    single = evaluate.evaluate_2d(
        tr, state.model, PackedDataset2D.load(tmp / "cli_data" /
                                              "test_packed.npz"),
        batch_size=tr.config.batch_size)
    assert ours["num_slices"] == single["num_slices"] == 8
    assert ours["per_structure_dice"] == single["per_structure_dice"]
