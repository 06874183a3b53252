"""Depth-sharded 3D training of the port (K1f/K1b split across slabs, conv
halos, the deep levels gathered and computed replicated), on the CPU over
gloo, against the unsharded port and the JAX package's spatial mesh.

  - K1's split form, plain version: the sums of 2 and 4 slabs, the global
    statistics and each slab's y, and the backward's sums and dx, within
    1e-12 of the unsplit plain K1 in float64, forward and backward.
  - The depth-sharded UNet (channels (2, 4, 8, 16, 32), 2 residual units,
    x (2, 32, 32, 16, 1), float64) on 4 space ranks (depth 16 -> slabs of
    4, 2, then the levels of depth 4, 2 and 1 gathered): the forward and
    every parameter gradient of mean(out^2) within 1e-10 of the unsharded
    port model and of the JAX SegmentationModel on make_spatial_mesh(2, 4),
    as tests/test_spatial_training.py holds the JAX one. Its 10-channel
    and narrow levels route their convs' weight gradients to
    ops/shallow_grad.py::shallow_dw on the slabs as on the whole volume:
    every rank calls it as often as the unsharded port, for both maps.
  - One patch-mode train step on 2 data x 2 space ranks (float32,
    Focal+Dice, exclude_missing) within that file's tolerances of the JAX
    spatial Trainer (loss 1e-4 relative; parameters rtol 1e-2, atol 2.5e-3:
    Adam's first step is about lr * sign(g), and reordered sums flip the
    sign of near-zero gradients); the same step in float64 with
    CrossEntropy, GeneralizedDice and Boundary (distance maps from the
    gathered labels) within 1e-9 of the unsharded port, and its padded
    evaluation step too. Each rank's step calls the routed weight
    gradients as often as the unsharded port's step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.models import SegmentationModel as JaxSegmentationModel
from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.parallel import make_spatial_mesh as jax_make_spatial_mesh
from ctseg_tpu.training import schedule as jax_schedule
from ctseg_tpu.training.optimizer import adam_init
from ctseg_tpu.training.trainer import TrainConfig as JaxTrainConfig
from ctseg_tpu.training.trainer import Trainer as JaxTrainer
from ctseg_tpu.training.trainer import TrainState as JaxTrainState
from ctseg_tpu_torch.models.jax_import import state_dict_from_jax_params
from ctseg_tpu_torch.models.unet import SegmentationModel
from ctseg_tpu_torch.ops import instance_norm as K1
from ctseg_tpu_torch.training.config import TrainConfig
from ctseg_tpu_torch.transforms.volumetric import FlipDraws
from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d
from tests import _torch_dist_workers as workers

FILTERS = (2, 4, 8, 16, 32)
PATCH = (32, 32, 16)


# -------------------------------------------------- K1's split, plain form
@pytest.mark.parametrize("slabs", [2, 4])
def test_k1_split_plain_equals_the_unsplit_plain_k1(slabs):
    rng = np.random.default_rng(slabs)
    x = torch.from_numpy(rng.normal(0.3, 2.0, size=(2, 6, 5, 8, 7)))
    g = torch.from_numpy(rng.normal(size=x.shape))
    alpha = torch.tensor([0.25], dtype=torch.float64)
    y, mean, var = K1._fwd_plain(x, alpha)
    dx, dalpha = K1.instance_norm_prelu_bwd_plain(x, g, mean, var, alpha)

    xs, gs = x.chunk(slabs, dim=3), g.chunk(slabs, dim=3)
    count = x[0, ..., 0].numel()
    total = sum(K1.split_fwd_sums(s) for s in xs)
    smean, svar = K1.split_stats(total, count)
    np.testing.assert_allclose(smean.numpy(), mean.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(svar.numpy(), var.numpy(), rtol=0, atol=1e-12)
    ys = [K1.split_fwd_apply(s, smean, svar, alpha) for s in xs]
    np.testing.assert_allclose(torch.cat(ys, dim=3).numpy(), y.numpy(),
                               rtol=0, atol=1e-12)
    parts = [K1.split_bwd_sums(s, t, smean, svar, alpha)
             for s, t in zip(xs, gs)]
    means = sum(p[0] for p in parts) / count
    dxs = [K1.split_bwd_apply(s, t, smean, svar, alpha, means)
           for s, t in zip(xs, gs)]
    np.testing.assert_allclose(torch.cat(dxs, dim=3).numpy(), dx.numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(sum(p[1] for p in parts)),
                               float(dalpha), rtol=0, atol=1e-12)


def test_k1_split_without_a_group_is_k1():
    x = torch.randn(2, 4, 4, 3, 5, dtype=torch.float64, requires_grad=True)
    alpha = torch.tensor([0.25], dtype=torch.float64, requires_grad=True)
    ours = K1.instance_norm_prelu_split(x, alpha)
    ref = K1.instance_norm_prelu(x, alpha)
    assert torch.equal(ours, ref)


# ------------------------------------------------------------ the ranks
def _model_kwargs():
    return dict(in_channels=1, out_channels=10, channels=FILTERS,
                num_res_units=2, spatial_dims=3, dtype=torch.float64)


def _x():
    return np.random.default_rng(0).normal(size=(2, 32, 32, 16, 1))


def _step_config(dtype, losses, exclude_missing):
    return JaxTrainConfig(
        filters=FILTERS, num_res_units=2, batch_size=2, loss_fx=losses,
        exclude_missing=exclude_missing, spatial_dims=3, input_shape=PATCH,
        in_channels=1, volumetric_mode="patch", compute_dtype=dtype)


def _step_batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(40, 300, size=(2,) + PATCH).astype(np.float32)
    labels = np.zeros((2,) + PATCH, np.uint8)
    labels[:, 4:20, 6:22, 3:12] = 1 + rng.integers(0, 9, size=(2, 1, 1, 1))
    labels[:, 18:30, 2:14, 8:16] = 5
    labels[1, 10:14, 20:30, 0:5] = 9
    indicators = np.ones((2, 9), np.float32)
    indicators[1, 2] = 0.0
    flips = rng.integers(0, 2, size=(2, 2)).astype(bool)
    return dict(images=images, labels=labels, indicators=indicators,
                flip_h=flips[:, 0], flip_w=flips[:, 1])


STEPS = {
    "step32": (("float32", ("Focal", "Dice"), True), 3),
    "step64": (("float64", ("Boundary", "CrossEntropy", "GeneralizedDice"),
                False), 4),
}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial")
    model = SegmentationModel(**_model_kwargs(),
                              generator=torch.Generator().manual_seed(0))
    torch.save({"kwargs": _model_kwargs(), "state_dict": model.state_dict()},
               tmp / "model.pt")
    np.save(tmp / "x.npy", np.moveaxis(_x(), -1, 1))
    jobs = [("model", "spatial_model",
             dict(model_file="model.pt", inputs="x.npy", n_data=1))]
    for name, (args, seed) in STEPS.items():
        cfg = TrainConfig.from_dict(_step_config(*args).as_dict())
        tr = make_trainer_3d(cfg, "patch", PATCH, device="cpu")
        torch.save(tr.init_state().model.state_dict(), tmp / f"{name}.pt")
        np.savez(tmp / f"{name}.npz", **_step_batch(seed))
        jobs.append((name, "spatial_step", dict(
            config=cfg.as_dict(), model_file=f"{name}.pt",
            inputs=f"{name}.npz", n_data=2)))
    return {"tmp": tmp, "model": model,
            "results": workers.run(4, tmp, jobs)}


def test_depth_sharded_model_matches_the_unsharded_and_jax(world4):
    ranks = workers.ranks(world4["results"], "model")
    assert [int(r["space_index"]) for r in ranks] == [0, 1, 2, 3]
    out = np.concatenate([r["out"] for r in ranks], axis=-1)
    grads = {k[5:]: v for k, v in ranks[0].items() if k.startswith("grad/")}
    for r in ranks[1:]:  # the summed gradients are the same on every rank
        for k, v in grads.items():
            np.testing.assert_array_equal(r[f"grad/{k}"], v)

    model = world4["model"]
    x = torch.from_numpy(np.moveaxis(_x(), -1, 1))
    with workers.routed_calls() as routed:
        ref = model(x)
        (ref * ref).mean().backward()
    _assert_routed_as(ranks, routed)
    np.testing.assert_allclose(out, ref.detach().numpy(), rtol=0, atol=1e-10)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(grads[k], p.grad.numpy(), rtol=0,
                                   atol=1e-10, err_msg=k)

    # the JAX model on a (2 data x 4 space) mesh, as in
    # tests/test_spatial_training.py
    mesh = jax_make_spatial_mesh(2, 4)
    jmodel = JaxSegmentationModel(out_channels=10, channels=FILTERS,
                                  num_res_units=2, dtype=jnp.float64,
                                  param_dtype=jnp.float64, spatial_mesh=mesh)
    params = import_monai_state_dict(model.state_dict(), 1, FILTERS,
                                     num_res_units=2, dtype=jnp.float64)
    from jax.sharding import NamedSharding, PartitionSpec as P

    xs = jax.device_put(jnp.asarray(_x()),
                        NamedSharding(mesh, P("data", None, None, "space")))
    ps = jax.device_put(params, NamedSharding(mesh, P()))
    jout = jax.jit(jmodel.apply)(ps, xs)
    np.testing.assert_allclose(out, np.moveaxis(np.asarray(jout), -1, 1),
                               rtol=0, atol=1e-10)
    jgrads = jax.jit(jax.grad(lambda p, x: (jmodel.apply(p, x) ** 2).mean()))(
        ps, xs)
    jgrads = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jgrads), 1, FILTERS,
        num_res_units=2)
    for k, v in jgrads.items():
        np.testing.assert_allclose(grads[k], v.numpy(), rtol=0, atol=1e-10,
                                   err_msg=k)


def _assert_routed_as(ranks, routed):
    """Every rank called the routed weight gradients as often as the
    unsharded port, for both maps, at least once each."""
    assert min(routed.values()) > 0, routed
    for r in ranks:
        assert {k: int(r[f"routed/{k}"]) for k in routed} == routed


def _port_step(name, tmp):
    (args, _), = [STEPS[name]]
    cfg = TrainConfig.from_dict(_step_config(*args).as_dict())
    tr = make_trainer_3d(cfg, "patch", PATCH, device="cpu")
    state = tr.init_state()
    data = np.load(tmp / f"{name}.npz")
    batch = tuple(torch.from_numpy(data[k])
                  for k in ("images", "labels", "indicators"))
    draws = FlipDraws(torch.from_numpy(data["flip_h"]),
                      torch.from_numpy(data["flip_w"]))
    return tr, state, batch, draws


def test_depth_sharded_step_matches_the_jax_spatial_trainer(world4):
    tmp = world4["tmp"]
    ranks = workers.ranks(world4["results"], "step32")
    tr, state, batch, draws = _port_step("step32", tmp)
    images, labels = tr.train_transform(batch[0], batch[1], draws)
    with workers.routed_calls() as routed:
        tr.train_step(tr.init_state(), batch, draws)
    _assert_routed_as(ranks, routed)
    jcfg = _step_config(*STEPS["step32"][0])
    ident = lambda key, img, lab: (img, lab)  # noqa: E731
    jtr = JaxTrainer(jcfg, mesh=jax_make_spatial_mesh(2, 2),
                     train_transform=ident)
    assert jtr._spatial
    params = import_monai_state_dict(state.model.state_dict(), 1, FILTERS,
                                     num_res_units=2)
    jstate = jtr.init_state()
    jstate = JaxTrainState(step=jstate.step, params=params,
                           opt_state=adam_init(params),
                           plateau=jax_schedule.plateau_init(jcfg.lr))
    jbatch = jtr.shard_batch((jnp.asarray(images.numpy()),
                              jnp.asarray(labels.numpy(), jnp.int32),
                              jnp.asarray(batch[2].numpy())))
    jstate, jm = jtr._train_step(jstate, jbatch, jax.random.key(5))
    ref = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), 1, FILTERS,
        num_res_units=2)
    for r in ranks:
        assert r["loss/total"] == pytest.approx(float(jm["loss/total"]),
                                                rel=1e-4)
        for k, v in ref.items():
            np.testing.assert_allclose(r[f"param/{k}"], v.numpy(), rtol=1e-2,
                                       atol=2.5e-3, err_msg=k)


def test_depth_sharded_step_and_eval_match_the_unsharded_port(world4):
    tmp = world4["tmp"]
    ranks = workers.ranks(world4["results"], "step64")
    tr, state, batch, draws = _port_step("step64", tmp)
    state.model.load_state_dict(torch.load(tmp / "step64.pt"))
    with workers.routed_calls() as routed:
        state, m = tr.train_step(state, batch, draws)
    _assert_routed_as(ranks, routed)
    row_valid = torch.arange(2) < 1
    metrics, n_valid = tr.eval_step(state.model, batch + (row_valid,), draws)
    for r in ranks:
        for k, v in m.items():
            np.testing.assert_allclose(r[k], float(v), rtol=1e-9, atol=1e-9,
                                       err_msg=k)
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(r[f"param/{k}"], v.numpy(), rtol=0,
                                       atol=1e-9, err_msg=k)
        assert r["eval/n_valid"] == float(n_valid) == 1.0
        for k, v in metrics.items():
            np.testing.assert_allclose(r[f"eval/{k}"], float(v), rtol=1e-9,
                                       atol=1e-9, err_msg=k)
