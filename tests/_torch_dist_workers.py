"""Multi-rank runs of the port for the scale-out tests, on the CPU over gloo.

`run(world, tmp_path, jobs)` starts `world` processes with
torch.multiprocessing (spawn), each one rank of a gloo process group
(file:// rendezvous in tmp_path, so parallel test workers never share a
port), and each runs every job in turn: a job is (tag, name, kwargs),
naming a function of this module, called as fn(rank, world, tmp_path,
**kwargs), whose dict of arrays is saved to tmp_path/<tag>_rank<r>.npz. A
job that raises writes its traceback to <tag>_rank<r>.err instead, and the
next job still runs; a job that leaves a rank waiting ends at the group's
timeout.

This module imports torch and the port only, never jax: the spawned ranks
import it. The pytest process compares their files with the JAX package.
"""

import contextlib
import datetime
import json
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = 240  # seconds a collective waits for a rank that failed


def _rank_main(rank, world, tmp, jobs):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        for tag, name, kwargs in jobs:
            out = Path(tmp) / f"{tag}_rank{rank}"
            try:
                arrays = globals()[name](rank, world, Path(tmp), **kwargs)
                np.savez(str(out) + ".npz", **{
                    k: np.asarray(v) for k, v in arrays.items()})
            except Exception:
                Path(str(out) + ".err").write_text(traceback.format_exc())
    finally:
        dist.destroy_process_group()


def run(world, tmp_path, jobs, timeout=600):
    """Run `jobs` on `world` ranks; returns {tag: [each rank's arrays]},
    or {tag: the tracebacks} for a job that failed on some rank."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path)
    ctx = mp.start_processes(_rank_main, args=(world, tmp, jobs),
                             nprocs=world, join=False, start_method="spawn")
    try:
        ctx.join(timeout=timeout)
    except mp.ProcessExitedException as e:  # reported per job below
        print(f"a rank died: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = {}
    for name, _, _ in jobs:
        files = [Path(tmp) / f"{name}_rank{r}" for r in range(world)]
        errors = [f.with_suffix(".err").read_text() for f in files
                  if f.with_suffix(".err").exists()]
        missing = [str(f) for f in files if not f.with_suffix(".npz").exists()]
        if errors or missing:
            out[name] = "\n".join(errors) or f"no result: {missing}"
        else:
            out[name] = [dict(np.load(f.with_suffix(".npz"))) for f in files]
    return out


def ranks(results, name):
    """The job's per-rank arrays; raises with its tracebacks if it failed."""
    res = results[name]
    if isinstance(res, str):
        raise AssertionError(f"{name} failed:\n{res}")
    return res


# ------------------------------------------------------------------- jobs
def _state(model):
    return {f"param/{k}": v.detach().clone().numpy()
            for k, v in model.state_dict().items()}


def collectives(rank, world, tmp):
    """all_sum, all_gather_grad and the depth halo with their gradients, on
    a per-rank tensor made from the rank."""
    from ctseg_tpu_torch.parallel.collectives import (
        DepthShard,
        all_gather_grad,
        all_sum_grad,
    )
    from ctseg_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world)
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(2, 3, 4, 5, 6, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(2, 3, 4, 5, 8, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(10 + rank))
    shard = DepthShard(mesh.world, range(world))
    ext = shard.halo(x, 1, 1)
    (ext * w).sum().backward()
    halo_grad = x.grad.clone()
    x.grad = None
    gathered = all_gather_grad(x, mesh.world, 4)
    weight = torch.arange(gathered.numel(), dtype=torch.float64).reshape(
        gathered.shape)
    (gathered * weight).sum().backward()
    gather_grad = x.grad.clone()
    y = torch.ones(3, dtype=torch.float64, requires_grad=True)
    total = all_sum_grad(y * (rank + 1), mesh.world)
    (total * total).sum().backward()
    from ctseg_tpu_torch.parallel.distributed import (
        global_mesh,
        host_local_batch_to_global,
    )

    rows = (torch.zeros(3, 2), torch.ones(3))
    same, n_global = host_local_batch_to_global(rows, global_mesh())
    return {"x": x.detach(), "w": w, "ext": ext.detach(),
            "halo_grad": halo_grad, "gathered": gathered.detach(),
            "gather_grad": gather_grad, "sum": total.detach(),
            "sum_grad": y.grad, "global_rows": n_global,
            "rows_kept": same is rows}


def spatial_inference(rank, world, tmp, volume, patch, out_channels=None,
                      model_file=None, overlap=0.5, batch_size=4):
    """sliding_window_inference_spatial over every rank: the identity, or
    the 3D model saved in `model_file` (a state_dict and its build
    arguments)."""
    from ctseg_tpu_torch.inference.sliding_window import model_apply_fn
    from ctseg_tpu_torch.inference.spatial_sharded import (
        sliding_window_inference_spatial,
    )
    from ctseg_tpu_torch.models.unet import SegmentationModel
    from ctseg_tpu_torch.parallel.mesh import make_mesh

    vol = torch.from_numpy(np.load(tmp / volume))
    if model_file is None:
        apply = lambda p: p  # noqa: E731
    else:
        saved = torch.load(tmp / model_file)
        model = SegmentationModel(**saved["kwargs"])
        model.load_state_dict(saved["state_dict"])
        apply = model_apply_fn(model.eval())
    with torch.no_grad():
        out = sliding_window_inference_spatial(
            vol, apply, patch, make_mesh(world), overlap=overlap,
            batch_size=batch_size, out_channels=out_channels)
    return {"out": out}


def window_parallel(rank, world, tmp, model_file, volume, patch):
    """build_sliding_window_fn on a mesh (each rank its share of every
    window batch) and the 3D evaluation that uses it."""
    from ctseg_tpu_torch.data.datasets import PackedDataset3D
    from ctseg_tpu_torch.inference.evaluate import evaluate_3d_sliding_window
    from ctseg_tpu_torch.inference.sliding_window import volume_logits
    from ctseg_tpu_torch.parallel.mesh import make_mesh
    from ctseg_tpu_torch.training.config import load_checkpoint

    mesh = make_mesh(world)
    config, model = load_checkpoint(tmp / model_file, "cpu")
    ds = PackedDataset3D.load(tmp / volume)
    image = torch.from_numpy(np.asarray(ds.images[0], np.float32)).movedim(
        0, -1)
    logits = volume_logits(model, image, patch, 0.5, 3, True, mesh)
    result = evaluate_3d_sliding_window(model, config, ds, patch, 0.5, 3,
                                        with_hd95=True, device="cpu",
                                        mesh=mesh)
    return {"logits": logits, "result": json.dumps(result)}


def window_inference(rank, world, tmp, volume, patch, weights,
                     batch_size):
    """sliding_window_inference(mesh=) of a channel mix (tanh(p @ w)),
    every rank given the same volume, and the same call without a mesh."""
    from ctseg_tpu_torch.inference.sliding_window import (
        sliding_window_inference,
    )
    from ctseg_tpu_torch.parallel.mesh import make_mesh

    vol = torch.from_numpy(np.load(tmp / volume))
    w = torch.from_numpy(np.load(tmp / weights))
    fn = lambda p: torch.tanh(p @ w)  # noqa: E731
    on_mesh = sliding_window_inference(vol, fn, patch, batch_size=batch_size,
                                       mesh=make_mesh(world))
    alone = sliding_window_inference(vol, fn, patch, batch_size=batch_size)
    return {"mesh": on_mesh, "alone": alone}


def dp_train(rank, world, tmp, config, inputs, steps):
    """`steps` data-parallel train steps of a Trainer on make_mesh(world):
    each rank's rows of the global batch and of its draws (the transform's
    and, under mixup, the global index and lambda, as given). Records the
    global metrics, the parameters after each step, and the step-0 loss
    the rank-local normalisation would give."""
    from ctseg_tpu_torch.losses.segmentation import MultiLoss
    from ctseg_tpu_torch.parallel.mesh import make_mesh
    from ctseg_tpu_torch.training.config import TrainConfig
    from ctseg_tpu_torch.training.trainer import Trainer, take_rows
    from ctseg_tpu_torch.transforms.augment import Degree2Draws

    cfg = TrainConfig.from_dict(config)
    mesh = make_mesh(world)
    tr = Trainer(cfg, "cpu", mesh=mesh)
    state = tr.init_state()
    data = np.load(tmp / inputs)
    n = data["images"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    batch = tuple(torch.from_numpy(data[k][rows])
                  for k in ("images", "labels", "indicators"))
    out = {}
    for step in range(steps):
        draws = take_rows(Degree2Draws(*(
            torch.from_numpy(data[f"draws{step}_{f}"])
            for f in Degree2Draws._fields)), rows)
        mixup_draws = None
        if cfg.mixup:
            mixup_draws = (torch.from_numpy(data[f"index{step}"]),
                           torch.tensor(float(data[f"lam{step}"]),
                                        dtype=torch.float64))
        if step == 0 and not cfg.mixup:
            # The loss this rank would report if it normalised over its own
            # rows only (the single-process MultiLoss on half a batch).
            images, labels = tr.train_transform(batch[0], batch[1], draws)
            local = MultiLoss(list(cfg.loss_fx), cfg.exclude_missing)
            with torch.no_grad():
                logits = tr._logits(state.model, images)
                values = local(logits, labels, batch[2])
            out["rank_local_total"] = float(local.total(values))
        state, m = tr.train_step(state, batch, draws,
                                 mixup_draws=mixup_draws)
        for k, v in m.items():
            out[f"{step}/{k}"] = float(v)
        out.update({f"{step}/{k}": v for k, v in _state(state.model).items()})
    return out


def dp_eval_2d(rank, world, tmp, model_file, split, batch_size):
    """evaluate_2d of the checkpoint over make_mesh(world)."""
    from ctseg_tpu_torch.data.datasets import PackedDataset2D
    from ctseg_tpu_torch.inference.evaluate import evaluate_2d
    from ctseg_tpu_torch.parallel.mesh import make_mesh
    from ctseg_tpu_torch.training.trainer import Trainer

    mesh = make_mesh(world)
    tr, state = Trainer.restore(tmp / model_file, "cpu", mesh=mesh)
    result = evaluate_2d(tr, state.model, PackedDataset2D.load(tmp / split),
                         batch_size=batch_size, with_hd95=True, mesh=mesh)
    return {"result": json.dumps(result)}


def dp_fit(rank, world, tmp, config, split, epochs):
    """Trainer.fit on make_mesh(world) with a validation split, the plateau
    and a checkpoint every epoch (saved by rank 0 only)."""
    from ctseg_tpu_torch.data.datasets import PackedDataset2D
    from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
    from ctseg_tpu_torch.parallel.mesh import make_mesh
    from ctseg_tpu_torch.training.config import TrainConfig
    from ctseg_tpu_torch.training.logging import MetricLogger
    from ctseg_tpu_torch.training.trainer import Trainer

    cfg = TrainConfig.from_dict(config)
    tr = Trainer(cfg, "cpu", mesh=make_mesh(world))
    state = tr.init_state()
    ds = PackedDataset2D.load(tmp / split)
    pipe = DevicePipeline2D(ds, cfg.batch_size, "cpu")
    logger = MetricLogger(log_dir=str(tmp / "dp_fit_logs"))
    state = tr.fit(state, pipe, pipe, epochs=epochs, logger=logger,
                   checkpoint_path=tmp / "dp_fit.ckpt", checkpoint_every=1)
    logger.close()
    val = tr.eval_epoch(state.model, pipe)
    return {"lr": state.plateau.lr, "step": state.step,
            "val_dice": val["val/dice/mean"], **_state(state.model)}


@contextlib.contextmanager
def routed_calls():
    """Counts, while the block runs, the calls of ops/shallow_grad.py::
    shallow_dw, the weight gradient of every routed conv (on the CPU its
    plain version), by map: {"stride1": n, "transposed": n}."""
    from ctseg_tpu_torch.ops import shallow_grad as sg

    counts = {"stride1": 0, "transposed": 0}
    real = sg.shallow_dw

    def counted(x, dy, transposed, *args):
        counts["transposed" if transposed else "stride1"] += 1
        return real(x, dy, transposed, *args)

    sg.shallow_dw = counted
    try:
        yield counts
    finally:
        sg.shallow_dw = real


def spatial_model(rank, world, tmp, model_file, inputs, n_data):
    """The depth-sharded UNet on an (n_data x world/n_data) mesh: forward
    of each rank's rows and slab, the parameter gradients of
    sum(out^2) / numel summed over the ranks, and this rank's routed
    weight-gradient calls (`routed_calls`)."""
    from ctseg_tpu_torch.models.unet import SegmentationModel
    from ctseg_tpu_torch.parallel.distributed import sum_gradients
    from ctseg_tpu_torch.parallel.mesh import (
        batch_sharding,
        depth_slab,
        make_spatial_mesh,
    )

    mesh = make_spatial_mesh(n_data, world // n_data)
    saved = torch.load(tmp / model_file)
    model = SegmentationModel(**saved["kwargs"])
    model.load_state_dict(saved["state_dict"])
    model.unet.spatial_mesh = mesh
    x = torch.from_numpy(np.load(tmp / inputs))
    xs = depth_slab(mesh, batch_sharding(mesh, x))
    with routed_calls() as routed:
        out = model(xs)
        loss = (out * out).sum() / (x.shape[0] * out.shape[1]
                                    * x[0, 0].numel())
        loss.backward()
    sum_gradients(model.parameters(), mesh.world)
    return {"out": out.detach(), "data_index": mesh.data_index,
            "space_index": mesh.space_index,
            **{f"routed/{k}": v for k, v in routed.items()},
            **{f"grad/{k}": p.grad for k, p in model.named_parameters()}}


def spatial_step(rank, world, tmp, config, model_file, inputs, n_data):
    """One patch-mode train step of make_trainer_3d on an (n_data x
    world/n_data) mesh from the given weights, flips and batch, with this
    rank's routed weight-gradient calls in it (`routed_calls`)."""
    from ctseg_tpu_torch.parallel.mesh import make_spatial_mesh
    from ctseg_tpu_torch.training.config import TrainConfig
    from ctseg_tpu_torch.training.trainer import take_rows
    from ctseg_tpu_torch.transforms.volumetric import FlipDraws
    from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d

    cfg = TrainConfig.from_dict(config)
    mesh = make_spatial_mesh(n_data, world // n_data)
    tr = make_trainer_3d(cfg, "patch", tuple(cfg.input_shape), device="cpu",
                         mesh=mesh)
    state = tr.init_state()
    state.model.load_state_dict(torch.load(tmp / model_file))
    data = np.load(tmp / inputs)
    batch = tr.shard_batch(tuple(torch.from_numpy(data[k]) for k in (
        "images", "labels", "indicators")))
    n = data["images"].shape[0] // n_data
    rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    draws = take_rows(FlipDraws(torch.from_numpy(data["flip_h"]),
                                torch.from_numpy(data["flip_w"])), rows)
    with routed_calls() as routed:
        state, m = tr.train_step(state, batch, draws)
    out = {**{k: float(v) for k, v in m.items()}, **_state(state.model),
           **{f"routed/{k}": v for k, v in routed.items()}}
    row_valid = torch.arange(data["images"].shape[0]) < 1  # one padded row
    metrics, n_valid = tr.eval_step(state.model, batch + (
        row_valid[rows],), draws)
    out.update({f"eval/{k}": float(v) for k, v in metrics.items()})
    out["eval/n_valid"] = float(n_valid)
    return out


def entry_point(rank, world, tmp, module, argv):
    """`module.main(argv)` on every rank of the running world, as torchrun
    would start it (the entry point finds the process group up)."""
    import importlib

    importlib.import_module(module).main([a.replace("{tmp}", str(tmp))
                                          for a in argv])
    return {}


def dp_eval_step_3d(rank, world, tmp, config, model_file, inputs):
    """A 3D patch-mode eval step over make_mesh(world), its draws (the
    fixed generator's) the global batch's: this rank's rows of a batch
    with a padded row."""
    from ctseg_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from ctseg_tpu_torch.training.config import TrainConfig
    from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d

    cfg = TrainConfig.from_dict(config)
    mesh = make_mesh(world)
    tr = make_trainer_3d(cfg, "patch", tuple(cfg.input_shape), device="cpu",
                         mesh=mesh)
    model = tr.init_state().model
    model.load_state_dict(torch.load(tmp / model_file))
    data = np.load(tmp / inputs)
    batch = batch_sharding(mesh, tuple(torch.from_numpy(data[k]) for k in (
        "images", "labels", "indicators", "row_valid")))
    metrics, n_valid = tr.eval_step(model, batch)
    return {**{k: float(v) for k, v in metrics.items()},
            "n_valid": float(n_valid)}
