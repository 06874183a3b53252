"""Time the bench_3d patch step (batch 128 x 128x128x16, full width,
float32 and bfloat16) across the cards of one host: data-parallel over
every card, and depth-sharded on ('data', 'space') meshes, one rank a card
over NCCL. Each layout's first loss is held to one process's on card 0 at
the same weights, batch and flips (1e-4 relative in float32, the tolerance
of tests/test_spatial_training.py; one bfloat16 ulp, 2^-7, in bfloat16:
each rank's convs round another batch), and each rank counts its launches of K1,
K1b, K1's split form and the shallow weight gradients (`shallow`:
csrc/shallow_dw.cu, `shallow_t`: csrc/shallow_dwt.cu) a step.

    python3 ctseg_tpu_torch/csrc/tools/time_depth_sharded.py [--steps 3]
        [--dtypes float32 bfloat16] [--layouts "data 2 x space 2" ...]
        [--profile]

Needs 4 cards of one host; prints one line a layout and a JSON
line of all of them. --profile: each rank of a layout also prints one
step's device time by group of kernels (chip_smoke.py::profile_step,
torch.profiler) after its timed steps. A copy of it in a `git archive` of
an earlier commit (unpacked under ctseg_tpu_torch/_build/) times that
commit's tree.
"""

import argparse
import datetime
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

BATCH, PATCH = 128, (128, 128, 16)
FILTERS = (64, 128, 256, 512, 1024)
LAYOUTS = {"data 4": (4, 1), "data 2 x space 2": (2, 2),
           "data 1 x space 4": (1, 4)}


def _config(dtype):
    from ctseg_tpu_torch.training.config import TrainConfig

    return TrainConfig(filters=FILTERS, num_res_units=2, transform_degree=0,
                       batch_size=BATCH, loss_fx=("CrossEntropy", "Dice"),
                       spatial_dims=3, input_shape=PATCH, in_channels=1,
                       epochs=1, compute_dtype=dtype, volumetric_mode="patch")


def _batch():
    rng = np.random.default_rng(0)
    images = rng.normal(40, 300, size=(BATCH,) + PATCH).astype(np.float32)
    labels = rng.integers(0, 10, size=(BATCH,) + PATCH).astype(np.uint8)
    flips = rng.integers(0, 2, size=(2, BATCH)).astype(bool)
    return ([torch.from_numpy(images), torch.from_numpy(labels),
             torch.ones(BATCH, 9)], [torch.from_numpy(f) for f in flips])


def _counters():
    from ctseg_tpu_torch.ops import instance_norm as k1
    from ctseg_tpu_torch.ops import shallow_grad

    return {"k1": k1.instance_norm_prelu, "k1b": k1.instance_norm_prelu_bwd,
            "split_fwd_sums": k1.split_fwd_sums,
            "split_fwd_apply": k1.split_fwd_apply,
            "split_bwd_sums": k1.split_bwd_sums,
            "split_bwd_apply": k1.split_bwd_apply,
            "shallow": shallow_grad.shallow_dw,
            "shallow_t": shallow_grad.shallow_dwt}


def _steps(trainer, state, batch, draws, steps):
    """(first loss, ms/step over `steps` after 2 warm-ups, launches a step,
    peak GiB)."""
    first = None
    for _ in range(2):
        state, m = trainer.train_step(state, batch, draws)
        first = float(m["loss/total"]) if first is None else first
    torch.cuda.synchronize()
    for fn in _counters().values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = trainer.train_step(state, batch, draws)
    float(m["loss/total"])
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {k: fn.launches // steps for k, fn in _counters().items()}
    return first, step_ms, launches, torch.cuda.max_memory_allocated() / 2**30


def _rank(rank, world, rdzv, dtype, layout, steps, out, profile):
    import torch.distributed as dist
    from ctseg_tpu_torch.parallel.mesh import make_spatial_mesh
    from ctseg_tpu_torch.training.config import use_float32_convs
    from ctseg_tpu_torch.training.trainer import take_rows
    from ctseg_tpu_torch.transforms.volumetric import FlipDraws
    from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d

    use_float32_convs()
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    n_data, n_space = LAYOUTS[layout]
    mesh = make_spatial_mesh(n_data, n_space)
    trainer = make_trainer_3d(_config(dtype), "patch", PATCH, "cuda",
                              mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch, flips = _batch()
    batch = trainer.shard_batch(tuple(t.cuda() for t in batch))
    k = BATCH // n_data
    draws = take_rows(FlipDraws(*(f.cuda() for f in flips)),
                      slice(mesh.data_index * k, (mesh.data_index + 1) * k))
    result = _steps(trainer, state, batch, draws, steps)
    torch.save(result, f"{out}.{rank}")
    if profile:  # every rank (the collectives need them all)
        import chip_smoke

        chip_smoke.profile_step(
            f"rank {rank}", f"{layout} {dtype}",
            lambda: trainer.train_step(state, batch, draws), steps=1)
    dist.destroy_process_group()


def main():
    import torch.multiprocessing as mp
    from ctseg_tpu_torch.ops import _build
    from ctseg_tpu_torch.training.config import use_float32_convs
    from ctseg_tpu_torch.transforms.volumetric import FlipDraws
    from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", default="chiprun_out/depth_sharded")
    parser.add_argument("--dtypes", nargs="+", default=["float32",
                                                        "bfloat16"])
    parser.add_argument("--layouts", nargs="+", default=list(LAYOUTS),
                        choices=list(LAYOUTS))
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()
    world = torch.cuda.device_count()
    if world < 4:
        raise SystemExit(f"needs 4 cards, found {world}")
    use_float32_convs()
    _build.library()
    label = os.popen("nvidia-smi --query-gpu=name,power.limit "
                     "--format=csv,noheader").read().strip().splitlines()
    print(label)
    out_dir = Path(args.out).resolve()  # file:// wants an absolute path
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {}
    for dtype in args.dtypes:
        trainer = make_trainer_3d(_config(dtype), "patch", PATCH, "cuda")
        state = trainer.init_state(torch.Generator().manual_seed(0))
        batch, flips = _batch()
        first, ms, launches, peak = _steps(
            trainer, state, tuple(t.cuda() for t in batch),
            FlipDraws(*(f.cuda() for f in flips)), args.steps)
        del trainer, state
        torch.cuda.empty_cache()
        print(f"one card, {dtype}: {ms:.3f} ms/step, peak {peak:.3f} GiB, "
              f"first loss {first!r}, launches a step {launches}",
              flush=True)
        report[f"one card {dtype}"] = {"ms": ms, "peak_gib": peak,
                                       "launches": launches}
        for layout in args.layouts:
            out = out_dir / f"{dtype}_{layout.replace(' ', '_')}"
            rdzv = out_dir / f"rdzv_{out.name}"
            rdzv.unlink(missing_ok=True)
            mp.start_processes(_rank, args=(world, str(rdzv), dtype, layout,
                                            args.steps, str(out),
                                            args.profile),
                               nprocs=world, start_method="spawn")
            ranks = [torch.load(f"{out}.{r}") for r in range(world)]
            loss = ranks[0][0]
            rtol = 1e-4 if dtype == "float32" else 2.0 ** -7
            if not abs(loss - first) <= rtol * abs(first):
                raise AssertionError(f"{layout} {dtype}: loss {loss!r} vs "
                                     f"{first!r} on one card")
            ms_ranks = [r[1] for r in ranks]
            print(f"{layout}, {dtype}: {max(ms_ranks):.3f} ms/step (ranks "
                  f"{[round(m, 3) for m in ms_ranks]}), peak "
                  f"{max(r[3] for r in ranks):.3f} GiB a rank, first loss "
                  f"{loss!r}, rank 0's launches a step {ranks[0][2]}",
                  flush=True)
            report[f"{layout} {dtype}"] = {
                "ms": max(ms_ranks), "ms_ranks": ms_ranks,
                "peak_gib": max(r[3] for r in ranks),
                "launches": ranks[0][2]}
    print(json.dumps({"card": label, "depth_sharded": report}))


if __name__ == "__main__":
    main()
