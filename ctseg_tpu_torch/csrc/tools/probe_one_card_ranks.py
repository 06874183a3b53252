"""What two ranks can do on one card: NCCL with both ranks on cuda:0, gloo's
point-to-point of CUDA tensors, and the data-parallel Model L step over
gloo (`chip_smoke.py` phase 33's step, timed here with cuDNN's default
algorithms; phase 33 runs them deterministic to compare losses).

    python3 ctseg_tpu_torch/csrc/tools/probe_one_card_ranks.py

Each probe runs in processes of its own (a refused collective may abort
its process); prints one line a probe and a JSON line.
"""

import datetime
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))


def _nccl_rank(rank, world, rdzv):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    dist.destroy_process_group()


def _gloo_p2p_rank(rank, world, rdzv):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    t = torch.full((4,), float(rank), device="cuda")
    buf = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, (rank + 1) % world),
           dist.P2POp(dist.irecv, buf, (rank - 1) % world)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    torch.cuda.synchronize()
    dist.destroy_process_group()


def _gloo_step_rank(rank, world, rdzv, batch_file, result, steps):
    import torch.distributed as dist
    import chip_smoke as cs
    from ctseg_tpu_torch.parallel import make_mesh
    from ctseg_tpu_torch.training.config import use_float32_convs
    from ctseg_tpu_torch.training.trainer import Trainer, take_rows
    from ctseg_tpu_torch.transforms.augment import Degree2Draws

    use_float32_convs()
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    saved = torch.load(batch_file)
    n = cs.TRAIN_BATCH // world
    rows = slice(rank * n, (rank + 1) * n)
    batch = tuple(t[rows].cuda() for t in saved["batch"])
    draws = take_rows(Degree2Draws(*(t.cuda() for t in saved["draws"])),
                      rows)
    trainer = Trainer(cs._model_l_config(), "cuda", mesh=make_mesh(world))
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state, _ = cs._step_losses(trainer, state, batch, draws, 2)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    state, losses = cs._step_losses(trainer, state, batch, draws, steps)
    torch.cuda.synchronize()
    torch.save({"ms": (time.perf_counter() - t0) / steps * 1e3,
                "losses": losses}, f"{result}.{rank}")
    dist.destroy_process_group()


def _spawn(fn, args, world=2):
    """None if every rank finished, else what ended the first that did
    not."""
    import torch.multiprocessing as mp

    try:
        mp.start_processes(fn, args=(world,) + args, nprocs=world,
                           start_method="spawn")
        return None
    except mp.ProcessExitedException as e:  # killed by a signal, or exit
        return f"{type(e).__name__}: {e}"
    except mp.ProcessRaisedException as e:
        return f"{type(e).__name__}: {str(e).strip().splitlines()[-1]}"


def main():
    import chip_smoke as cs
    from ctseg_tpu_torch.ops import _build

    label = cs.card_label()
    print(label)
    _build.library()
    out = {"card": label}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        out["nccl_two_ranks_one_card"] = _spawn(
            _nccl_rank, (str(tmp / "nccl"),)) or "ran"
        out["gloo_p2p_cuda"] = _spawn(
            _gloo_p2p_rank, (str(tmp / "p2p"),)) or "ran"
        batch, draws = cs._dp_batch()
        torch.save({"batch": [t.cpu() for t in batch],
                    "draws": [t.cpu() for t in draws]}, tmp / "batch.pt")
        del batch, draws
        torch.cuda.empty_cache()
        failed = _spawn(_gloo_step_rank, (str(tmp / "step"),
                                          str(tmp / "batch.pt"),
                                          str(tmp / "result"), cs.DP_STEPS))
        if failed:
            raise RuntimeError(f"the gloo step failed: {failed}")
        ranks = [torch.load(tmp / f"result.{r}") for r in range(2)]
        out["gloo_model_l_ms_per_step"] = [r["ms"] for r in ranks]
        out["gloo_model_l_losses"] = [r["losses"] for r in ranks]
    for k, v in out.items():
        print(f"{k}: {v}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
