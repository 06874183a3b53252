"""Data-parallel training cells: the train loop on a data mesh of
`traffic["ranks"]` ranks, one process a card, all started by the one
command (rank 0 is the command's own process; the others are spawned and
waited for). NCCL on cards, gloo on CPUs.

Every rank makes the same inputs and weights from the seed and feeds its
rows of the global batch; the program sums the gradients
(`parallel/distributed.py::sum_gradients`) and reduces the losses over the
global batch. A gloo broadcast from rank 0 before every step keeps the
ranks' windows to the same steps. After the window rank 0 holds the
global batch's trajectory, and the plain reference follows it on the
global batch in one process: the update every rank applies must be the
single-process update.
"""

import contextlib
import socket
from typing import Dict, List

import torch
import torch.distributed as dist

from benchmark import devtrace, faults, harness
from benchmark.loops import train

WAIT = 900  # seconds a rank's report may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _device(kind: str, rank: int) -> torch.device:
    return torch.device("cuda", rank) if kind == "cuda" \
        else torch.device("cpu")


def _start(rank: int, world: int, port: int, device):
    from ctseg_tpu_torch.parallel.distributed import initialize
    from ctseg_tpu_torch.parallel.mesh import make_mesh

    initialize(init_method=f"tcp://localhost:{port}", rank=rank,
               world_size=world, device=device)
    return make_mesh(world), dist.new_group(backend="gloo")


def _window(cell, seed, seconds, trace, device, kinds, mesh, flags):
    setup = train.first_steps(cell, seed, device, kinds, mesh)

    def go(elapsed):
        flag = torch.tensor([int(elapsed < seconds)], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=flags)
        return bool(flag.item())

    prof = harness.start_profiler() if trace else None
    t0, t1, steps = train.window(setup, device, seconds, prof, go)
    busy = None
    if prof is not None:
        busy = devtrace.busy_seconds(devtrace.collect(
            prof, harness.WINDOW_SPAN, "bench."))
    return setup, (t0, t1, steps, harness.memory_peak(device), prof, busy)


def _child(rank, world, port, job, active, queue):
    """A rank other than 0: `job` is ("window", cell, seed, seconds,
    trace) or ("readings", cell, [(seed, fault or None), ...])."""
    device = _device(job[-1], rank)
    with contextlib.ExitStack() as stack:
        for name in active:
            stack.enter_context(faults.FAULTS[name]())
        mesh, flags = _start(rank, world, port, device)
        try:
            if job[0] == "window":
                _, cell, seed, seconds, trace, _ = job
                _, (_, _, _, memory, _, busy) = _window(
                    cell, seed, seconds, trace, device,
                    harness.kernel_kinds(), mesh, flags)
                queue.put((rank, memory, busy))
            else:
                for seed, fault in job[2]:
                    with (faults.FAULTS[fault]() if fault
                          else contextlib.nullcontext()):
                        setup = train.first_steps(job[1], seed, device,
                                                  mesh=mesh)
                    train.release(setup, device)
                    dist.barrier(group=flags)
                queue.put((rank, 0, None))
        finally:
            dist.destroy_process_group()


class Ranks:
    """Spawns ranks 1.. for `job`, starts rank 0 here, and stops them."""

    def __init__(self, world: int, job, device):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_child, args=(
            r, world, port, job, faults.active(), self.queue))
            for r in range(1, world)]
        for p in self.procs:
            p.start()
        self.device = _device(device.type, 0)
        self.mesh, self.flags = _start(0, world, port, self.device)

    def reports(self) -> List:
        """The other ranks' reports (drained before they are joined)."""
        return [self.queue.get(timeout=WAIT) for _ in self.procs]

    def stop(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in self.procs:
            p.join(timeout=WAIT)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join()


def run(cell, seed: int, seconds: float, trace: bool, device,
        kinds: Dict):
    ranks = Ranks(cell.traffic["ranks"],
                  ("window", cell, seed, seconds, trace, device.type),
                  device)
    try:
        setup, (t0, t1, steps, memory, prof, busy) = _window(
            cell, seed, seconds, trace, ranks.device, kinds, ranks.mesh,
            ranks.flags)
        others = ranks.reports()
    finally:
        ranks.stop()
    train.release(setup, ranks.device)
    with harness.timed("reference"):
        checks = train.gaps(setup.trajectory,
                            train.reference(setup, cell, ranks.device))
    out = train.outcome(cell, setup, t0, t1, steps,
                        max([memory] + [o[1] for o in others]), prof, checks)
    if trace:
        out.busy_ranks = [busy] + [o[2] for o in others]
    return out


def readings(cell, plan, device, control_seeds=()):
    """[(seed, fault or None), ...] on the mesh: each entry's first steps
    against the reference on the global batch (and, for the control
    seeds, the control's); one dict an entry."""
    ranks = Ranks(cell.traffic["ranks"], ("readings", cell, list(plan),
                                          device.type), device)
    out = []
    try:
        for seed, fault in plan:
            with (faults.FAULTS[fault]() if fault
                  else contextlib.nullcontext()):
                setup = train.first_steps(cell, seed, ranks.device,
                                          mesh=ranks.mesh)
            train.release(setup, ranks.device)
            dist.barrier(group=ranks.flags)
            want = train.reference(setup, cell, ranks.device)
            row = {"seed": seed, fault or "program": train.gaps(
                setup.trajectory, want, True)}
            if seed in control_seeds and fault is None:
                row["control"] = train.gaps(train.reference(
                    setup, cell, ranks.device, tf32=True), want, True)
            out.append(row)
        ranks.reports()
    finally:
        ranks.stop()
    return out
