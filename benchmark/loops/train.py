"""The training loop: a closed loop of the port's train step, fed from the
seed, its first steps checked against the plain reference.

Set-up builds one trainer and its state (weights from the seed, made on the
card in one draw, benchmark/reference/unet.py::make_weights) and drives it
through its first `reference_steps` steps with the window's own call and
feed, on rows that all differ. Those steps warm every shape the window
uses, and what they leave is kept: each step's loss, the norm of the first
gradient as Adam holds it after one step (exp_avg / (1 - beta1)) and the
parameters' change over the steps, per leaf, read before the next step
moves them. The window then runs the same object on.

2D (`slices`): a pool of `pool_batches` distinct batches of raw HU slices
with labels and indicators, made on the card from the seed, taken in
epoch order; the degree-2 draws (crop, rot90, flip) drawn from the seed
every step. 3D (`patches`): `volumes` volumes of `depths`, made on the
card from the seed and handed to volumetric/pipeline3d.py::
PatchPipeline3D; every step gathers a fresh batch of patches at draws from
the seed, with H and W flips from the seed.

After the window the program's state is freed, and the reference runs the
same steps on the same inputs from the same weights
(benchmark/reference/train.py).
"""

import statistics
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import train as ref
from benchmark.reference.unet import make_weights

# The leaves whose reference gradient is nought to rounding (a conv's bias
# under instance norm) move under Adam by round-off alone: they are left
# out of the change by this share of the median leaf's gradient norm.
STILL_SHARE = 1e-3


def train_config(config: Dict):
    """The program's TrainConfig of a benchmark configuration."""
    from ctseg_tpu_torch.training.config import TrainConfig

    kw = dict(filters=tuple(config["filters"]),
              num_res_units=config["num_res_units"], lr=config["lr"],
              batch_size=config["batch"], loss_fx=tuple(config["loss"]),
              exclude_missing=config["exclude_missing"], epochs=1,
              compute_dtype=config["dtype"])
    if config["spatial_dims"] == 2:
        return TrainConfig(transform_degree=config["transform_degree"],
                           input_size=config["input_shape"][0], **kw)
    return TrainConfig(transform_degree=0, spatial_dims=3,
                       input_shape=tuple(config["input_shape"]),
                       in_channels=config["in_channels"],
                       volumetric_mode=config["volumetric_mode"], **kw)


def rows_of(draws, shard):
    """This rank's rows of every tensor of a NamedTuple of per-sample
    draws (all of them without a mesh)."""
    index, parts = shard
    k = draws[0].shape[0] // parts
    return type(draws)(*(t[index * k:(index + 1) * k] for t in draws))


class Feed2D:
    """Raw-HU slice batches in epoch order through a pool made on the
    card, with degree-2 draws from the seed."""

    def __init__(self, config, traffic, gen, device, shard=(0, 1)):
        t = traffic["slices"]
        self.shard = shard
        self.b, (h, w) = config["batch"], config["raw_shape"]
        self.size = config["input_shape"][0]
        self.pool = t["pool_batches"]
        n = self.pool * self.b
        self.gen, self.device = gen, device
        self.images = torch.randn((n, h, w), generator=gen, device=device) \
            * traffic["hu_std"] + traffic["hu_mean"]
        self.labels = torch.randint(0, traffic["classes"], (n, h, w),
                                    generator=gen, device=device,
                                    dtype=torch.uint8)
        self.indicators = (torch.rand((n, traffic["classes"] - 1),
                                      generator=gen, device=device)
                           < t["indicator_p"]).to(torch.float32)
        self.block = t["reference_block"]
        self.step = 0

    def next(self):
        """(the step's batch, its draws, what the reference needs)."""
        from ctseg_tpu_torch.transforms.augment import Degree2Draws

        rows = slice((self.step % self.pool) * self.b,
                     (self.step % self.pool + 1) * self.b)
        self.step += 1
        kw = {"generator": self.gen, "device": self.device}
        h, w = self.images.shape[1:]
        i32 = torch.int32
        top = torch.randint(0, h - self.size + 1, (self.b,), dtype=i32, **kw)
        left = torch.randint(0, w - self.size + 1, (self.b,), dtype=i32, **kw)
        rotate = torch.rand((self.b,), **kw) < 0.5
        k = torch.where(rotate, torch.randint(0, 4, (self.b,), dtype=i32,
                                              **kw), 0).to(i32)
        flip = (torch.rand((self.b,), **kw) < 0.5).to(i32)
        draws = Degree2Draws(top, left, k, flip)
        index, parts = self.shard
        n = self.b // parts
        mine = slice(rows.start + index * n, rows.start + (index + 1) * n)
        batch = (self.images[mine], self.labels[mine], self.indicators[mine])
        return batch, rows_of(draws, self.shard), (rows, draws)

    def sites(self):
        return [{"op": "degree2_transform", "n": self.b // self.shard[1],
                 "size": self.size}]

    def reference_input(self, kept):
        rows, draws = kept

        def make():
            img, lab = ref.degree2(self.images[rows], self.labels[rows],
                                   draws, self.size)
            return ref.StepInput(img, lab, self.indicators[rows])
        return make


class Feed3D:
    """Batches of patches gathered by the program's PatchPipeline3D from
    volumes made on the card, at draws from the seed."""

    def __init__(self, config, traffic, gen, device, shard=(0, 1)):
        from ctseg_tpu_torch.data.datasets import PackedDataset3D
        from ctseg_tpu_torch.volumetric.pipeline3d import PatchPipeline3D

        t = traffic["patches"]
        self.shard = shard
        self.b, self.patch = config["batch"], tuple(config["input_shape"])
        h, w = t["hw"]
        self.gen, self.device = gen, device
        self.volumes, self.vlabels = [], []
        for d in t["depths"]:
            self.volumes.append((torch.randn((d, h, w), generator=gen,
                                             device=device)
                                 * traffic["hu_std"] + traffic["hu_mean"]
                                 ).cpu())
            self.vlabels.append(torch.randint(
                0, traffic["classes"], (d, h, w), generator=gen,
                device=device, dtype=torch.uint8).cpu())
        ones = np.ones(traffic["classes"] - 1, np.float32)
        self.pipe = PatchPipeline3D(
            PackedDataset3D([v.numpy() for v in self.volumes],
                            [v.numpy() for v in self.vlabels],
                            [ones] * len(self.volumes)),
            self.b, self.patch, 1, device)
        self.depths = torch.tensor(t["depths"], device=device)
        self.hw = (h, w)
        self.classes = traffic["classes"]
        self.block = t["reference_block"]

    def next(self):
        from ctseg_tpu_torch.transforms.volumetric import FlipDraws
        from ctseg_tpu_torch.volumetric.pipeline3d import PatchDraws

        kw = {"generator": self.gen, "device": self.device}
        (h, w), (ph, pw, pd) = self.hw, self.patch
        vol = torch.randint(0, len(self.volumes), (self.b,), **kw)
        top = torch.randint(0, h - ph + 1, (self.b,), **kw)
        left = torch.randint(0, w - pw + 1, (self.b,), **kw)
        u = torch.rand((self.b,), **kw)
        room = torch.clamp_min(self.depths[vol] - pd, 0).to(torch.float32)
        front = (u * (room + 1.0)).to(torch.int64)
        draws = PatchDraws(vol, top, left, front)
        flips = FlipDraws(torch.rand((self.b,), **kw) < 0.5,
                          torch.rand((self.b,), **kw) < 0.5)
        batch = self.pipe.gather(rows_of(draws, self.shard))
        return batch, rows_of(flips, self.shard), (draws, flips)

    def sites(self):
        return []

    def release(self):
        del self.pipe

    def reference_input(self, kept):
        draws, flips = kept

        def make():
            vols = [v.to(self.device) for v in self.volumes]
            labs = [v.to(self.device) for v in self.vlabels]
            img, lab = ref.patches(vols, labs, draws, self.patch)
            img, lab = ref.patch_transform(img, lab, flips)
            ind = torch.ones((self.b, self.classes - 1), device=self.device)
            return ref.StepInput(img, lab, ind)
        return make


def make_trainer(config, device, mesh=None):
    if config["spatial_dims"] == 2:
        from ctseg_tpu_torch.training.trainer import Trainer

        return Trainer(train_config(config), device, mesh=mesh)
    from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d

    return make_trainer_3d(train_config(config), config["volumetric_mode"],
                           tuple(config["input_shape"]), device, mesh=mesh)


def program_trajectory(state, weights, losses, grad_norms) -> ref.Trajectory:
    with torch.no_grad():
        change = {k: float((p.detach().double()
                            - weights[k].to(p.device).double()).norm())
                  for k, p in state.model.named_parameters()}
    return ref.Trajectory(losses, grad_norms, change)


def first_steps(cell, seed: int, device, kinds=None, mesh=None):
    """Set-up: the feed, the trainer and its state from `seed`, driven
    through the first steps. Returns a namespace with the trainer, state,
    feed, host weights, the program's trajectory, the reference's inputs,
    and (with `kinds`) each kind's least seconds a step. On a data mesh
    (parallel/mesh.py) every rank makes the same inputs and weights and
    feeds its rows of the global batch."""
    config, traffic = cell.config, cell.traffic
    shard = (0, 1) if mesh is None else (mesh.data_index,
                                         mesh.shape["data"])
    clock = harness.Clock(verbose=shard[0] == 0)
    clock.runtime(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    feed = (Feed2D if config["spatial_dims"] == 2 else Feed3D)(
        config, traffic, gen, device, shard)
    clock.mark("inputs")
    weights = make_weights(config, seed, device)
    trainer = make_trainer(config, device, mesh)
    # The state's own draw runs on the card; the weights are then set.
    with torch.device(device):
        state = trainer.init_state(
            torch.Generator(device=device).manual_seed(seed))
    state.model.load_state_dict(weights)
    host = {k: v.cpu() for k, v in weights.items()}
    del weights
    clock.mark("trainer and weights")
    names = [k for k, _ in state.model.named_parameters()]
    beta1 = config["adam_betas"][0]
    losses, grad_norms, kept, least = [], {}, [], None
    for t in range(traffic["reference_steps"]):
        batch, draws, keep = feed.next()
        kept.append(keep)
        if t == 0 and kinds is not None:
            sites, remove = harness.unit_sites(state.model)
            harness.reset_counters(kinds)
        state, metrics = trainer.train_step(state, batch, draws)
        losses.append(float(metrics["loss/total"]))
        if t == 0:
            if kinds is not None:
                remove()
                least = harness.least_seconds(
                    sites + feed.sites(), kinds, harness.read_counters(kinds))
            opt = state.optimizer
            grad_norms = {
                k: float(opt.state[p]["exp_avg"].double().norm() / (1 - beta1))
                if "exp_avg" in opt.state.get(p, {}) else 0.0
                for k, p in zip(names, state.model.parameters())}
        clock.mark(f"step {t + 1}")
    trajectory = program_trajectory(state, host, losses, grad_norms)
    harness.synchronize(device)
    return SimpleNamespace(trainer=trainer, state=state, feed=feed,
                           weights=host, trajectory=trajectory, kept=kept,
                           least=least)


def reference(setup, cell, device, tf32=False,
              dtype=torch.float32) -> ref.Trajectory:
    weights = {k: v.to(device) for k, v in setup.weights.items()}
    inputs = [setup.feed.reference_input(k) for k in setup.kept]
    return ref.run_steps(cell.config, weights, inputs, setup.feed.block,
                         device, tf32=tf32, dtype=dtype)


def gaps(prog: ref.Trajectory, want: ref.Trajectory,
         detail: bool = False) -> Dict:
    """The numbers `correct` compares: the loss's relative gap at the worst
    step; per leaf the gap between the program's and the reference's norm
    of the first gradient over the larger of the reference's norm of that
    leaf and of the median leaf, its median over the leaves; and the same
    gap of the parameters' change at the worst leaf, over the leaves that
    move (STILL_SHARE).

    The first gradient is compared at the median leaf, not the worst: the
    worst is a PReLU slope on every seed, a sum of 10^8 terms that cancel,
    which float32 rounds as far from float64 in the reference as in the
    program (PERF.md). With `detail`, also the worst leaf's gradient gap,
    the median change gap, and where each is worst."""
    loss = [abs(a - b) / abs(b) for a, b in zip(prog.losses, want.losses)]
    g = want.grad_norms
    gmed = statistics.median(g.values())
    grad = {k: abs(prog.grad_norms[k] - v) / max(v, gmed)
            for k, v in g.items()}
    moving = [k for k, v in g.items() if v >= STILL_SHARE * gmed]
    c = want.change_norms
    cmed = statistics.median(c[k] for k in moving)
    change = {k: abs(prog.change_norms[k] - c[k]) / max(c[k], cmed)
              for k in moving}
    out = {"loss_gap": max(loss),
           "grad_gap_median": statistics.median(grad.values()),
           "change_gap": max(change.values())}
    if detail:
        out["loss_step"] = loss.index(max(loss)) + 1
        out["grad_gap_worst"] = max(grad.values())
        out["grad_leaf"] = max(grad, key=grad.get)
        out["change_gap_median"] = statistics.median(change.values())
        out["change_leaf"] = max(change, key=change.get)
        out["left_out"] = len(g) - len(moving)
    return out


def window(setup, device, seconds: float, prof, go=None):
    """The measured window: steps enqueued while `go(elapsed)` holds (by
    default: elapsed < seconds), then a synchronize. Returns (start, end,
    steps) on the host's clock."""
    trainer, state, feed = setup.trainer, setup.state, setup.feed
    go = go or (lambda elapsed: elapsed < seconds)
    steps = 0
    with harness.span("window", prof):
        t0 = time.perf_counter()
        while go(time.perf_counter() - t0):
            with harness.span("feed", prof):
                batch, draws, _ = feed.next()
            with harness.span("train_step", prof):
                state, _ = trainer.train_step(state, batch, draws)
            steps += 1
        harness.synchronize(device)
        t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
    return t0, t1, steps


def release(setup, device) -> None:
    """Frees the program's state, before the reference runs."""
    setup.trainer = setup.state = None
    if hasattr(setup.feed, "release"):
        setup.feed.release()
    harness.free(device)


def outcome(cell, setup, t0, t1, steps, memory, prof, checks):
    b = cell.config["batch"]
    least = {k: (v * steps if v is not None else None)
             for k, v in (setup.least or {}).items()}
    return SimpleNamespace(
        window_start=t0, window_s=t1 - t0, attempted=steps, failed=0,
        end_to_end={"train_samples_per_s": steps * b / (t1 - t0)},
        checks=checks, memory_peak=memory, profiler=prof,
        ctx=dict(steps=steps, batch=b, scans=0, model_slices=0,
                 least_s=least))


def run(cell, seed: int, seconds: float, trace: bool, device,
        kinds: Dict) -> SimpleNamespace:
    if cell.traffic.get("ranks", 1) > 1:
        from benchmark.loops import ranks

        return ranks.run(cell, seed, seconds, trace, device, kinds)
    setup = first_steps(cell, seed, device, kinds)
    prof = harness.start_profiler() if trace else None
    t0, t1, steps = window(setup, device, seconds, prof)
    memory = harness.memory_peak(device)
    release(setup, device)
    with harness.timed("reference"):
        checks = gaps(setup.trajectory, reference(setup, cell, device))
    return outcome(cell, setup, t0, t1, steps, memory, prof, checks)
