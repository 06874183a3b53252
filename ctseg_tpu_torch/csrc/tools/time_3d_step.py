"""Time the train steps that run the shallow weight gradient
(ops/shallow_grad.py): the bench_3d patch step (`bench.py` line 2: the 3D
UNet 64..1024, batch 128 x 128x128x16) in float32 and bfloat16, the
model_3d preset's step (batch 1 at 256x256x96) and the Model L step in
float32 and bfloat16. Not part of the library: run it alone on the card, from the
repository root,

    python3 ctseg_tpu_torch/csrc/tools/time_3d_step.py [--steps 5]
        [--warmup 2] [--profile]

Each step is timed between two CUDA events on one fixed batch after the
warm-up steps, with no host sync between the steps; the median is the
step's time. It uses only chip_smoke.py's helpers and
time_model_l_step.py, which earlier trees have too, so a copy of it placed
in a checkout of an earlier commit times that commit's steps: run the two
in turns within one call (parent, change, change, parent). The launches a
step are held to that tree's own chip_smoke.py counts. The last line is
one JSON object: {"tree", "card", "steps": {name: {"ms_median", "ms_min",
"ms_max", "launches_per_step"}}}.
"""

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402


def time_steps(label, name, trainer, state, batch, want, steps, warmup,
               profile=False, **kw):
    """Median CUDA-event ms of `steps` train steps on one batch."""
    import torch

    for _ in range(warmup):
        state, _ = trainer.train_step(state, batch, **kw)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    chip_smoke.reset_launches()
    events[0].record()
    for i in range(steps):
        state, metrics = trainer.train_step(state, batch, **kw)
        events[i + 1].record()
    torch.cuda.synchronize()
    launches = chip_smoke.read_launches()
    if launches != {k: v * steps for k, v in want.items()}:
        raise AssertionError(f"{name}: launches {launches} over {steps} "
                             f"steps; want {want} a step")
    loss = float(metrics["loss/total"])
    if loss != loss:
        raise AssertionError(f"{name}: loss is NaN")
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    out = {"ms_median": statistics.median(ms), "ms_min": min(ms),
           "ms_max": max(ms),
           "launches_per_step": {k: v // steps for k, v in launches.items()}}
    print(f"[{label}] {name}: median {out['ms_median']:.3f} ms/step over "
          f"{steps} steps after {warmup} warm-ups (min {min(ms):.3f}, max "
          f"{max(ms):.3f}); last loss {loss:.5f}; launches a step "
          f"{out['launches_per_step']}")
    if profile:
        chip_smoke.profile_step(label, name,
                                lambda: trainer.train_step(state, batch, **kw))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--profile", action="store_true",
                        help="the float32 bench_3d step by group of kernels")
    args = parser.parse_args()

    import torch
    from ctseg_tpu_torch.models.presets import PRESETS
    from ctseg_tpu_torch.training.config import use_float32_convs
    from ctseg_tpu_torch.volumetric.pipeline3d import (
        DevicePipeline3D, PatchPipeline3D,
    )
    from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d
    from time_model_l_step import step_inputs, time_model_l

    if not torch.cuda.is_available():
        sys.exit("time_3d_step: no CUDA card")
    label = chip_smoke.card_label()
    print(f"{label}; tree {ROOT}")
    use_float32_convs()  # as chip_smoke.py's main does
    result = {}
    data = chip_smoke._volumes_3d(0, 4)
    for dtype in ("float32", "bfloat16"):
        trainer = make_trainer_3d(chip_smoke._config_3d(dtype), "patch",
                                  chip_smoke.PATCH_3D, chip_smoke.DEVICE)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        pipe = PatchPipeline3D(data, chip_smoke.TRAIN_BATCH,
                               chip_smoke.PATCH_3D, 1, chip_smoke.DEVICE)
        gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(5)
        batch = pipe.gather(pipe.draw(gen))
        result[f"bench_3d {dtype}"] = time_steps(
            label, f"bench_3d step, {dtype}, batch {chip_smoke.TRAIN_BATCH}",
            trainer, state, batch, chip_smoke.PER_STEP_3D, args.steps,
            args.warmup, args.profile and dtype == "float32", generator=gen)
        del trainer, state, pipe, batch
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(PRESETS["model_3d"], epochs=1)
    trainer = make_trainer_3d(cfg, "resize", device=chip_smoke.DEVICE)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    pipe = DevicePipeline3D(chip_smoke._volumes_3d(3, 2), 1,
                            tuple(cfg.input_shape), chip_smoke.DEVICE)
    result["model_3d"] = time_steps(
        label, "model_3d step, float32, batch 1", trainer, state,
        next(pipe.epoch()), getattr(chip_smoke, "PER_STEP_RESIZE_3D",
                                    chip_smoke.PER_STEP_3D),
        args.steps, args.warmup)
    del trainer, state, pipe
    torch.cuda.empty_cache()
    batch, draws = step_inputs()
    for dtype in ("float32", "bfloat16"):
        result[f"model_l {dtype}"] = time_model_l(label, batch, draws, dtype,
                                                  10, 3)
    print(json.dumps({"tree": str(ROOT), "card": label, "steps": result}))


if __name__ == "__main__":
    main()
