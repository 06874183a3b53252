"""Time the Model L train step (`bench.py` line 1: full width, degree 2,
Focal+Dice with exclude_missing, batch 128) in float32 and in bfloat16
compute, the step by median over timed steps after warm-up; optionally
chip_smoke.py's K2b phase (each K2 site's kernel and plain times). Not part
of the library: run it alone on the card, from the repository root,

    python3 ctseg_tpu_torch/csrc/tools/time_model_l_step.py [--steps 10]
        [--warmup 3] [--k2b] [--profile]

It uses only chip_smoke.py's phase 9 helpers, launch counters and K2b
phase, which earlier trees' chip_smoke.py has too, so a copy of it placed
in a checkout of an earlier commit times that commit's step: run the two
in turns within one call (parent, change, change, parent) to compare
them. chip_smoke.py's phase 10b calls `time_model_l`.
The last line is one JSON object: {"tree", "card", "model_l": {dtype:
{"ms_median", "ms_min", "ms_max", "ms_host_mean", "slices_per_s",
"launches_per_step"}}, "k2b_ms_per_step": {dtype: ms} or null}.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def time_model_l(label, batch, draws, dtype, steps=10, warmup=3,
                 profile=False):
    """Model L (`chip_smoke._model_l_config(dtype)`, weights from seed 0)
    trained `warmup` steps, then `steps` more on one batch and draws. Each
    timed step lies between two CUDA events on the stream, queued with no
    host sync between the steps; the median of those is the step's time.
    The host clock's mean over the same steps stands beside it, and the
    launches a step are held to chip_smoke.PER_STEP. With `profile`, the
    step's device time by group of kernels follows
    (chip_smoke.profile_step)."""
    import torch
    from ctseg_tpu_torch.training.trainer import Trainer

    trainer = Trainer(chip_smoke._model_l_config(dtype), chip_smoke.DEVICE)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    for _ in range(warmup):
        state, _ = trainer.train_step(state, batch, draws)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    chip_smoke.reset_launches()
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        state, metrics = trainer.train_step(state, batch, draws)
        events[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = chip_smoke.read_launches()
    if launches != {k: v * steps for k, v in chip_smoke.PER_STEP.items()}:
        raise AssertionError(f"{dtype} launches {launches} over {steps} "
                             "steps")
    loss = float(metrics["loss/total"])
    if loss != loss:
        raise AssertionError(f"{dtype} loss is NaN")
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    median = statistics.median(ms)
    n = batch[0].shape[0]
    out = {"ms_median": median, "ms_min": min(ms), "ms_max": max(ms),
           "ms_host_mean": host_ms, "slices_per_s": n / median * 1e3,
           "launches_per_step": {k: v // steps for k, v in launches.items()}}
    print(f"[{label}] Model L train step, {dtype} compute, batch {n}: median "
          f"{median:.3f} ms/step ({out['slices_per_s']:.2f} slices/s) over "
          f"{steps} steps after {warmup} warm-ups (CUDA events a step, min "
          f"{min(ms):.3f}, max {max(ms):.3f}; host clock mean "
          f"{host_ms:.3f}); last loss {loss:.5f}")
    if profile:
        chip_smoke.profile_step(
            label, f"Model L train step, {dtype} compute",
            lambda: trainer.train_step(state, batch, draws))
    del trainer, state
    torch.cuda.empty_cache()
    return out


def step_inputs():
    """chip_smoke.py phase 9's batch and draws: the first batch of a
    synthetic split of 2 x 128 slices of 280x280, degree-2 draws from seed
    3."""
    import torch
    from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
    from ctseg_tpu_torch.transforms.augment import draw_degree2

    n = chip_smoke.TRAIN_BATCH
    train = DevicePipeline2D(chip_smoke._synthetic_split(0, 2 * n), n,
                             chip_smoke.DEVICE)
    batch = next(train.epoch(
        torch.Generator(device=chip_smoke.DEVICE).manual_seed(2)))
    draws = draw_degree2(torch.Generator(device=chip_smoke.DEVICE)
                         .manual_seed(3), n, chip_smoke.RAW, chip_smoke.RAW,
                         chip_smoke.SIZE)
    return batch, draws


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--k2b", action="store_true",
                        help="also run chip_smoke.py's K2b phase")
    parser.add_argument("--profile", action="store_true",
                        help="each step's device time by group of kernels")
    args = parser.parse_args()

    import torch
    from ctseg_tpu_torch.training.config import use_float32_convs

    if not torch.cuda.is_available():
        sys.exit("time_model_l_step: no CUDA card")
    label = chip_smoke.card_label()
    print(f"{label}; tree {ROOT}")
    use_float32_convs()  # as chip_smoke.py's main does
    k2b = None
    if args.k2b:
        gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(0)
        _, k2b, _ = chip_smoke.phase_k2b(label, gen)
    batch, draws = step_inputs()
    result = {dtype: time_model_l(label, batch, draws, dtype, args.steps,
                                  args.warmup, args.profile)
              for dtype in ("bfloat16", "float32")}
    print(json.dumps({"tree": str(ROOT), "card": label, "model_l": result,
                      "k2b_ms_per_step": k2b}))


if __name__ == "__main__":
    main()
