"""Time the EDT row scan and K4 at the main path's shapes, with the readings
that tell what holds each back. Not part of the library: run it alone on the
card, from the repository root,

    python3 ctseg_tpu_torch/csrc/tools/time_scan_k4.py [--rounds N]

It prints the card's name and power limit, the bounds, then per round one
line of device milliseconds (CUDA events, mean of 20 launches
after a warm-up, the card kept busy while the host queues them):

  - the label scan from the Model M step's 128 uint8 label maps of 256x256
    (chip_smoke.py's `_step_labels`) to both signs of C = 9 classes, and of
    C = 1 (the same labels, n_classes = 2);
  - beside it, one copy of the C = 9 output's bytes
    (`torch.empty_like(d2).copy_(d2)`, each byte read and written) and one
    fill of them (written only);
  - the scan in mask mode on one evaluation batch's 1,152 inverted surfaces
    with one spacing per map (chip_smoke.py's `_eval_surfaces`);
  - K4 from (128, 280, 280) to 256 with every draw at k in {0, 2}, with every
    draw at k in {1, 3} (both flips, random crops), and with draws from
    `draw_degree2` as a train step makes them.

It uses only the wrappers and chip_smoke.py's inputs, so a copy of it placed
in a checkout of an earlier commit times that commit's kernels: run the two
in turns within one call to compare them.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ctseg_tpu_torch.ops import _build  # noqa: E402
from ctseg_tpu_torch.ops import edt  # noqa: E402
from ctseg_tpu_torch.ops import preprocess as k4  # noqa: E402
from ctseg_tpu_torch.transforms import augment  # noqa: E402

REPS = 20


def inputs():
    n, raw, size = chip_smoke.TRAIN_BATCH, chip_smoke.RAW, chip_smoke.SIZE
    gen = torch.Generator(device="cuda").manual_seed(0)
    labels = chip_smoke._step_labels()
    surfaces, spacing = chip_smoke._eval_surfaces(5)
    masks = surfaces.reshape(-1, size, size).contiguous()
    scale = spacing.expand(2, chip_smoke.EVAL_BATCH, 9, 2).reshape(-1, 2)
    images = torch.randn((n, raw, raw), generator=gen, device="cuda") * 600 + 100
    i = torch.arange(n, device="cuda", dtype=torch.int32)

    def draws(k):
        return augment.Degree2Draws(
            top=torch.randint(0, raw - size + 1, (n,), generator=gen,
                              device="cuda", dtype=torch.int32),
            left=torch.randint(0, raw - size + 1, (n,), generator=gen,
                               device="cuda", dtype=torch.int32),
            k=k.to(torch.int32), flip=(i // 2) % 2)

    return {
        "labels": labels, "masks": masks,
        "scale": scale[:, 1].contiguous(), "images": images,
        "k02": draws(2 * (i % 2)), "k13": draws(1 + 2 * (i % 2)),
        "step": augment.draw_degree2(gen, n, raw, raw, size),
    }


def measure(x) -> dict:
    size = chip_smoke.SIZE
    d2 = edt.label_scan(x["labels"], 10)[0]
    t = chip_smoke.time_ms
    k4_times = {
        f"K4 {name}": t(lambda: k4.window_normalize_degree2(
            x["images"], x[draws], size), REPS)
        for name, draws in (("k in {0,2}", "k02"), ("k in {1,3}", "k13"),
                            ("step draws", "step"))}
    return {
        "scan C=9": t(lambda: edt.label_scan(x["labels"], 10), REPS),
        "scan C=1": t(lambda: edt.label_scan(x["labels"], 2), REPS),
        "copy of d2": t(lambda: torch.empty_like(d2).copy_(d2), REPS),
        "fill of d2": t(lambda: d2.fill_(0.0), REPS),
        "scan masks": t(lambda: edt.row_scan(x["masks"], x["scale"]), REPS),
        **k4_times,
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    print(chip_smoke.card_label())
    _build.library()
    x = inputs()
    size, n = chip_smoke.SIZE, chip_smoke.TRAIN_BATCH
    pb = chip_smoke.PEAK_BYTES
    bounds = {
        "scan C=9": (n * size * size + 4.0 * 2 * 9 * n * size * size) / pb,
        "scan C=1": (n * size * size + 4.0 * 2 * n * size * size) / pb,
        "scan masks": 5.0 * x["masks"].numel() / pb,
        # The crop read once, the output written once.
        "K4": 4.0 * 4 * n * size * size / pb,
    }
    print("bounds (ms): " + ", ".join(
        f"{k} {v * 1e3:.4f}" for k, v in bounds.items()))
    for i in range(args.rounds):
        times = measure(x)
        print(f"{ROOT.name} round {i}: " + "; ".join(
            f"{k} {v:.4f}" for k, v in times.items()), flush=True)


if __name__ == "__main__":
    subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                    "--format=csv,noheader"], check=False)
    main()
