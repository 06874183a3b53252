"""Time K1's two-phase forms against their chunk cap
(ops/instance_norm.py::MAX_CHUNKS) at the shapes the batch-1 `model_3d`
step and the batch-4 3D evaluation give K1, beside the batch-128 3D and 2D
sites that the cap must leave alone. The cap's value was chosen from this
table. Not part of the library: run it alone on the card, from the
repository root,

    python3 ctseg_tpu_torch/csrc/tools/sweep_k1_chunks.py

It prints the card's name and power limit, then one line per shape: the
plain versions' times, the bytes' bounds (forward: x read, y written;
backward: x and g read, dx written; over 3.35 TB/s), and for each cap the
chunks a sample, the training forward's and K1b's device milliseconds
(chip_smoke.py's time_ms: CUDA events, mean of 20 after a warm-up; K1b
"nan" where it takes its read-once form, which has no chunks), flagging a
cap whose statistics leave the plain mean's 1e-5.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

import chip_smoke as cs  # noqa: E402
from ctseg_tpu_torch.ops import _build  # noqa: E402
from ctseg_tpu_torch.ops import instance_norm as k1  # noqa: E402

SHAPES = [(1, 64, 64, 24, 128), (1, 128, 128, 48, 64), (1, 256, 256, 96, 10),
          (4, 64, 64, 24, 64), (4, 128, 128, 48, 10), (128, 128, 128, 16, 10),
          (32, 256, 256, 10), (2, 64, 64, 16, 16)]
CAPS = (65535, 2048, 1024, 512, 256, 128, 64, 32)


def main():
    print(cs.card_label(), flush=True)
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kept = k1.MAX_CHUNKS
    for shape in SHAPES:
        x = cs._k1_input(gen, shape)
        g = torch.randn(shape, generator=gen, device="cuda")
        a = torch.full((1,), 0.25, device="cuda")
        n, c = shape[0], shape[-1]
        s = x.numel() // (n * c)
        if k1.fwd_cluster_plan(n, s, c, 4) is not None:
            print(shape, "takes the read-once forward; skipped", flush=True)
        _, mean, var = k1._fwd_plain(x, a)
        tp = cs.time_ms(lambda: k1._fwd_plain(x, a), 3)
        tbp = cs.time_ms(lambda: k1.instance_norm_prelu_bwd_plain(
            x, g, mean, var, a), 3)
        out = []
        for cap in CAPS:
            k1.MAX_CHUNKS = cap
            plan = k1.fwd_plan(n, s, c, 4)
            tf = cs.time_ms(lambda: k1._forward(x, a, train=True), 20)
            tb = (cs.time_ms(lambda: k1.instance_norm_prelu_bwd(
                x, g, mean, var, a), 20)
                if k1.bwd_cluster_plan(n, s, c, 4) is None else float("nan"))
            _, mk, _ = k1._forward(x, a, train=True)
            ok = bool(torch.allclose(mk, mean, rtol=1e-5, atol=1e-5))
            out.append(f"cap {cap}: chunks {plan['chunks']} fwd {tf:.4f} "
                       f"bwd {tb:.4f}{'' if ok else ' MEAN OFF'}")
        k1.MAX_CHUNKS = kept
        bf = 2 * x.numel() * 4 / cs.PEAK_BYTES * 1e3
        print(shape, f"plain fwd {tp:.4f} bwd {tbp:.4f}; bounds fwd {bf:.4f} "
              f"bwd {1.5 * bf:.4f}; " + "; ".join(out), flush=True)
        del x, g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
