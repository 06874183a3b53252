"""The readings that the limits of `correct` are set from (limits/
<workload>.json), on the card at the cell's own size, many seeds in one
process:

    python3 benchmark/readings.py --workload <name> --seeds S [S ...]
        [--control-seeds S ...] [--fault-seeds S ...]

For every seed the program's numbers against the plain reference (the
lower reading); for the control seeds the control's, the reference in the
program's place with TF32 on (float32 with TF32 off is the configurations'
precision, TF32 the nearest below it); for the fault seeds a training
cell's `half_batch` fault (faults.py), and on a data mesh also
`exchange_left_out` on every rank. Training cells need no window: the
numbers are those of the first steps. A segmentation cell sends every
depth of the traffic once after its warm-up and judges every answer. One
JSON line a seed.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.pycache_prefix = str(ROOT / "benchmark" / "_cache" / "pycache")

from benchmark import faults, harness  # noqa: E402


def train_readings(cell, seed, device, control, fault, referee=False):
    from benchmark.loops import train as loop

    out = {"seed": seed}
    setup = loop.first_steps(cell, seed, device)
    setup.trainer = setup.state = None
    if hasattr(setup.feed, "release"):
        setup.feed.release()
    harness.free(device)
    want = loop.reference(setup, cell, device)
    out["program"] = loop.gaps(setup.trajectory, want, True)
    if control:
        out["control"] = loop.gaps(loop.reference(setup, cell, device, True),
                                   want, True)
    if referee:
        import torch

        f64 = loop.reference(setup, cell, device, dtype=torch.float64)
        out["program_vs_f64"] = loop.gaps(setup.trajectory, f64, True)
        out["reference_vs_f64"] = loop.gaps(want, f64, True)
    if fault:
        with faults.half_batch():
            broken = loop.first_steps(cell, seed, device)
        out["half_batch"] = loop.gaps(broken.trajectory, want, True)
        del broken
    del setup
    harness.free(device)
    harness.synchronize(device)
    return out


def segment_readings(cell, seed, device, control):
    from benchmark.loops import segment as loop
    from benchmark.reference import segment as ref

    with tempfile.TemporaryDirectory() as tmp:
        setup = loop.set_up(cell, seed, device, Path(tmp))
    served = [(d, setup.service.segment(v)) for d, v in setup.volumes.items()]
    setup.service = None
    harness.free(device)
    logits = loop.reference_logits(cell.config, setup.weights, setup.scans,
                                   device)
    out = {"seed": seed, "program": loop.judge(served, logits)}
    if control:
        low = loop.reference_logits(cell.config, setup.weights, setup.scans,
                                    device, tf32=True)
        answers = [(d, ref.argmax_labels(setup.scans[d].shape, low[d]))
                   for d in setup.scans]
        out["control"] = loop.judge(answers, logits)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=())
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=())
    parser.add_argument("--referee-seeds", type=int, nargs="*", default=(),
                        help="also a float64 reference (training cells)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda")
    if cell.traffic.get("ranks", 1) > 1:
        from benchmark.loops import ranks

        plan = [(s, None) for s in args.seeds] + [
            (s, f) for s in args.fault_seeds
            for f in ("half_batch", "exchange_left_out")]
        for row in ranks.readings(cell, plan, device, args.control_seeds):
            print(json.dumps(row), flush=True)
        return 0
    for seed in args.seeds:
        if cell.traffic["loop"] == "train":
            out = train_readings(cell, seed, device,
                                 seed in args.control_seeds,
                                 seed in args.fault_seeds,
                                 seed in args.referee_seeds)
        else:
            out = segment_readings(cell, seed, device,
                                   seed in args.control_seeds)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
