"""Time the serving path alone: chip_smoke.py's phase 4 (full-width Model L
with random weights from seed 0, three synthetic 120x512x512 scans served
over HTTP, a fourth request with ?counts=1), which prints each request's
latency, the model's forward at batch 32, segment() without HTTP and the
NRRD read. Not part of the library: run it alone on the card, from the
repository root,

    python3 ctseg_tpu_torch/csrc/tools/time_serve.py [--rounds N]

It uses only chip_smoke.py's phase 4, so a copy of it placed in a checkout
of an earlier commit times that commit's serving path: run the two in turns
within one call (parent, change, change, parent) to compare them.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=1,
                        help="phase 4 runs in this process")
    args = parser.parse_args()

    from ctseg_tpu_torch.training.config import use_float32_convs

    label = chip_smoke.card_label()
    print(f"{label}; tree {ROOT}")
    use_float32_convs()  # as chip_smoke.py's main does
    for i in range(args.rounds):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            chip_smoke.phase_serve(label, Path(tmp))
            print(f"round {i}: phase 4 in {time.perf_counter() - t0:.3f} s")


if __name__ == "__main__":
    main()
