"""The control on the card, at each cell's own size: the plain reference in
the program's place with TF32 on (the nearest precision below float32 with
TF32 off) fails one of the cell's numbers, and the program fails none.
Skips without a card. On the card, from the root of the checkout:

    python3 -m pytest benchmark/tests/test_benchmark_control.py -m card
"""

import pytest

from benchmark import harness
from benchmark.readings import segment_readings, train_readings

SEED = 2147483647


def over(numbers, limits):
    return {k for k, v in numbers.items() if k in limits and v > limits[k]}


@pytest.mark.card
@pytest.mark.parametrize("workload", ["model_l.train", "unet3d_patch.train",
                                      "model_l.segment"])
def test_control_fails_and_the_program_passes(workload, cuda):
    cell = harness.load_cell(workload)
    if cell.traffic["loop"] == "train":
        out = train_readings(cell, SEED, cuda, True, False)
    else:
        out = segment_readings(cell, SEED, cuda, True)
    assert not over(out["program"], cell.limits), out
    assert over(out["control"], cell.limits), out
