"""A run driven end to end at a tiny CPU size, with the timed path broken
underneath: `correct` comes out false for each fault a cell can have,
through a number that the unbroken run at the same seed keeps within its
limit. The data-parallel cell runs as four gloo processes."""

import functools

import pytest

from benchmark import faults
from benchmark.run import run_workload
from benchmark.tests.conftest import TINY_SEED, tiny_cell

CASES = [("model_l.train", "state_unchanged"),
         ("model_l.train", "half_batch"),
         ("unet3d_patch.train", "state_unchanged"),
         ("unet3d_patch.train", "half_batch"),
         ("model_l.segment", "answer_altered"),
         ("unet3d_patch.train.dp4", "exchange_left_out"),
         ("unet3d_patch.train.dp4", "half_batch")]


@functools.lru_cache(maxsize=None)
def unbroken(workload):
    return run_workload(workload, TINY_SEED, 0.5, False, "cpu",
                        tiny_cell(workload))


def failing(result):
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("workload,fault", CASES)
def test_correct_fails_under_each_fault(workload, fault):
    with faults.FAULTS[fault]():
        result = run_workload(workload, TINY_SEED, 0.5, False, "cpu",
                              tiny_cell(workload))
    assert not result["correct"], result["checks"]
    assert failing(result) - failing(unbroken(workload)), result["checks"]


@pytest.mark.parametrize("workload", ["model_l.train", "model_l.segment"])
def test_correct_holds_without_a_fault(workload):
    result = unbroken(workload)
    assert result["correct"], result["checks"]
