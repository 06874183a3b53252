"""Shared by the benchmark's tests: cells cut to a size the CPU runs in a
second, and the `card` marker of the tests that need a CUDA card (each
decides inside the test and skips without one)."""

import copy

import pytest

from benchmark import harness

TINY_SEED = 2147483999


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def tiny_cell(workload: str):
    """The cell with its widths, batch and sizes cut for the CPU: the same
    files, the same code paths."""
    cell = harness.load_cell(workload)
    c, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    c["filters"] = [4, 8, 16, 32, 64]
    c["batch"] = 2 * t.get("ranks", 2)
    if c["spatial_dims"] == 2:
        c["input_shape"], c["raw_shape"] = [32, 32], [40, 40]
        if t["loop"] == "train":
            t["slices"]["pool_batches"] = 3
            t["slices"]["reference_block"] = 2
        else:
            t["depths"] = [5, 6, 7]
    else:
        c["input_shape"] = [32, 32, 16]
        t["patches"].update(depths=[20, 24], hw=[40, 40], reference_block=2)
    cell.config, cell.traffic = c, t
    return cell


@pytest.fixture
def cuda():
    """The card, or a skip."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
