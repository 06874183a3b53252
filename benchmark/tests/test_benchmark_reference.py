"""The plain reference (benchmark/reference/) against the port's CPU path
at a tiny size: the same model from the same weights, the same training
trajectory, the same label maps."""

import ast

import pytest
import torch

from benchmark import harness
from benchmark.loops import train as train_loop
from benchmark.readings import segment_readings
from benchmark.reference.unet import Model, make_weights
from benchmark.tests.conftest import TINY_SEED, tiny_cell


@pytest.mark.parametrize("workload", ["model_l.train", "unet3d_patch.train"])
def test_model_equals_the_ports_in_float64(workload):
    from ctseg_tpu_torch.training.config import build_model

    cell = tiny_cell(workload)
    weights = make_weights(cell.config, TINY_SEED, torch.device("cpu"))
    cfg = train_loop.train_config(cell.config)
    port = build_model(cfg.__class__(**{**cfg.as_dict(),
                                        "compute_dtype": "float64"}),
                       device="cpu")
    port.load_state_dict(weights)
    ref = Model(cell.config).double()
    ref.load_state_dict(weights)
    shape = (2, cell.config["in_channels"]) + tuple(cell.config["input_shape"])
    x = torch.randn(shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(port(x), ref(x), rtol=1e-10, atol=1e-10)


def test_weights_follow_the_seed():
    cell = tiny_cell("model_l.train")
    a = make_weights(cell.config, TINY_SEED, torch.device("cpu"))
    b = make_weights(cell.config, TINY_SEED, torch.device("cpu"))
    c = make_weights(cell.config, TINY_SEED + 1, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a if "conv" in k)
    assert all(float(v.abs().max()) <= 1.0 for v in a.values())


@pytest.mark.parametrize("workload", ["model_l.train", "unet3d_patch.train"])
def test_trajectory_matches_the_ports(workload):
    cell = tiny_cell(workload)
    cpu = torch.device("cpu")
    setup = train_loop.first_steps(cell, TINY_SEED, cpu)
    want = train_loop.reference(setup, cell, cpu)
    gaps = train_loop.gaps(setup.trajectory, want)
    assert gaps["loss_gap"] <= cell.limits["loss_gap"]
    assert gaps["grad_gap_median"] <= cell.limits["grad_gap_median"]
    # A tiny model's leaves hold few elements, so an Adam step whose sign
    # flips on a gradient near nought moves a leaf's norm further than at
    # the configuration's widths.
    assert gaps["change_gap"] <= 0.01


def test_label_maps_match_the_ports():
    cell = tiny_cell("model_l.segment")
    out = segment_readings(cell, TINY_SEED, torch.device("cpu"), False)
    assert out["program"]["outside_box"] == 0
    assert out["program"]["label_gap"] <= cell.limits["label_gap"]


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in (
                    "ctseg_tpu_torch", "ctseg_tpu", "jax", "jaxlib",
                    "flax"), (path.name, n)
