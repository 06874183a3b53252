"""The port's spans (utils/profiling.py::span) in a CPU trace.

  - A 2D train step, plain and under mixup, records `ctseg.step` with the
    step's number and its phases inside it, in the order the step runs
    them, and no `ctseg.sync`: a step never waits for the device.
  - A scan records `ctseg.scan` with its depth, a batch of slices one
    `ctseg.scan.cast`, `.h2d` and `.forward`, in that order, inside the
    scan; after every batch one `.store` holding the scan's only wait
    `ctseg.sync`; with the crop, one `ctseg.scan.paste`.
  - The 3D patch gather records `ctseg.patch.gather`.
"""

import numpy as np
import pytest
import torch

from ctseg_tpu_torch.data.datasets import PackedDataset3D
from ctseg_tpu_torch.inference.predict import predict_scan
from ctseg_tpu_torch.training.config import TrainConfig, build_model
from ctseg_tpu_torch.training.trainer import Trainer
from ctseg_tpu_torch.transforms.augment import draw_degree2
from ctseg_tpu_torch.utils import profiling
from ctseg_tpu_torch.utils.miccai import Volume
from ctseg_tpu_torch.volumetric.pipeline3d import PatchPipeline3D

FILTERS = (4, 8, 16, 32, 64)
RAW, SIZE, BATCH = 40, 32, 4


def spans(prof):
    """[(name, start, end, args)] of the trace's `ctseg.` spans, by start."""
    out = [(e.name(), e.start_ns(), e.end_ns(), e.kwinputs())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("ctseg.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def inside(outer, spans_):
    """The spans that lie within `outer` (itself left out)."""
    return [s for s in spans_ if s is not outer
            and outer[1] <= s[1] and s[2] <= outer[2]]


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(40.0, 300.0, (BATCH, RAW, RAW)).astype(np.float32)
    labels = rng.integers(0, 10, (BATCH, RAW, RAW)).astype(np.uint8)
    indicators = (rng.random((BATCH, 9)) < 0.8).astype(np.float32)
    return tuple(map(torch.from_numpy, (images, labels, indicators)))


@pytest.mark.parametrize("mixup", [False, True])
def test_a_train_step_records_its_phases_in_order(tmp_path, mixup):
    cfg = TrainConfig(filters=FILTERS, num_res_units=1 if mixup else 2,
                      transform_degree=2, input_size=SIZE, batch_size=BATCH,
                      exclude_missing=True, mixup=mixup,
                      loss_fx=("Focal", "Dice"))
    tr = Trainer(cfg, "cpu")
    state = tr.init_state()
    gen = torch.Generator().manual_seed(3)
    draws = draw_degree2(gen, BATCH, RAW, RAW, SIZE)
    state, _ = tr.train_step(state, _batch(0), draws, generator=gen)
    with profiling.trace(str(tmp_path / "profile")) as prof:
        state, _ = tr.train_step(state, _batch(1), draws, generator=gen)
    got = spans(prof)
    steps = [s for s in got if s[0] == "ctseg.step"]
    assert len(steps) == 1 and steps[0][3] == {"step": 1}
    assert inside(steps[0], got) == got[1:]
    assert [s[0] for s in got[1:]] == [
        "ctseg.step.transform", "ctseg.step.forward", "ctseg.step.loss",
        "ctseg.step.optimizer", "ctseg.step.backward",
        "ctseg.step.optimizer", "ctseg.step.dice"]
    # the phases follow one another: none holds another
    assert all(a[2] <= b[1] for a, b in zip(got[1:], got[2:]))


@pytest.mark.parametrize("crop", [False, True])
def test_a_scan_records_one_forward_and_one_sync_a_batch(tmp_path, crop):
    """One forward a batch, and one sync a scan: every batch is launched
    before the scan's single wait (the name is older than the pipeline)."""
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, transform_degree=1,
                      input_size=SIZE, batch_size=4)
    model = build_model(cfg, "cpu",
                        generator=torch.Generator().manual_seed(0)).eval()
    depth, hw = 12, 512 if crop else 48
    scan = np.random.default_rng(1).normal(
        0.0, 400.0, (1, depth, hw, hw)).astype(np.int16)
    with profiling.trace(str(tmp_path / "profile")) as prof:
        labels = predict_scan(model, cfg, Volume(scan), "cpu", crop=crop,
                              batch_size=3)
    assert labels.shape == (depth, hw, hw)
    got = spans(prof)
    scans = [s for s in got if s[0] == "ctseg.scan"]
    assert len(scans) == 1 and scans[0][3] == {"depth": depth}
    assert inside(scans[0], got) == got[1:]
    names = [s[0] for s in got]
    batches = -(-(8 if crop else depth) // 3)  # the box keeps 8 of 12
    # the box; every batch launched; the output map; one wait; the paste
    assert names[1:] == (
        ["ctseg.scan.crop"]
        + ["ctseg.scan.cast", "ctseg.scan.h2d", "ctseg.scan.forward"]
        * batches
        + ["ctseg.scan.crop", "ctseg.scan.store", "ctseg.sync"]
        + ["ctseg.scan.paste"] * crop)
    store = next(s for s in got if s[0] == "ctseg.scan.store")
    assert [s[0] for s in inside(store, got)] == ["ctseg.sync"]
    # the parts follow one another: none holds another but the store
    parts = [s for s in got[1:] if s[0] != "ctseg.sync"]
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))


def test_the_patch_gather_records_its_span(tmp_path):
    rng = np.random.default_rng(2)
    vols = [rng.normal(0, 300, (20, 40, 40)).astype(np.float32)
            for _ in range(2)]
    labs = [rng.integers(0, 10, v.shape).astype(np.uint8) for v in vols]
    pipe = PatchPipeline3D(
        PackedDataset3D(vols, labs, [np.ones(9, np.float32)] * 2), 2,
        (32, 32, 16), 1, "cpu")
    draws = pipe.draw(torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path / "profile")) as prof:
        images, _, _ = pipe.gather(draws)
    assert images.shape == (2, 32, 32, 16)
    assert [s[0] for s in spans(prof)] == ["ctseg.patch.gather"]
