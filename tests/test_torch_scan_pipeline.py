"""The pipelined 2D scan path (inference/predict.py::predict_scan) on the
CPU, at tiny filters:

  - its map equals, bit for bit, `slice_labels` batch by batch over the
    region cast to float32 in numpy, pasted into zeros: int16 and float32
    scans, and dtypes cast on the host as they are staged; crop on and off;
    a batch size that does not divide the region; a flipped scan;
  - a scan is staged in its own dtype when float32 holds it exactly, and
    the buffers grow to the largest scan and are reused below it;
  - `SegmentationService.segment` returns a fresh map each call: a deeper
    scan after a shallower one leaves the first map as it was;
  - a float32 warm-up followed by an int16 scan gives a fresh
    `predict_scan`'s map.
"""

import numpy as np
import pytest
import torch

from ctseg_tpu_torch.inference.predict import (
    ScanBuffers,
    predict_scan,
    slice_labels,
)
from ctseg_tpu_torch.inference.serve import SegmentationService
from ctseg_tpu_torch.training.config import (
    TrainConfig,
    build_model,
    save_checkpoint,
)
from ctseg_tpu_torch.transforms.pipelines import get_transform
from ctseg_tpu_torch.utils.miccai import CropBox, Volume
from ctseg_tpu_torch.utils.profiling import to_host

CFG = TrainConfig(filters=(4, 8, 16, 32, 64), num_res_units=1,
                  transform_degree=2, input_size=32, batch_size=4)
BATCH = 3  # divides neither the box's 8 slices of 12 nor 7


@pytest.fixture(scope="module")
def model():
    return build_model(CFG, "cpu",
                       generator=torch.Generator().manual_seed(0)).eval()


def scan(depth, hw, dtype, seed=0):
    """(1, D, H, W) HU in `dtype`, with air, tissue and bone."""
    hu = np.random.default_rng(seed).normal(40.0, 500.0, (1, depth, hw, hw))
    return np.clip(np.round(hu), -1024, 3071).astype(dtype)


def composed(model, data, crop, batch=BATCH):
    """The map the serial path gave: each batch of the region cast to
    float32 in numpy, `slice_labels`, pasted into zeros."""
    box = CropBox.anatomical(data.shape[0]) if crop else None
    region = box.apply(data[None])[0] if box else data
    transform = get_transform(CFG.transform_degree, train=False,
                              size=(CFG.input_size,) * 2)
    with torch.inference_mode():
        labels = np.concatenate([
            slice_labels(model, transform, torch.from_numpy(
                np.asarray(region[lo : lo + batch], np.float32))).numpy()
            for lo in range(0, len(region), batch)])
    if box is None:
        return labels
    full = np.zeros(data.shape, np.uint8)
    full[box.z[0] : box.z[1], box.x[0] : box.x[1],
         box.y[0] : box.y[1]] = labels
    return full


@pytest.mark.parametrize("dtype", ["int16", "float32", "float64", ">i2"])
@pytest.mark.parametrize("crop", [False, True], ids=["whole", "crop"])
def test_a_scan_equals_the_serial_composition(model, dtype, crop):
    data = scan(12 if crop else 7, 512 if crop else 48, dtype)
    got = predict_scan(model, CFG, Volume(data), "cpu", crop=crop,
                       batch_size=BATCH)
    want = composed(model, data[0], crop)
    assert got.dtype == np.uint8 and got.shape == data.shape[1:]
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1  # the labels are not one constant


def test_a_flipped_scan_equals_the_serial_composition(model):
    data = scan(12, 512, "int16")[:, ::-1, :, ::-1]  # negative strides
    got = predict_scan(model, CFG, Volume(data), "cpu", batch_size=BATCH)
    np.testing.assert_array_equal(got, composed(model, data[0], crop=True))


@pytest.mark.parametrize("dtype,staged", [
    ("int16", torch.int16), ("uint8", torch.uint8),
    ("float32", torch.float32), ("float64", torch.float32),
    (">i2", torch.float32), ("int32", torch.float32)])
def test_a_scan_is_staged_in_its_own_dtype_where_float32_holds_it(
        model, dtype, staged):
    buffers = ScanBuffers("cpu")
    predict_scan(model, CFG, Volume(scan(12, 512, dtype)), "cpu",
                 batch_size=BATCH, buffers=buffers)
    assert set(buffers._held) == {("slices", staged), ("labels", torch.uint8)}
    assert buffers._held["slices", staged].numel() == 8 * 280 * 280


def test_the_buffers_grow_to_the_largest_scan_and_are_reused_below_it():
    buffers = ScanBuffers("cpu")
    assert not buffers.pinned and ScanBuffers("cuda").pinned
    small = buffers.take("slices", (2, 3, 4), torch.int16)
    large = buffers.take("slices", (5, 3, 4), torch.int16)
    again = buffers.take("slices", (3, 3, 4), torch.int16)
    assert small.shape == (2, 3, 4) and again.shape == (3, 3, 4)
    assert large.data_ptr() != small.data_ptr()
    assert again.data_ptr() == large.data_ptr()
    other = buffers.take("labels", (3, 3, 4), torch.int16)
    assert other.data_ptr() != large.data_ptr()
    assert buffers.take("slices", (3, 3, 4), torch.float32).dtype \
        == torch.float32


def test_to_host_copies_into_out():
    t = torch.arange(12, dtype=torch.uint8).view(3, 4)
    out = torch.zeros(3, 4, dtype=torch.uint8)
    assert to_host(t, out=out) is out
    assert torch.equal(out, t) and torch.equal(to_host(t), t)


@pytest.fixture(scope="module")
def service(tmp_path_factory, model):
    ckpt = tmp_path_factory.mktemp("scan_pipeline") / "model.ckpt"
    save_checkpoint(ckpt, CFG, model)
    return SegmentationService(str(ckpt), device="cpu", crop=True)


def test_a_served_map_is_fresh_as_the_buffers_grow(service):
    shallow = Volume(scan(10, 512, "int16", seed=1))
    deep = Volume(scan(14, 512, "int16", seed=2))
    first = service.segment(shallow)
    kept = first.copy()
    second = service.segment(deep)
    third = service.segment(shallow)
    np.testing.assert_array_equal(first, kept)
    assert not np.shares_memory(first, second)
    assert not np.shares_memory(first, third)
    np.testing.assert_array_equal(third, kept)
    np.testing.assert_array_equal(
        second, predict_scan(service.model, service.config, deep, "cpu"))


def test_a_float32_warmup_then_an_int16_scan(service):
    volume = Volume(scan(12, 512, "int16", seed=3))
    service.warmup((12, 512, 512))
    got = service.segment(volume)
    np.testing.assert_array_equal(
        got, predict_scan(service.model, service.config, volume, "cpu"))
    np.testing.assert_array_equal(got, composed(
        service.model, volume.as_numpy()[0], crop=True, batch=32))
