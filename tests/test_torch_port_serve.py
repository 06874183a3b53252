"""The port's serving path against the JAX package's, on the CPU.

  - The test transform (windows + antialiased resize + normalize) matches
    ctseg_tpu's get_transform(degree, train=False) to 1e-12 in float64, for
    a downscale and an upscale, one and three channels.
  - predict_scan gives the JAX predict_scan's label map on the same weights
    in float64, except where the JAX logits' top two are within 1e-9.
  - The HTTP server, as tests/test_serve.py drives the JAX one.
"""

import http.client
import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.inference.predict import predict_scan as jax_predict_scan
from ctseg_tpu.training.trainer import TrainConfig as JaxTrainConfig
from ctseg_tpu.training.trainer import Trainer
from ctseg_tpu.transforms.pipelines import batched_transform
from ctseg_tpu.transforms.pipelines import get_transform as jax_get_transform
from ctseg_tpu_torch.inference import predict as port_predict
from ctseg_tpu_torch.inference.predict import predict_scan, write_artifacts
from ctseg_tpu_torch.inference.serve import SegmentationService, serve
from ctseg_tpu_torch.models.jax_import import state_dict_from_jax_params
from ctseg_tpu_torch.testing.synth import make_patient
from ctseg_tpu_torch.training.config import (
    TrainConfig,
    build_model,
    save_checkpoint,
)
from ctseg_tpu_torch.transforms.pipelines import get_transform
from ctseg_tpu_torch.utils import nrrd_io
from ctseg_tpu_torch.utils.miccai import Volume

FILTERS = (4, 8, 16, 32, 64)


@pytest.mark.parametrize("degree", [0, 2])
@pytest.mark.parametrize("in_size", [48, 20], ids=["downscale", "upscale"])
def test_test_transform_matches_jax(degree, in_size):
    rng = np.random.default_rng(in_size + degree)
    images = rng.uniform(-1100.0, 1500.0, size=(3, in_size, in_size + 4))
    labels = rng.integers(0, 10, size=images.shape).astype(np.int32)
    size = (32, 32)

    ours, our_labels = get_transform(degree, train=False, size=size)(
        torch.from_numpy(images), torch.from_numpy(labels)
    )
    theirs, their_labels = batched_transform(
        jax_get_transform(degree, train=False, size=size), jax.random.key(0),
        jnp.asarray(images), jnp.asarray(labels),
    )
    assert ours.dtype == torch.float64
    assert tuple(ours.shape) == (3, 32, 32, 1 if degree == 0 else 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(our_labels.numpy(), np.asarray(their_labels))


def test_train_transforms_wait_for_the_training_slice():
    """Degree 2 came with the training slice, the others with the train
    transforms' slice: every degree trains, each with its own draws."""
    for degree in range(5):
        transform = get_transform(degree, train=True)
        assert callable(transform) and callable(transform.draw)
    with pytest.raises(ValueError, match="invalid transform degree"):
        get_transform(5, train=True)


@pytest.fixture(scope="module")
def patient(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_scans")
    return make_patient(root / "0522c0001", shape=(12, 48, 48), seed=3)


def test_predict_scan_matches_jax(patient):
    jcfg = JaxTrainConfig(filters=FILTERS, num_res_units=2, transform_degree=1,
                          input_size=32, batch_size=4, compute_dtype="float64")
    trainer = Trainer(jcfg)
    params = trainer.init_state().params
    volume = Volume.from_nrrd(patient / "img.nrrd")
    theirs = jax_predict_scan(trainer, params, volume, crop=False)

    cfg = TrainConfig.from_dict(jcfg.as_dict())
    model = build_model(cfg, "cpu")
    assert next(model.parameters()).dtype == torch.float64
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), 3, FILTERS, num_res_units=2
    ))
    ours = predict_scan(model, cfg, volume, "cpu", crop=False, batch_size=5)
    assert ours.shape == theirs.shape == (12, 48, 48) and ours.dtype == np.uint8

    # Where they differ, the JAX logits must be a near-tie (the transforms
    # run in float32 on both sides, in a different summation order).
    slices = jnp.asarray(volume.as_numpy()[0], jnp.float32)
    imgs, _ = batched_transform(trainer.test_transform, jax.random.key(0),
                                slices, jnp.zeros(slices.shape, jnp.int32))
    top2 = jnp.sort(jax.jit(trainer.model.apply)(params, imgs), axis=-1)[..., -2:]
    gap = jax.image.resize(top2[..., 1] - top2[..., 0], theirs.shape, "nearest")
    differ = ours != theirs
    assert np.all(np.asarray(gap)[differ] < 1e-9), int(differ.sum())


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_serve")
    cfg = TrainConfig(filters=FILTERS, num_res_units=2, transform_degree=1,
                      input_size=32, batch_size=4)
    save_checkpoint(root / "model.ckpt", cfg,
                    build_model(cfg, "cpu",
                                generator=torch.Generator().manual_seed(0)))
    return root / "model.ckpt"


@pytest.fixture(scope="module")
def server(checkpoint):
    service = SegmentationService(str(checkpoint), device="cpu", crop=False)
    httpd = serve(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield service, httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=60)


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    payload = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), payload


def test_healthz(server):
    service, port = server
    status, ctype, payload = _request(port, "GET", "/healthz")
    assert status == 200 and ctype == "application/json"
    info = json.loads(payload)
    assert info["status"] == "ok" and info["device"] == "cpu"
    assert info["spatial_dims"] == 2 and info["filters"] == list(FILTERS)
    assert info["num_res_units"] == 2


def test_segment_matches_direct_prediction(server, patient, tmp_path):
    service, port = server
    status, ctype, payload = _request(
        port, "POST", "/segment", (patient / "img.nrrd").read_bytes()
    )
    assert status == 200 and ctype == "application/octet-stream"
    out = tmp_path / "segmentation.nrrd"
    out.write_bytes(payload)
    served_hwd, header = nrrd_io.read(out)
    served = np.transpose(served_hwd, (2, 0, 1))

    volume = Volume.from_nrrd(patient / "img.nrrd")
    direct = predict_scan(service.model, service.config, volume, "cpu",
                          crop=False)
    np.testing.assert_array_equal(served, direct)
    assert "space directions" in header


def test_segment_counts_mode(server, patient):
    service, port = server
    before = service.served
    status, ctype, payload = _request(
        port, "POST", "/segment?counts=1", (patient / "img.nrrd").read_bytes()
    )
    assert status == 200 and ctype == "application/json"
    body = json.loads(payload)
    assert body["shape"] == [12, 48, 48]
    assert len(body["voxel_counts"]) == 9
    assert service.served == before + 1


def test_bad_requests_do_not_kill_the_server(server):
    service, port = server
    status, _, payload = _request(port, "POST", "/segment", b"not an nrrd")
    assert status == 400 and "error" in json.loads(payload)
    assert _request(port, "POST", "/segment", b"")[0] == 400
    assert _request(port, "GET", "/nope")[0] == 404
    assert _request(port, "GET", "/healthz")[0] == 200


def test_concurrent_clients(server, patient):
    """6 simultaneous clients: device work serialized under the service
    lock, every reply equal, the served counter exact."""
    service, port = server
    body = (patient / "img.nrrd").read_bytes()
    before = service.served
    results = [None] * 6

    def hit(i):
        results[i] = _request(port, "POST", "/segment?counts=1", body)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None and r[0] == 200 for r in results)
    assert all(r[2] == results[0][2] for r in results)
    assert service.served == before + 6


def test_warmup_is_not_a_served_request(server):
    service, _ = server
    before = service.served
    assert service.warmup((4, 48, 48)) >= 0
    assert service.served == before
    assert [4, 48, 48] in service.info()["warm_shapes"]


def test_predict_cli_writes_artifacts(checkpoint, patient, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "predict", "--checkpoint", str(checkpoint), "--input", str(patient),
        "--out", str(tmp_path), "--device", "cpu", "--no_crop",
    ])
    port_predict.main()
    seg, _ = nrrd_io.read(tmp_path / patient.name / "segmentation.nrrd")
    assert seg.shape == (48, 48, 12) and seg.dtype == np.uint8
    masks = sorted(p.stem for p in (tmp_path / patient.name / "structures").iterdir())
    assert len(masks) == 9


def test_write_artifacts_masks_match_labels(tmp_path):
    labels = np.random.default_rng(0).integers(0, 10, size=(3, 5, 6)).astype(np.uint8)
    write_artifacts(tmp_path, labels, {"space directions": np.diag([1.0, 1.0, 2.5])})
    seg, header = nrrd_io.read(tmp_path / "segmentation.nrrd")
    np.testing.assert_array_equal(np.transpose(seg, (2, 0, 1)), labels)
    mask, _ = nrrd_io.read(tmp_path / "structures" / "Mandible.nrrd")
    np.testing.assert_array_equal(mask, (seg == 3).astype(np.uint8))
    assert header["space directions"][2, 2] == 2.5
