"""Warm segmentation server (port of ctseg_tpu/inference/serve.py).

One process loads the checkpoint once, builds the CUDA kernels before the
first request, and serves concurrent clients with a threading HTTP server;
device work is serialized under a lock so device memory stays bounded at
one volume in flight.

Endpoints:
  GET  /healthz            -> JSON {status, checkpoint, device, served, ...}
  POST /segment            -> body: an NRRD scan (img.nrrd bytes);
                              response: segmentation.nrrd bytes (uint8
                              label map 0..9, PDDCA axis order, space
                              metadata carried over).
       ?counts=1           -> JSON per-structure voxel counts instead.
       ?crop=0             -> segment the full volume instead of the
                              anatomical head-and-neck box.

A 3D checkpoint segments by sliding windows of --patch_size with
--overlap (inference/predict.py::predict_labels_3d).

Usage:
  python -m ctseg_tpu_torch.inference.serve --checkpoint model.ckpt \\
      --device cuda --port 8080 --warmup 96 280 280
  curl -s --data-binary @img.nrrd localhost:8080/segment > segmentation.nrrd
"""

import json
import tempfile
import threading
import time
from argparse import ArgumentParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ctseg_tpu_torch.constants import NUM_CLASSES, STRUCTURES
from ctseg_tpu_torch.inference.predict import predict_scan, write_artifacts
from ctseg_tpu_torch.models.released import (
    add_released_args,
    resolve_checkpoint_arg,
)
from ctseg_tpu_torch.ops import _build
from ctseg_tpu_torch.training.config import load_checkpoint
from ctseg_tpu_torch.utils.miccai import Volume


class SegmentationService:
    """Checkpoint loaded once on `device`; thread-safe `segment`."""

    def __init__(self, checkpoint: str, device="cuda", crop: bool = True,
                 patch_size: Tuple[int, int, int] = (128, 128, 48),
                 overlap: float = 0.5):
        self.device = torch.device(device)
        self.patch_size = tuple(patch_size)
        self.overlap = overlap
        self.config, self.model = load_checkpoint(checkpoint, self.device)
        if self.device.type == "cuda":
            _build.library()  # compile the kernels before the first request
        self.checkpoint = str(checkpoint)
        self.crop = crop
        self._lock = threading.Lock()  # serializes device work
        # Counters get their own lock: healthz must not wait behind an
        # in-flight segmentation.
        self._stats_lock = threading.Lock()
        self.served = 0
        self.warm_shapes: set = set()

    def info(self) -> Dict:
        cfg = self.config
        with self._stats_lock:
            served, warm = self.served, sorted(map(list, self.warm_shapes))
        return {
            "status": "ok",
            "checkpoint": self.checkpoint,
            "device": str(self.device),
            "spatial_dims": cfg.spatial_dims,
            "filters": list(cfg.filters),
            "num_res_units": cfg.num_res_units,
            "crop": self.crop,
            "served": served,
            "warm_shapes": warm,
        }

    def segment(self, volume: Volume, crop: Optional[bool] = None) -> np.ndarray:
        """(D, H, W) label map for one scan; serialized on the device."""
        with self._lock:
            labels = predict_scan(
                self.model, self.config, volume, self.device,
                crop=self.crop if crop is None else crop,
                patch_size=self.patch_size, overlap=self.overlap,
            )
            with self._stats_lock:
                self.served += 1
                self.warm_shapes.add(tuple(volume.as_numpy()[0].shape))
            return labels

    def warmup(self, shape: Tuple[int, int, int]) -> float:
        """Run one (D, H, W)-shaped blank scan through; returns seconds."""
        t0 = time.perf_counter()
        self.segment(Volume(np.zeros((1,) + tuple(shape), np.float32)))
        with self._stats_lock:
            self.served -= 1  # warmup is not a served request
        return time.perf_counter() - t0


def _nrrd_from_bytes(payload: bytes) -> Volume:
    with tempfile.NamedTemporaryFile(suffix=".nrrd") as f:
        f.write(payload)
        f.flush()
        return Volume.from_nrrd(f.name)


def _nrrd_to_bytes(labels: np.ndarray, header: Optional[Dict]) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        write_artifacts(Path(d), labels, header, structures=False)
        return (Path(d) / "segmentation.nrrd").read_bytes()


def make_handler(service: SegmentationService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj: Dict) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):  # noqa: N802 (http.server API)
            if urlparse(self.path).path == "/healthz":
                self._json(200, service.info())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/segment":
                self._json(404, {"error": f"no route {url.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    raise ValueError("empty body (expected NRRD bytes)")
                volume = _nrrd_from_bytes(self.rfile.read(length))
            except Exception as e:  # noqa: BLE001 — client error
                self._json(400, {"error": str(e)})
                return
            try:
                q = parse_qs(url.query)
                crop = None
                if "crop" in q:
                    crop = q["crop"][0] not in ("0", "false")
                labels = service.segment(volume, crop=crop)
                if q.get("counts", ["0"])[0] in ("1", "true"):
                    counts = np.bincount(labels.ravel(), minlength=NUM_CLASSES)
                    self._json(200, {
                        "voxel_counts": {
                            s: int(n) for s, n in zip(STRUCTURES, counts[1:])
                        },
                        "shape": list(labels.shape),
                    })
                else:
                    self._reply(
                        200,
                        _nrrd_to_bytes(labels, volume.header),
                        "application/octet-stream",
                    )
            except Exception as e:  # noqa: BLE001 — server error
                self._json(500, {"error": str(e)})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(service: SegmentationService, host: str, port: int):
    """Build the HTTP server (call .serve_forever() on the result)."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv=None):
    parser = ArgumentParser(description="Serve a segmentation checkpoint")
    parser.add_argument(
        "--checkpoint", default=None,
        help="a port checkpoint or a reference Lightning .ckpt file",
    )
    add_released_args(parser)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--no_crop", action="store_true")
    parser.add_argument(
        "--warmup", type=int, nargs=3, default=None, metavar=("D", "H", "W"),
        help="run one blank scan of this shape before accepting traffic",
    )
    parser.add_argument("--patch_size", type=int, nargs=3,
                        default=(128, 128, 48), help="3D checkpoints only")
    parser.add_argument("--overlap", type=float, default=0.5,
                        help="3D checkpoints only")
    args = parser.parse_args(argv)

    service = SegmentationService(
        resolve_checkpoint_arg(args), device=args.device, crop=not args.no_crop,
        patch_size=tuple(args.patch_size), overlap=args.overlap,
    )
    if args.warmup:
        secs = service.warmup(tuple(args.warmup))
        print(f"warmup {tuple(args.warmup)}: {secs:.1f}s")
    server = serve(service, args.host, args.port)
    print(f"serving {service.checkpoint} on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
