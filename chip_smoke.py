#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure raises and the script exits non-zero):
  1. Card and build: name and power limit (nvidia-smi), TF32 off for every
     float32 conv and matmul, the CUDA kernels compiled from csrc/ with nvcc.
  2. K1, instance_norm_prelu, against its plain PyTorch version at Model L's
     IN+PReLU site shapes (batch 32), float32 and bfloat16, three alphas, one
     near-constant channel.
  3. K2, conv3x3_in_prelu, against its plain version at Model L's stride-1
     3x3 unit shapes (batch 32), float32 and bfloat16.
  4. Serve: full-width Model L (filters 64..1024, 2 residual units, 3 -> 10,
     float32, random weights from seed 0) saved as a port checkpoint, loaded
     by SegmentationService on the card behind the HTTP server; 3 synthetic
     120x512x512 scans POSTed as NRRD plus one ?counts=1 request. Every
     batch must launch K1 8 times and K2 9 times.
  5. Whole forward: the CUDA (kernel) path against a CPU copy of the model
     (plain path) on 2 transformed slices.

The line before the last lists each kernel's launches in phase 4, its
largest float32 error and its time per batch beside the plain version's;
the last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import http.client
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

DEVICE = "cuda"
BATCH = 32  # predict_scan's batch of slices
FILTERS = (64, 128, 256, 512, 1024)
SCAN = (120, 512, 512)  # (D, H, W) HU; crops to 80 x 280 x 280
# Model L's IN+PReLU sites at a 256x256 input: (H, W, C) -> sites per forward.
K1_SITES = {
    (128, 128, 64): 2,   # down0 unit0, up1 transposed conv
    (64, 64, 128): 2,    # down1 unit0, up2 transposed conv
    (32, 32, 256): 2,    # down2 unit0, up3 transposed conv
    (16, 16, 512): 1,    # down3 unit0
    (256, 256, 10): 1,   # up0 transposed conv
    (16, 16, 1024): 0,   # not a site; the widest channel count
}
# Its stride-1 3x3 Conv+IN+PReLU units: (H, W, Cin, Cout) -> sites.
K2_SITES = {
    (128, 128, 64, 64): 2,     # down0 unit1, up1 residual unit
    (64, 64, 128, 128): 2,     # down1 unit1, up2 residual unit
    (32, 32, 256, 256): 2,     # down2 unit1, up3 residual unit
    (16, 16, 512, 512): 1,     # down3 unit1
    (16, 16, 512, 1024): 1,    # bottom unit0
    (16, 16, 1024, 1024): 1,   # bottom unit1
}
ALPHAS = (0.25, -0.1, 0.0)
# Tolerances: |kernel - plain| <= atol + rtol * |plain|. float32 differs only
# in summation order (over H*W terms for K1, over 9*Cin products and H*W
# terms for K2); bfloat16 adds one rounding of the output (one bf16 ulp is
# at most 2^-7 of the value) on top of the float32 bound, both versions
# reading the same bfloat16 input.
TOL = {
    ("k1", "float32"): (1e-5, 1e-5),
    ("k1", "bfloat16"): (1e-5, 2.0 ** -7),
    ("k2", "float32"): (1e-4, 1e-4),
    ("k2", "bfloat16"): (1e-4, 2.0 ** -7),
}
LOGIT_TOL = 1e-3       # phase 5: |cuda - cpu| <= LOGIT_TOL * (1 + |cpu|)
MIN_AGREEMENT = 0.999  # phase 5: argmax agreement (random weights: near-ties)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, by CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name, kernel, plain, atol, rtol) -> float:
    import torch

    k, p = kernel.float(), plain.float()
    if not bool(torch.isfinite(k).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (k - p).abs()
    bad = err > atol + rtol * p.abs()
    if bool(bad.any()):
        i = int(torch.argmax((err - rtol * p.abs()).flatten()))
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements out of tolerance; worst "
            f"kernel {k.flatten()[i].item()!r} vs plain {p.flatten()[i].item()!r}"
        )
    return float(err.max())


def phase_k1(label, gen):
    import torch
    from ctseg_tpu_torch.ops.instance_norm import (
        instance_norm_prelu, instance_norm_prelu_plain,
    )

    worst = {"float32": 0.0, "bfloat16": 0.0}
    ms = plain_ms = 0.0
    for (h, w, c), sites in K1_SITES.items():
        x32 = torch.randn((BATCH, h, w, c), generator=gen, device=DEVICE)
        x32 = x32 * 1.5 + 0.5
        # channel 0 near-constant: the one-pass variance rounds to ~0 or
        # below, and the clamp must keep the output finite.
        x32[..., 0] = 3.0 + 1e-6 * x32[..., 0]
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            dname = str(dtype).split(".")[-1]
            atol, rtol = TOL[("k1", dname)]
            for a in ALPHAS:
                alpha = torch.full((1,), a, device=DEVICE)
                k = instance_norm_prelu(x, alpha)
                p = instance_norm_prelu_plain(x, alpha)
                tag = f"K1 {(BATCH, h, w, c)} {dname} alpha={a}"
                if not bool(torch.isfinite(k[..., 0]).all()):
                    raise AssertionError(f"{tag}: near-constant channel not finite")
                err = check_close(tag, k[..., 1:], p[..., 1:], atol, rtol)
                worst[dname] = max(worst[dname], err)
            alpha = torch.full((1,), 0.25, device=DEVICE)
            t_k = time_ms(lambda: instance_norm_prelu(x, alpha), 20)
            t_p = time_ms(lambda: instance_norm_prelu_plain(x, alpha), 20)
            print(f"[{label}] K1 {(BATCH, h, w, c)} {dname}: kernel {t_k:.4f} ms"
                  f", plain {t_p:.4f} ms, sites/forward {sites}")
            if dtype == torch.float32:
                ms += sites * t_k
                plain_ms += sites * t_p
    print(f"K1 max |kernel - plain|: float32 {worst['float32']:.3e}, "
          f"bfloat16 {worst['bfloat16']:.3e}")
    return worst, ms, plain_ms


def phase_k2(label, gen):
    import torch
    from ctseg_tpu_torch.ops.conv_block import (
        conv3x3_in_prelu, conv3x3_in_prelu_plain,
    )

    worst = {"float32": 0.0, "bfloat16": 0.0}
    ms = plain_ms = 0.0
    for (h, w, cin, cout), sites in K2_SITES.items():
        x32 = torch.randn((BATCH, h, w, cin), generator=gen, device=DEVICE)
        bound = 1.0 / (9 * cin) ** 0.5  # torch-default init scale
        w32 = (torch.rand((3, 3, cin, cout), generator=gen, device=DEVICE)
               * 2 - 1) * bound
        b = (torch.rand((cout,), generator=gen, device=DEVICE) * 2 - 1) * bound
        for dtype in (torch.float32, torch.bfloat16):
            x, wt = x32.to(dtype), w32.to(dtype)
            dname = str(dtype).split(".")[-1]
            atol, rtol = TOL[("k2", dname)]
            for a in (0.25, -0.1):
                alpha = torch.full((1,), a, device=DEVICE)
                k = conv3x3_in_prelu(x, wt, b, alpha)
                p = conv3x3_in_prelu_plain(x, wt, b, alpha)
                tag = f"K2 {(BATCH, h, w, cin, cout)} {dname} alpha={a}"
                worst[dname] = max(worst[dname], check_close(tag, k, p, atol, rtol))
            t_k = time_ms(lambda: conv3x3_in_prelu(x, wt, b, alpha), 5)
            t_p = time_ms(lambda: conv3x3_in_prelu_plain(x, wt, b, alpha), 5)
            gflop = 2 * 9 * cin * cout * h * w * BATCH / 1e9
            print(f"[{label}] K2 {(BATCH, h, w, cin, cout)} {dname}: kernel "
                  f"{t_k:.3f} ms ({gflop / t_k:.2f} TFLOP/s), plain {t_p:.3f} ms"
                  f" ({gflop / t_p:.2f} TFLOP/s), sites/forward {sites}")
            if dtype == torch.float32:
                ms += sites * t_k
                plain_ms += sites * t_p
    print(f"K2 max |kernel - plain|: float32 {worst['float32']:.3e}, "
          f"bfloat16 {worst['bfloat16']:.3e}")
    return worst, ms, plain_ms


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_serve(label, workdir: Path):
    import torch
    from ctseg_tpu_torch.constants import NUM_CLASSES
    from ctseg_tpu_torch.inference.serve import SegmentationService, serve
    from ctseg_tpu_torch.ops.conv_block import conv3x3_in_prelu
    from ctseg_tpu_torch.ops.instance_norm import instance_norm_prelu
    from ctseg_tpu_torch.testing.synth import make_patient
    from ctseg_tpu_torch.training.config import (
        TrainConfig, build_model, save_checkpoint,
    )
    from ctseg_tpu_torch.utils import nrrd_io
    from ctseg_tpu_torch.utils.miccai import CropBox, Volume

    cfg = TrainConfig(filters=FILTERS, num_res_units=2, transform_degree=2)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = workdir / "model_l.ckpt"
    save_checkpoint(ckpt, cfg, model)
    del model
    print(f"Model L: {n_params} parameters, checkpoint {ckpt.stat().st_size} bytes")

    t0 = time.perf_counter()
    scans = [make_patient(workdir / f"0522c{i:04d}", shape=SCAN, seed=i,
                          with_landmarks=False) for i in range(3)]
    print(f"made {len(scans)} scans of {SCAN} in {time.perf_counter() - t0:.1f} s")
    bodies = [(s / "img.nrrd").read_bytes() for s in scans]

    service = SegmentationService(str(ckpt), device=DEVICE)
    print(f"warmup {SCAN}: {service.warmup(SCAN):.3f} s")
    httpd = serve(service, "127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        status, payload = _request(port, "GET", "/healthz")
        info = json.loads(payload)
        if status != 200 or info["status"] != "ok" or info["device"] != DEVICE:
            raise AssertionError(f"/healthz answered {status}: {info}")

        d = SCAN[0]
        box = CropBox.anatomical(d)
        n_slices = box.z[1] - box.z[0]
        batches_per_scan = -(-n_slices // BATCH)

        instance_norm_prelu.launches = 0
        conv3x3_in_prelu.launches = 0
        served = []
        for i, body in enumerate(bodies):
            t0 = time.perf_counter()
            status, payload = _request(port, "POST", "/segment", body)
            lat = time.perf_counter() - t0
            if status != 200:
                raise AssertionError(f"/segment answered {status}: {payload[:500]!r}")
            out = workdir / f"seg{i}.nrrd"
            out.write_bytes(payload)
            labels, _ = nrrd_io.read(out)
            if labels.shape != (SCAN[1], SCAN[2], SCAN[0]) or labels.dtype != np.uint8:
                raise AssertionError(f"segmentation {labels.shape} {labels.dtype}")
            if int(labels.max()) >= NUM_CLASSES:
                raise AssertionError(f"label {int(labels.max())} out of 0..9")
            served.append(labels)
            print(f"[{label}] request {i}: {lat:.3f} s for {n_slices} cropped "
                  f"slices of 280x280 ({n_slices / lat:.1f} slices/s), "
                  f"{len(body)} bytes in")
        t0 = time.perf_counter()
        status, payload = _request(port, "POST", "/segment?counts=1", bodies[0])
        lat = time.perf_counter() - t0
        counts = json.loads(payload)
        if status != 200 or counts["shape"] != list(SCAN):
            raise AssertionError(f"?counts=1 answered {status}: {counts}")
        # The same scan again: cuDNN's convs need not be bitwise
        # deterministic, so an argmax near-tie may flip; allow 0.1%.
        direct = np.bincount(served[0].ravel(), minlength=NUM_CLASSES)[1:]
        moved = int(np.abs(
            np.asarray(list(counts["voxel_counts"].values())) - direct
        ).sum())
        if moved > 1e-3 * n_slices * 280 * 280:
            raise AssertionError(
                f"?counts=1 disagrees with the served map by {moved} voxels"
            )
        print(f"[{label}] request 3 (?counts=1): {lat:.3f} s "
              f"({n_slices / lat:.1f} slices/s); structure voxel counts "
              f"differ from request 0's by {moved}")
        launches = {"k1": instance_norm_prelu.launches,
                    "k2": conv3x3_in_prelu.launches}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)

    batches = 4 * batches_per_scan
    if launches != {"k1": 8 * batches, "k2": 9 * batches}:
        raise AssertionError(
            f"kernel launches {launches} for {batches} batches; want 8 and 9 "
            "per batch"
        )
    print(f"launches over {batches} batches: {launches}")

    # Where a request's time goes: the model alone on one full batch.
    x = torch.randn((BATCH, 3, 256, 256), device=DEVICE)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        fwd = time_ms(lambda: service.model(x), 3)
    t0 = time.perf_counter()
    vol = Volume.from_nrrd(scans[0] / "img.nrrd")
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    service.segment(vol)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    print(f"[{label}] model forward, batch {BATCH} at 256x256: {fwd:.3f} ms; "
          f"segment() one scan without HTTP: {seg_s:.3f} s; NRRD read "
          f"{read_s:.3f} s")
    return service, ckpt, scans[0], launches


def phase_forward(label, service, ckpt, scan):
    import torch
    from ctseg_tpu_torch.ops.conv_block import conv3x3_in_prelu
    from ctseg_tpu_torch.ops.instance_norm import instance_norm_prelu
    from ctseg_tpu_torch.training.config import load_checkpoint
    from ctseg_tpu_torch.transforms.pipelines import get_transform
    from ctseg_tpu_torch.utils.miccai import CropBox, Volume

    data = Volume.from_nrrd(scan / "img.nrrd").as_numpy()[0]
    region = CropBox.anatomical(data.shape[0]).apply(data[None])[0]
    mid = region.shape[0] // 2
    slices = torch.from_numpy(np.asarray(region[mid : mid + 2], np.float32))
    imgs, _ = get_transform(2, train=False)(slices)
    x = imgs.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    _, cpu_model = load_checkpoint(ckpt, "cpu")
    with torch.inference_mode():
        ref = cpu_model(x)
        k1, k2 = instance_norm_prelu.launches, conv3x3_in_prelu.launches
        out = service.model(x.to(DEVICE)).cpu()
    if (instance_norm_prelu.launches - k1, conv3x3_in_prelu.launches - k2) != (8, 9):
        raise AssertionError("the CUDA forward did not run 8 K1 and 9 K2 launches")
    err = (out - ref).abs()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("CUDA logits are not finite")
    if bool((err > LOGIT_TOL * (1 + ref.abs())).any()):
        raise AssertionError(f"logits differ by up to {float(err.max()):.3e}")
    agree = float((out.argmax(1) == ref.argmax(1)).float().mean())
    if agree < MIN_AGREEMENT:
        raise AssertionError(f"labels agree on {agree:.5f} of pixels")
    print(f"[{label}] whole forward, CUDA kernels vs CPU plain (2 slices, f32): "
          f"max |logit diff| {float(err.max()):.3e} (|logits| up to "
          f"{float(ref.abs().max()):.3f}), label agreement {agree:.6f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels run only on a CUDA card", file=sys.stderr)
        return 1
    from ctseg_tpu_torch.ops import _build

    label = card_label()
    print(label)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"kernels: nvcc {lib.build_seconds:.1f} s, ready in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip().removeprefix("ptxas info    :").strip())

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    k1_err, k1_ms, k1_plain = phase_k1(label, gen)
    k2_err, k2_ms, k2_plain = phase_k2(label, gen)
    with tempfile.TemporaryDirectory() as tmp:
        service, ckpt, scan, launches = phase_serve(label, Path(tmp))
        phase_forward(label, service, ckpt, scan)

    kernels = [
        {"name": "instance_norm_prelu", "route": "cuda",
         "source": "ctseg_tpu_torch/csrc/instance_norm.cu",
         "replaces": "ctseg_tpu/ops/pallas/instance_norm.py:254",
         "launches": launches["k1"], "max_abs_err": k1_err["float32"],
         "max_abs_err_bf16": k1_err["bfloat16"],
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "conv3x3_in_prelu", "route": "cuda",
         "source": "ctseg_tpu_torch/csrc/conv_block.cu",
         "replaces": "ctseg_tpu/ops/pallas/conv_block.py:146",
         "launches": launches["k2"], "max_abs_err": k2_err["float32"],
         "max_abs_err_bf16": k2_err["bfloat16"],
         "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print("(ms, plain_ms: float32 device time of one batch-32 forward's "
          "sites, kernel vs plain version; max_abs_err: float32)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
