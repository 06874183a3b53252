#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and evaluation paths once on one
NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure raises and the script exits non-zero):
  1. Card and build: name and power limit (nvidia-smi), TF32 off for every
     float32 conv and matmul, the CUDA kernels compiled from csrc/ with nvcc.
  2. K1, instance_norm_prelu, against its plain PyTorch version at Model L's
     IN+PReLU site shapes (batch 32), float32 and bfloat16, three alphas, one
     near-constant channel; two runs on one input torch.equal; faster than
     the plain version at every site; per site its share of its bytes' bound
     and the time of F.instance_norm alone (a yardstick the port never
     calls); the float32 and bfloat16 totals.
  3. K2, conv3x3_in_prelu, against its plain version at Model L's stride-1
     3x3 unit shapes (batch 32), float32 and bfloat16: every site on the
     tensor-core route, two runs on one input torch.equal; per site the
     float32 kernel's and the plain version's largest error against a
     float64 conv + norm of the same inputs, and the time of the conv alone
     through F.conv2d (cuDNN; float32 with TF32 off, and bfloat16) as a
     yardstick the port never calls there.
  4. Serve: full-width Model L (filters 64..1024, 2 residual units, 3 -> 10,
     float32, random weights from seed 0) saved as a port checkpoint, loaded
     by SegmentationService on the card behind the HTTP server; 3 synthetic
     120x512x512 scans POSTed as NRRD plus one ?counts=1 request. Every
     batch must launch K1 8 times and K2 9 times.
  5. Whole forward: the CUDA (kernel) path against a CPU copy of the model
     (plain path) on 2 transformed slices.
  6. K1b, instance_norm_prelu_bwd, and K1's training forward (mean, var)
     against their plain versions at the train step's IN+PReLU site shapes
     (phase 2's at batch 128), float32 and bfloat16, three alphas, the
     near-constant channel included.
  7. K2b, in_prelu_bwd, and K2's training forward (xhat, rsinv) against
     their plain versions at the train step's unit shapes (phase 3's at
     batch 128), float32 and bfloat16.
  8. K4, window_normalize_degree2, against its plain version on 128 raw
     280x280 HU slices with draws covering all 8 (k, flip) pairs, to 256,
     200 and 201 (ragged tiles), with identity draws, and at every float32
     value of the windows' span (its quotients come from reciprocals):
     bit-equal; NaN where a draw leaves the slice; its time with every draw
     at k in {0, 2} and at k in {1, 3}.
  9. Train, float32: full-width Model L (2 residual units, degree 2,
     Focal+Dice with exclude_missing, batch 128) on a synthetic
     PackedDataset2D of 2x128 slices of 280x280 (as bench.py makes it):
     Trainer.fit for one epoch with a validation pipeline, then 2 warm-up
     and 5 timed train_steps. Each step must launch K4 once, K1 and K1b 8
     times, K2 and K2b 9 times; the loss must be finite and fall over 5
     steps on one fixed batch (fixed draws). The trained state is saved
     with training/checkpoint.py and SegmentationService serves one scan
     from it. Then the step's parts, each alone (CUDA events), and its
     device time by group of kernels (torch.profiler; phase 14 as well).
 10. Train, bfloat16: the same model from compute_dtype="bfloat16", 2 steps:
     float32 parameters, finite loss, the same launches.
 11. Gradient parity: one float32 step of the full-width model on 2 slices,
     CUDA kernels against a CPU copy on the plain path from the same
     weights and draws (and a float64 CPU copy as the referee).
 12. K5, min_plus, against its plain version, torch.equal required: on
     random maps with entries, rows and whole maps at BIG at the Model M
     train step's shape (2,304 maps of 256x256, scale 1), at the
     evaluation's (1,152 maps, one scale per map from 0.3-3.0) and at a K
     that is no multiple of the kernel's row group; on the step's own maps
     (the row scan of both signs of the class masks of 128 label maps); on
     one evaluation batch's (the row scan of the inverted surfaces, with
     spacings); and on maps where no pair can be pruned.
 13. The distance-map paths made of kernels (csrc/edt.cu's row scan and
     signed map around K5) against the plain compositions run on the card,
     torch.equal required: signed_distance_maps_from_labels on 128 label
     maps (uint8, int32, int64; a missing class, an empty slice), 3D signed
     maps, edt_squared with one spacing per slice at the evaluation's shape
     and in 3D; each of the two kernels against its plain version, the
     scan also at widths of 37, 255, 264, 1000 and 24576 (element by element,
     and the segment loop), on an unaligned map and for every label type.
 14. Train Model M, float32: full width (PRESETS["model_m"]: 1 residual
     unit, degree 2, weighted mixup, Boundary+Dice+Focal with
     exclude_missing, batch 128) on phase 9's synthetic split: Trainer.fit
     for one epoch with validation, then 2 warm-up and 5 timed train_steps
     on one fixed batch with fixed draws. Each step must launch K4 once, K1
     and K1b 8 times, K2 and K2b 4 times and the row scan, K5 and the signed
     map once each; the loss must be finite and fall. The step's parts are
     timed one by one.
 15. Evaluate: the trained Model M checkpoint through evaluate_2d with HD95
     on 300 slices of 280x280 with per-slice spacings (batches of 64, the
     last one padded): the row scan and K5 once per batch; the device HD95
     of 4 slices held to the scipy host path at 1e-4 relative; slices/s with
     and without HD95; HD95's device time by part on one batch.

No main path (serve, Model L, Model M, evaluation) may launch K2's FP32-pipe
route: its count is asserted to be 0 after each.

The line before the last lists each kernel's launches on its main path
(phase 9's timed Model L steps; K5's and the EDT kernels' are phase 14's
Model M steps; the other paths' counts stand beside them), its largest
float32 error, its time beside the plain version's and the least time the
card could take (see site_bounds), for K1, K1b, K2 and K2b also in
bfloat16, and for K1 and K2 the library's time for the norm and the conv
alone; the last line is {"ok": true, "device": {...}}. Imports
nothing of JAX.
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
    (5, 7, 3): 0,        # not a site; K1b one element a lane (105 elements)
    (4, 4, 1030): 0,     # not a site; K1b two-phase with 3 column tiles
}
# Its stride-1 3x3 Conv+IN+PReLU units: (H, W, Cin, Cout) -> sites.
K2_SITES = {
    (128, 128, 64, 64): 2,     # down0 unit1, up1 residual unit
    (64, 64, 128, 128): 2,     # down1 unit1, up2 residual unit
    (32, 32, 256, 256): 2,     # down2 unit1, up3 residual unit
    (16, 16, 512, 512): 1,     # down3 unit1
    (16, 16, 512, 1024): 1,    # bottom unit0
    (16, 16, 1024, 1024): 1,   # bottom unit1
    # Not sites: ragged last pixel tiles (240 and 63 pixels), Cin below a
    # pipeline step, Cout no multiple of the channel tile.
    (20, 12, 24, 40): 0,
    (7, 9, 8, 136): 0,
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
# Backward kernels (phases 6-7), |kernel - plain| <= atol + rtol * |plain|.
# dx and dy: float32 differs in the order of the two per-channel sums over
# H*W terms (mean(gh), mean(gh * xhat)) and nvcc's multiply-add contraction;
# bfloat16 adds one rounding of the output. dx's atol is scaled by
# rsqrt(var + eps) where that exceeds 1 (K1's near-constant channel). dalpha
# is one sum over up to 128*128*128*64 terms in another order: bounded
# relative to the sum of the terms' magnitudes, sum |g * min(xhat, 0)|.
BWD_TOL = {
    "float32": (1e-5, 1e-4),
    "bfloat16": (1e-5, 2.0 ** -7),
}
DALPHA_RTOL = 1e-5
TRAIN_BATCH = 128
RAW = 280              # bench.py's raw slice size (post-crop)
SIZE = 256             # the model's input size
TIMED_STEPS = 5
# Phase 11 (see phase_grad_parity for what each bound holds). Measured on
# the H100: conv weights 2e-4 to 2.7e-3 of their norm from float64 (the CPU
# float32 path up to 2.9e-3), slopes 1.4e-7 to 1.2e-6 of
# sum |g*min(xhat,0)| (the CPU float32 path up to 1e-5).
GRAD_RTOL = 1e-3        # whole gradient, and IN-cancelled biases, vs CPU f32
GRAD_PARAM_RTOL = 1e-2  # each conv weight or bias vs float64, of its norm
GRAD_SLOPE_RTOL = 1e-4  # each PReLU slope vs float64, of sum |g*min(xhat,0)|
HD95_RTOL = 1e-4        # phase 15: device HD95 vs scipy, float32 distances
EVAL_BATCH = 64
EVAL_SLICES = 300       # 4 full batches and one padded
# The H100's published peaks (SXM, dense): float32 outside the tensor cores,
# TF32 and bfloat16 on them, and HBM3. A kernel's bound is the larger of its
# operations over the peak of the unit its contract allows and its bytes
# (every input read once, every output written once) over the last.
PEAK_FLOPS = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def bound_ms(ops: float, nbytes: float, peak: float = PEAK_FLOPS):
    """(least milliseconds the card could take, what bounds it)."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def site_bounds():
    """The bound of each kernel over the sites of its main path.
    Operations per element, counted from the formulas: K1 8 (two running
    sums, normalise, PReLU), K1b 14 (xhat again, gh, three sums, dx), K2
    2 * 9 * Cin per output element for the conv and 8 for the norm, K2b 12,
    K4 15 per output pixel (3 windows of clip, shift, two divisions).

    The peak is that of the unit the kernel's contract allows. K2 in
    float32 keeps float32 products by the split-TF32 scheme, three
    tensor-core products for each one of the conv: its bound ("k2") is the
    larger of 3 x the conv's operations over 495 TFLOP/s (plus the norm's
    over 67) and its bytes over 3.35 TB/s; "k2_fp32_pipes" is the bound of
    the same work on the FP32 pipes (67 TFLOP/s), which the kernel was held
    to before it used the tensor cores. K2 in bfloat16 ("k2_bf16"): the
    conv's operations over 989 TFLOP/s, or its bytes at 2 bytes an element
    of x, w and the output. The other kernels compute on the FP32 pipes;
    "k1_bf16", "k1b_bf16" and "k2b_bf16" count 2 bytes an element."""
    out = {}
    for key, n in (("k1", BATCH), ("k1b", TRAIN_BATCH)):
        ops = elems = 0
        for (h, w, c), sites in K1_SITES.items():
            e = n * h * w * c * sites
            ops += (8 if key == "k1" else 14) * e
            elems += (2 if key == "k1" else 3) * e
        out[key] = bound_ms(ops, 4 * elems)
        out[key + "_bf16"] = bound_ms(ops, 2 * elems)
    for key, n in (("k2", BATCH), ("k2b", TRAIN_BATCH)):
        conv_ops = norm_ops = elems = 0
        for (h, w, cin, cout), sites in K2_SITES.items():
            e = n * h * w * cout * sites
            if key == "k2":
                conv_ops += 2 * 9 * cin * e
                norm_ops += 8 * e
                elems += e + sites * (n * h * w * cin + 9 * cin * cout)
            else:
                norm_ops += 12 * e
                elems += 3 * e
        out[key] = bound_ms(conv_ops + norm_ops, 4 * elems)
        if key == "k2b":
            out["k2b_bf16"] = bound_ms(norm_ops, 2 * elems)
        if key == "k2":
            out["k2_fp32_pipes"] = out["k2"]
            # The norm's operations run beside the tensor cores' on the
            # FP32 pipes; converted to the time they take there.
            tf32 = 3 * conv_ops + norm_ops * (PEAK_TF32 / PEAK_FLOPS)
            out["k2"] = bound_ms(tf32, 4 * elems, PEAK_TF32)
            bf16 = conv_ops + norm_ops * (PEAK_BF16 / PEAK_FLOPS)
            out["k2_bf16"] = bound_ms(bf16, 2 * elems, PEAK_BF16)
    pixels = TRAIN_BATCH * 256 * 256
    # K4: the 256x256 crop read once and the output written once.
    out["k4"] = bound_ms(15 * pixels, 4 * (pixels + 3 * pixels))
    return out


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, by CUDA events after a warm-up.
    The card first spins for some 15 ms while the host queues the calls, so
    that a short kernel's time holds none of the host's launch time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(30_000_000)  # cycles
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
    import torch.nn.functional as F
    from ctseg_tpu_torch.ops import instance_norm as k1
    from ctseg_tpu_torch.ops.instance_norm import (
        instance_norm_prelu, instance_norm_prelu_plain,
    )

    names = ("float32", "bfloat16")
    worst = dict.fromkeys(names, 0.0)
    ms = dict.fromkeys(names, 0.0)
    plain_ms = dict.fromkeys(names, 0.0)
    lib_ms = dict.fromkeys(names, 0.0)
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
            # No atomics, fixed-order sums: the kernel repeats itself bit
            # for bit.
            if not torch.equal(k, instance_norm_prelu(x, alpha)):
                raise AssertionError(f"{tag}: two runs on one input differ")
            alpha = torch.full((1,), 0.25, device=DEVICE)
            t_k = time_ms(lambda: instance_norm_prelu(x, alpha), 20)
            t_p = time_ms(lambda: instance_norm_prelu_plain(x, alpha), 20)
            # The library's InstanceNorm alone (no PReLU), on the NCHW view
            # of the same channels_last memory: a yardstick the port never
            # calls.
            xc = x.permute(0, 3, 1, 2)
            t_l = time_ms(lambda: F.instance_norm(xc), 20)
            plan = k1.fwd_cluster_plan(BATCH, h * w, c, x.element_size())
            form = "two-phase" if plan is None else (
                f"read-once in clusters of {plan['size']}, tiles of "
                f"{plan['wcc']} vectors")
            site_bound = 2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
            print(f"[{label}] K1 {(BATCH, h, w, c)} {dname}: kernel {t_k:.4f} ms"
                  f", plain {t_p:.4f} ms, F.instance_norm alone {t_l:.4f} ms, "
                  f"its bytes' bound {site_bound:.4f} ms ({site_bound / t_k:.2f}"
                  f" of the kernel's time), {form}, sites/forward {sites}")
            if sites and not t_k < t_p:
                raise AssertionError(f"{tag}: the kernel ({t_k:.4f} ms) is no "
                                     f"faster than its plain version ({t_p:.4f})")
            ms[dname] += sites * t_k
            plain_ms[dname] += sites * t_p
            lib_ms[dname] += sites * t_l
    bounds = site_bounds()
    print(f"K1 max |kernel - plain|: float32 {worst['float32']:.3e}, "
          f"bfloat16 {worst['bfloat16']:.3e}; per forward at batch {BATCH}: "
          f"float32 kernel {ms['float32']:.4f} ms, its bytes' bound "
          f"{bounds['k1'][0]:.4f}, plain {plain_ms['float32']:.4f}, "
          f"F.instance_norm alone {lib_ms['float32']:.4f}; bfloat16 kernel "
          f"{ms['bfloat16']:.4f} ms, bound {bounds['k1_bf16'][0]:.4f}, plain "
          f"{plain_ms['bfloat16']:.4f}, F.instance_norm alone "
          f"{lib_ms['bfloat16']:.4f}")
    return worst, ms, plain_ms, lib_ms


def _conv_norm_f64(x, wt, b, alpha):
    """conv3x3 + two-pass InstanceNorm + PReLU in float64 on the card, from
    the stored values: the referee of phase 3."""
    import torch
    import torch.nn.functional as F

    y = F.conv2d(x.double().permute(0, 3, 1, 2),
                 wt.double().permute(3, 2, 0, 1), b.double(), padding=1)
    mean = y.mean(dim=(2, 3), keepdim=True)
    var = torch.square(y - mean).mean(dim=(2, 3), keepdim=True)
    xhat = (y - mean) * torch.rsqrt(var + 1e-5)
    return torch.where(xhat >= 0, xhat, float(alpha) * xhat).permute(0, 2, 3, 1)


def phase_k2(label, gen):
    import torch
    import torch.nn.functional as F
    from ctseg_tpu_torch.ops.conv_block import (
        conv3x3_in_prelu, conv3x3_in_prelu_plain, conv_route,
    )

    worst = {"float32": 0.0, "bfloat16": 0.0}
    ms = {"float32": 0.0, "bfloat16": 0.0}
    plain_ms = {"float32": 0.0, "bfloat16": 0.0}
    lib_ms = {"float32": 0.0, "bfloat16": 0.0}
    worst64 = {"kernel": 0.0, "plain": 0.0}
    conv3x3_in_prelu.launches_simt = 0
    for (h, w, cin, cout), sites in K2_SITES.items():
        if conv_route(cin, cout, h, w) != "tc":
            raise AssertionError(f"K2 site {(h, w, cin, cout)} is not on the "
                                 "tensor-core route")
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
            # No atomics, fixed-order sums: the kernel repeats itself bit
            # for bit.
            if not torch.equal(k, conv3x3_in_prelu(x, wt, b, alpha)):
                raise AssertionError(f"{tag}: two runs on one input differ")
            if dtype == torch.float32:
                ref = _conv_norm_f64(x, wt, b, a)
                e_k = float((k.double() - ref).abs().max())
                e_p = float((p.double() - ref).abs().max())
                worst64 = {"kernel": max(worst64["kernel"], e_k),
                           "plain": max(worst64["plain"], e_p)}
                print(f"[{label}] K2 {(BATCH, h, w, cin, cout)} float32 max "
                      f"error against float64: kernel (split TF32) {e_k:.3e},"
                      f" plain (cuDNN FP32) {e_p:.3e}")
                del ref
            t_k = time_ms(lambda: conv3x3_in_prelu(x, wt, b, alpha), 5)
            t_p = time_ms(lambda: conv3x3_in_prelu_plain(x, wt, b, alpha), 5)
            # The library's conv alone, on the layout cuDNN likes best.
            xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
            wc = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            bc = b.to(dtype)
            t_l = time_ms(lambda: F.conv2d(xc, wc, bc, padding=1), 5)
            gflop = 2 * 9 * cin * cout * h * w * BATCH / 1e9
            print(f"[{label}] K2 {(BATCH, h, w, cin, cout)} {dname}: kernel "
                  f"{t_k:.3f} ms ({gflop / t_k:.2f} TFLOP/s), plain {t_p:.3f} ms"
                  f" ({gflop / t_p:.2f} TFLOP/s), F.conv2d alone {t_l:.3f} ms "
                  f"({gflop / t_l:.2f} TFLOP/s), sites/forward {sites}")
            ms[dname] += sites * t_k
            plain_ms[dname] += sites * t_p
            lib_ms[dname] += sites * t_l
    if conv3x3_in_prelu.launches_simt != 0:
        raise AssertionError("a K2 site took the FP32-pipe route")
    print(f"K2 max |kernel - plain|: float32 {worst['float32']:.3e}, "
          f"bfloat16 {worst['bfloat16']:.3e}; float32 against float64: kernel "
          f"{worst64['kernel']:.3e}, plain {worst64['plain']:.3e}; per forward "
          f"at batch {BATCH}: float32 kernel {ms['float32']:.3f} ms, plain "
          f"{plain_ms['float32']:.3f}, F.conv2d alone {lib_ms['float32']:.3f};"
          f" bfloat16 kernel {ms['bfloat16']:.3f} ms, plain "
          f"{plain_ms['bfloat16']:.3f}, F.conv2d alone {lib_ms['bfloat16']:.3f}")
    return worst, ms, plain_ms, lib_ms, worst64


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
        conv3x3_in_prelu.launches_simt = 0
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
        if conv3x3_in_prelu.launches_simt != 0:
            raise AssertionError(
                f"serving took K2's FP32-pipe route "
                f"{conv3x3_in_prelu.launches_simt} times")
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
    if conv3x3_in_prelu.launches_simt != 0:
        raise AssertionError("the CUDA forward took K2's FP32-pipe route")
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


def _k1_input(gen, shape):
    import torch

    x = torch.randn(shape, generator=gen, device=DEVICE) * 1.5 + 0.5
    x[..., 0] = 3.0 + 1e-6 * x[..., 0]  # near-constant channel
    return x


def check_dalpha(name, kernel, plain, bound_terms) -> float:
    """dalpha within DALPHA_RTOL of the magnitude of its summands."""
    err = abs(float(kernel) - float(plain))
    bound = 1e-5 + DALPHA_RTOL * float(bound_terms)
    if not err <= bound:
        raise AssertionError(f"{name}: dalpha {float(kernel)!r} vs plain "
                             f"{float(plain)!r}, bound {bound:.3e}")
    return err


def phase_k1b(label, gen):
    """K1b and K1's training forward at the train step's shapes (batch
    TRAIN_BATCH), where phase 9 launches them."""
    import torch
    from ctseg_tpu_torch.ops import instance_norm as k1

    n = TRAIN_BATCH
    worst = {"float32": 0.0, "bfloat16": 0.0}
    ms = {"float32": 0.0, "bfloat16": 0.0}
    plain_ms = {"float32": 0.0, "bfloat16": 0.0}
    for (h, w, c), sites in K1_SITES.items():
        x32 = _k1_input(gen, (n, h, w, c))
        g32 = torch.randn((n, h, w, c), generator=gen, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            x, g = x32.to(dtype), g32.to(dtype)
            dname = str(dtype).split(".")[-1]
            atol, rtol = BWD_TOL[dname]
            tag = f"K1b {(n, h, w, c)} {dname}"
            alpha = torch.full((1,), 0.25, device=DEVICE)
            # The training forward's statistics: one-pass, like the plain's.
            y, mean, var = k1._forward(x, alpha, train=True)
            _, pmean, pvar = k1._fwd_plain(x, alpha)
            check_close(f"{tag} mean", mean, pmean, 1e-5, 1e-5)
            check_close(f"{tag} var", var[:, 1:], pvar[:, 1:], 1e-5, 1e-4)
            # Channel 0's variance is the rounding noise of E[x^2] - E[x]^2
            # with E[x^2] about 9: bounded relative to E[x^2].
            check_close(f"{tag} var (channel 0)", var[:, 0], pvar[:, 0],
                        1e-5 + 1e-4 * (pvar[:, 0] + pmean[:, 0] ** 2), 0.0)
            check_close(f"{tag} y", y[..., 1:],
                        k1.instance_norm_prelu_plain(x, alpha)[..., 1:],
                        *TOL[("k1", dname)])
            # Channel 0's y scales that noise by rsqrt(var + eps): held to
            # the plain formula on the kernel's own statistics.
            xh0 = (x[..., 0].float() - mean[:, None, None, 0]) * torch.rsqrt(
                var[:, None, None, 0] + k1.EPS)
            check_close(f"{tag} y (channel 0)", y[..., 0],
                        torch.where(xh0 >= 0, xh0, 0.25 * xh0).to(dtype),
                        *TOL[("k1", dname)])
            # dx = rsqrt(var + eps) * (terms of the order of g), so its
            # absolute error scales with rsqrt(var + eps): about 316 on the
            # near-constant channel, which keeps its branch (sign(x - mean)
            # is one subtraction on both sides).
            dx_atol = atol * torch.clamp_min(
                torch.rsqrt(pvar + k1.EPS), 1.0)[:, None, None, :]
            for a in ALPHAS:
                alpha = torch.full((1,), a, device=DEVICE)
                dx, da = k1.instance_norm_prelu_bwd(x, g, pmean, pvar, alpha)
                pdx, pda = k1.instance_norm_prelu_bwd_plain(
                    x, g, pmean, pvar, alpha)
                err = check_close(f"{tag} alpha={a} dx", dx, pdx, dx_atol, rtol)
                xhat = (x.float() - pmean[:, None, None]) * torch.rsqrt(
                    pvar[:, None, None] + k1.EPS)
                terms = (g.float() * torch.clamp_max(xhat, 0.0)).abs().sum()
                check_dalpha(f"{tag} alpha={a}", da, pda, terms)
                worst[dname] = max(worst[dname], err)
            # Fixed-order sums, no atomics: a second call repeats both.
            dx2, da2 = k1.instance_norm_prelu_bwd(x, g, pmean, pvar, alpha)
            if not (torch.equal(da, da2) and torch.equal(dx, dx2)):
                raise AssertionError(f"{tag}: two calls on one input differ")
            del dx2
            plan = k1.bwd_cluster_plan(n, h * w, c, x.element_size())
            form = "two-phase" if plan is None else \
                f"read-once in clusters of {plan['size']}"
            plan = plan or k1.bwd_plan(n, h * w, c, x.element_size())
            t_k = time_ms(lambda: k1.instance_norm_prelu_bwd(
                x, g, pmean, pvar, alpha), 20)
            t_p = time_ms(lambda: k1.instance_norm_prelu_bwd_plain(
                x, g, pmean, pvar, alpha), 20)
            site_bound = 3 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
            print(f"[{label}] K1b {(n, h, w, c)} {dname}: kernel "
                  f"{t_k:.4f} ms, plain {t_p:.4f} ms, its bytes' bound "
                  f"{site_bound:.4f} ms ({site_bound / t_k:.2f} of the "
                  f"kernel's time), {form}, grid {plan['grid']}, "
                  f"{plan['vec']} elements a lane, sites/step {sites}")
            ms[dname] += sites * t_k
            plain_ms[dname] += sites * t_p
    print(f"K1b max |kernel - plain| (dx): float32 {worst['float32']:.3e}, "
          f"bfloat16 {worst['bfloat16']:.3e}; per step at batch {n}: float32 "
          f"kernel {ms['float32']:.3f} ms, plain {plain_ms['float32']:.3f} ms;"
          f" bfloat16 kernel {ms['bfloat16']:.3f} ms, plain "
          f"{plain_ms['bfloat16']:.3f} ms")
    return worst, ms, plain_ms


def phase_k2b(label, gen):
    """K2b and K2's training forward at the train step's shapes (batch
    TRAIN_BATCH), where phase 9 launches them."""
    import torch
    from ctseg_tpu_torch.ops import conv_block as k2

    n = TRAIN_BATCH
    worst = {"float32": 0.0, "bfloat16": 0.0}
    ms = {"float32": 0.0, "bfloat16": 0.0}
    plain_ms = {"float32": 0.0, "bfloat16": 0.0}
    for (h, w, cin, cout), sites in K2_SITES.items():
        g32 = torch.randn((n, h, w, cout), generator=gen, device=DEVICE)
        xh32 = torch.randn((n, h, w, cout), generator=gen, device=DEVICE)
        rsinv = torch.rand((n, cout), generator=gen, device=DEVICE) + 0.5
        for dtype in (torch.float32, torch.bfloat16):
            g, xhat = g32.to(dtype), xh32.to(dtype)
            dname = str(dtype).split(".")[-1]
            atol, rtol = BWD_TOL[dname]
            tag = f"K2b {(n, h, w, cin, cout)} {dname}"
            for a in ALPHAS:
                alpha = torch.full((1,), a, device=DEVICE)
                dy, da = k2.in_prelu_bwd(g, xhat, rsinv, alpha)
                pdy, pda = k2.in_prelu_bwd_plain(g, xhat, rsinv, alpha)
                err = check_close(f"{tag} alpha={a} dy", dy, pdy, atol, rtol)
                terms = (g.float() * torch.clamp_max(xhat.float(), 0.0)).abs().sum()
                check_dalpha(f"{tag} alpha={a}", da, pda, terms)
                worst[dname] = max(worst[dname], err)
            t_k = time_ms(lambda: k2.in_prelu_bwd(g, xhat, rsinv, alpha), 20)
            t_p = time_ms(lambda: k2.in_prelu_bwd_plain(g, xhat, rsinv, alpha), 20)
            print(f"[{label}] K2b {(n, h, w, cin, cout)} {dname}: kernel "
                  f"{t_k:.4f} ms, plain {t_p:.4f} ms, sites/step {sites}")
            ms[dname] += sites * t_k
            plain_ms[dname] += sites * t_p
    # K2's training forward: xhat and rsinv beside out, against the plain's.
    for (h, w, cin, cout) in K2_SITES:
        x32 = torch.randn((n, h, w, cin), generator=gen, device=DEVICE)
        bound = 1.0 / (9 * cin) ** 0.5
        w32 = (torch.rand((3, 3, cin, cout), generator=gen, device=DEVICE)
               * 2 - 1) * bound
        b = (torch.rand((cout,), generator=gen, device=DEVICE) * 2 - 1) * bound
        alpha = torch.full((1,), 0.25, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            x, wt = x32.to(dtype), w32.to(dtype)
            dname = str(dtype).split(".")[-1]
            out, xhat, rsinv = k2._forward(x, wt, b, alpha, train=True)
            pout, pxhat, prsinv = k2._fwd_plain(x, wt, b, alpha)
            tag = f"K2 train forward {(n, h, w, cin, cout)} {dname}"
            check_close(f"{tag} out", out, pout, *TOL[("k2", dname)])
            check_close(f"{tag} xhat", xhat, pxhat, *TOL[("k2", dname)])
            check_close(f"{tag} rsinv", rsinv, prsinv, 1e-5, 1e-4)
            del out, xhat, pout, pxhat
    print(f"K2b max |kernel - plain| (dy): float32 {worst['float32']:.3e}, "
          f"bfloat16 {worst['bfloat16']:.3e}; per step at batch {n}: float32 "
          f"kernel {ms['float32']:.3f} ms, plain {plain_ms['float32']:.3f} ms; "
          f"bfloat16 kernel {ms['bfloat16']:.3f} ms, plain "
          f"{plain_ms['bfloat16']:.3f} ms; K2's training "
          f"forward (out, xhat, rsinv) matched at every site, batch {n}")
    return worst, ms, plain_ms


def phase_k4(label, gen):
    import torch
    from ctseg_tpu_torch.ops import preprocess as k4
    from ctseg_tpu_torch.transforms.augment import Degree2Draws

    n, size = TRAIN_BATCH, 256
    images = torch.randn((n, RAW, RAW), generator=gen, device=DEVICE) * 600 + 100
    i = torch.arange(n, device=DEVICE, dtype=torch.int32)

    def draws(k, size):
        return Degree2Draws(
            top=torch.randint(0, RAW - size + 1, (n,), generator=gen,
                              device=DEVICE, dtype=torch.int32),
            left=torch.randint(0, RAW - size + 1, (n,), generator=gen,
                               device=DEVICE, dtype=torch.int32),
            k=k.to(torch.int32), flip=(i // 4) % 2)

    def same(what, kernel, plain):
        diff = (kernel - plain).abs()
        if not torch.equal(kernel, plain):
            raise AssertionError(
                f"K4 {what} differs from its plain version at "
                f"{int((diff > 0).sum())} values, by up to {float(diff.max())!r}")
        return float(diff.max())

    every = draws(i % 4, size)  # all 8 (k, flip) pairs
    out = k4.window_normalize_degree2(images, every, size)
    plain = k4.window_normalize_degree2_plain(images, every, size)
    if out.shape != (n, size, size, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"K4 output {tuple(out.shape)} not finite")
    err = same("over all 8 (k, flip) pairs", out, plain)
    # Ragged tiles: S no multiple of the tile (whole float4 rows), and S no
    # multiple of 4 (float by float).
    for s in (200, 201):
        d = draws(i % 4, s)
        err = max(err, same(f"to {s}", k4.window_normalize_degree2(images, d, s),
                            k4.window_normalize_degree2_plain(images, d, s)))
    # Identity draws: fused_window_normalize's function, exactly.
    sub = images[:, :size, :size].contiguous()
    ident = k4.identity_draws(n, DEVICE)
    same("with identity draws", k4.window_normalize_degree2(sub, ident, size),
         k4.window_normalize_degree2_plain(sub, ident, size))
    # A draw outside the slice (5 rows below it, 3 columns left of it): NaN
    # exactly where the plain version reads a slice padded with NaN.
    outside = Degree2Draws(torch.full_like(i, RAW - size + 5),
                           torch.full_like(i, -3), i % 4, (i // 4) % 2)
    padded = torch.full((n, RAW + 5, RAW + 3), float("nan"), device=DEVICE)
    padded[:, :RAW, 3:] = images
    got = k4.window_normalize_degree2(images, outside, size)
    want = k4.window_normalize_degree2_plain(
        padded, outside._replace(left=outside.left + 3), size)
    nan = torch.isnan(want)
    if not (torch.equal(torch.isnan(got), nan) and bool(nan.any())
            and torch.equal(got[~nan], want[~nan])):
        raise AssertionError("K4: a draw outside the slice must give NaN "
                             "exactly at the pixels it reaches out to")
    checked = _k4_every_value(k4)
    even = draws(2 * (i % 2), size)  # k in {0, 2}
    odd = draws(1 + 2 * (i % 2), size)  # k in {1, 3}
    t_k = time_ms(lambda: k4.window_normalize_degree2(images, every, size), 20)
    t_02 = time_ms(lambda: k4.window_normalize_degree2(images, even, size), 20)
    t_13 = time_ms(lambda: k4.window_normalize_degree2(images, odd, size), 20)
    t_p = time_ms(lambda: k4.window_normalize_degree2_plain(images, every,
                                                            size), 20)
    bound = site_bounds()["k4"][0]
    print(f"[{label}] K4 ({n}, {RAW}, {RAW}) -> ({n}, {size}, {size}, 3), "
          f"tiles of {k4.TILE}: bit-equal to its plain version over all 8 "
          f"(k, flip) pairs, to 200 and 201, with identity draws (max |diff| "
          f"{err!r}), and at all {checked} float32 values of the windows' "
          f"span; NaN where a draw leaves the slice; kernel {t_k:.4f} ms "
          f"(k in {{0, 2}} {t_02:.4f}, k in {{1, 3}} {t_13:.4f}), plain "
          f"{t_p:.4f} ms, bound {bound:.4f} ms by the crop's bytes "
          f"({bound / t_k:.2f} of the kernel's time)")
    return err, t_k, t_p, t_02, t_13


def _k4_every_value(k4) -> int:
    """K4 against its plain version at every float32 value from the lowest
    window's bottom to the highest one's top (outside it every window
    clamps), and at the infinities, a NaN and 0: its quotients are correctly
    rounded for every input, not only for the phase's. Returns the count."""
    import torch

    params = k4._params(torch.device(DEVICE))
    lo, hi = float(params[:, 0].min()), float(params[:, 1].max())
    bits = lambda v: int(np.array(v, np.float32).view(np.int32))  # noqa: E731
    # Bit patterns grow with the magnitude: [+0, hi] and [-0, lo].
    spans = [(0, bits(hi)), (bits(-0.0), bits(lo))]
    size, per = 256, 2048  # slices of 256x256, 2^27 values a launch
    checked = 0
    for first, last in spans:
        for start in range(first, last + 1, per * size * size):
            stop = min(start + per * size * size, last + 1)
            v = torch.arange(start, stop, dtype=torch.int64, device=DEVICE)
            v = v.to(torch.int32).view(torch.float32)
            pad = -len(v) % (size * size)
            v = torch.cat([v, torch.tensor(
                [float("inf"), float("-inf"), float("nan"), 0.0] * (pad // 4)
                + [0.0] * (pad % 4), device=DEVICE)])
            images = v.reshape(-1, size, size)
            ident = k4.identity_draws(images.shape[0], DEVICE)
            got = k4.window_normalize_degree2(images, ident, size)
            want = k4.window_normalize_degree2_plain(images, ident, size)
            same = (got == want) | (torch.isnan(got) & torch.isnan(want))
            if not bool(same.all()):
                at = int(torch.nonzero(~same.all(-1).flatten())[0])
                raise AssertionError(
                    f"K4 differs from its plain version at input "
                    f"{float(images.flatten()[at])!r}: "
                    f"{got.reshape(-1, 3)[at].tolist()} vs "
                    f"{want.reshape(-1, 3)[at].tolist()}")
            checked += stop - start
            del v, images, got, want, same
    return checked


def _synthetic_split(seed, n):
    """bench.py's synthetic split: HU ~ N(40, 300), labels 0..9, 0/1
    indicators."""
    from ctseg_tpu_torch.data.datasets import PackedDataset2D

    rng = np.random.default_rng(seed)
    return PackedDataset2D(
        images=rng.normal(40, 300, size=(n, RAW, RAW)).astype(np.float32),
        labels=rng.integers(0, 10, size=(n, RAW, RAW)).astype(np.uint8),
        indicators=rng.integers(0, 2, size=(n, 9)).astype(np.float32),
    )


def _model_l_config(dtype="float32"):
    from ctseg_tpu_torch.training.config import TrainConfig

    return TrainConfig(filters=FILTERS, num_res_units=2, transform_degree=2,
                       batch_size=TRAIN_BATCH, loss_fx=("Focal", "Dice"),
                       exclude_missing=True, epochs=1, compute_dtype=dtype)


def _counters():
    from ctseg_tpu_torch.ops import (
        conv_block, edt, instance_norm, min_plus, preprocess,
    )

    return {
        "scan": edt.row_scan,
        "signed": edt.signed_map,
        "k4": preprocess.window_normalize_degree2,
        "k1": instance_norm.instance_norm_prelu,
        "k1b": instance_norm.instance_norm_prelu_bwd,
        "k2": conv_block.conv3x3_in_prelu,
        "k2b": conv_block.in_prelu_bwd,
        "k5": min_plus.min_plus,
    }


def reset_launches():
    for fn in _counters().values():
        fn.launches = 0
    _counters()["k2"].launches_simt = 0


def read_launches():
    """Each kernel's launches since reset_launches. Raises if any K2 launch
    took the FP32-pipe route: no main path may."""
    k2 = _counters()["k2"]
    if k2.launches_simt != 0:
        raise AssertionError(f"{k2.launches_simt} of {k2.launches} K2 "
                             "launches took the FP32-pipe route")
    return {k: fn.launches for k, fn in _counters().items()}


PER_STEP = {"k4": 1, "k1": 8, "k1b": 8, "k2": 9, "k2b": 9, "k5": 0,
            "scan": 0, "signed": 0}
# Model M: 1 residual unit leaves 4 stride-1 units (the bottom's and the 3
# non-top decoder levels'); one launch each of the row scan, K5 and the
# signed-map kernel makes both signs of all 128 x 9 distance maps.
PER_STEP_M = {"k4": 1, "k1": 8, "k1b": 8, "k2": 4, "k2b": 4, "k5": 1,
              "scan": 1, "signed": 1}


# Kernel-name fragments -> the group a train step's device time is summed
# under (first match wins).
KERNEL_GROUPS = (
    ("conv3x3_wgmma_kernel", "K2 conv"),
    ("prepare_weights_kernel", "K2 weights, statistics and apply"),
    ("conv_stats_finalize_kernel", "K2 weights, statistics and apply"),
    ("in_prelu_apply_kernel", "K2 weights, statistics and apply"),
    ("in_prelu_bwd_saved_kernel", "K2b"),
    ("in_prelu_bwd_", "K1b"),
    ("in_prelu_fwd_", "K1"),
    ("window_normalize_kernel", "K4"),
    ("min_plus_kernel", "K5"),
    ("row_scan_kernel", "EDT row scan"),
    ("signed_map_kernel", "EDT signed map"),
    ("dgrad", "library conv dgrad"),
    ("wgrad", "library conv wgrad"),
    ("fft", "library FFT convs"),
    ("nchwToNhwc", "library layout transposes"),
    ("nhwcToNchw", "library layout transposes"),
    ("scatter", "scatter_add (Dice counts)"),
)


def profile_step(label, what, step, steps=2):
    """Device time of `step()` by group of kernels, from torch.profiler's
    kernel events (the host-side operator events carry the same time again
    and are left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    groups, others = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / steps
        name = next((g for frag, g in KERNEL_GROUPS if frag in e.key),
                    "other library and torch kernels")
        t, n = groups.get(name, (0.0, 0))
        groups[name] = (t + ms, n + e.count / steps)
        if name.startswith("other"):
            others.append((ms, e.key[:60]))
    total = sum(t for t, _ in groups.values())
    if total == 0.0:
        print(f"[{label}] {what} by kernel: the trace holds no device time")
        return
    rows = sorted(groups.items(), key=lambda kv: -kv[1][0])
    print(f"[{label}] {what} by kernel (torch.profiler, {steps} steps), ms a "
          f"step (launches): "
          + "; ".join(f"{k} {t:.3f} ({n:g})" for k, (t, n) in rows)
          + f"; all kernels {total:.3f}; the largest of the others: "
          + ", ".join(f"{k} {t:.3f}" for t, k in sorted(others)[:-5:-1]))


def phase_train(label, workdir: Path, scan: Path):
    import torch
    from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
    from ctseg_tpu_torch.inference.serve import SegmentationService
    from ctseg_tpu_torch.training.trainer import Trainer
    from ctseg_tpu_torch.transforms.augment import draw_degree2
    from ctseg_tpu_torch.utils.miccai import Volume

    trainer = Trainer(_model_l_config(), DEVICE)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    train = DevicePipeline2D(_synthetic_split(0, 2 * TRAIN_BATCH),
                             TRAIN_BATCH, DEVICE)
    val = DevicePipeline2D(_synthetic_split(1, TRAIN_BATCH), TRAIN_BATCH,
                           DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.fit(state, train, val, epochs=1)
    torch.cuda.synchronize()
    print(f"[{label}] Trainer.fit, 1 epoch (2 train steps + validation of "
          f"{TRAIN_BATCH} slices), first steps included: "
          f"{time.perf_counter() - t0:.3f} s; steps {state.step}, plateau "
          f"{tuple(state.plateau)}")

    batch = next(train.epoch(torch.Generator(device=DEVICE).manual_seed(2)))
    draws = draw_degree2(torch.Generator(device=DEVICE).manual_seed(3),
                         TRAIN_BATCH, RAW, RAW, 256)
    for _ in range(2):  # warm-up
        state, metrics = trainer.train_step(state, batch, draws)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TIMED_STEPS):
        state, metrics = trainer.train_step(state, batch, draws)
        losses.append(metrics["loss/total"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * TIMED_STEPS for k, v in PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"launches {launches} over {TIMED_STEPS} steps; "
                             f"want {want}")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss over {TIMED_STEPS} steps on one batch: "
                             f"{losses}")
    print(f"[{label}] train step, Model L float32 batch {TRAIN_BATCH}: "
          f"{step_s * 1e3:.3f} ms/step, {TRAIN_BATCH / step_s:.2f} slices/s "
          f"(host clock over {TIMED_STEPS} steps after 2 warm-ups); peak "
          f"device memory {peak / 2**30:.3f} GiB since the fit began; "
          f"losses {[round(v, 5) for v in losses]}; launches {launches}")

    ckpt_path = workdir / "trained.ckpt"
    trainer.save(ckpt_path, state)
    service = SegmentationService(str(ckpt_path), device=DEVICE)
    labels = service.segment(Volume.from_nrrd(scan / "img.nrrd"))
    if labels.shape != SCAN or labels.dtype != np.uint8 or labels.max() > 9:
        raise AssertionError(f"served {labels.shape} {labels.dtype}")
    print(f"[{label}] the trained checkpoint ({ckpt_path.stat().st_size} "
          f"bytes) served one {SCAN} scan")

    # The step's parts, each alone (CUDA events, mean of 5 after a warm-up).
    model = state.model.train()
    images, labels = trainer.train_transform(batch[0], batch[1], draws)
    with torch.no_grad():
        logits = trainer._logits(model, images)

    def forward_no_grad():
        with torch.no_grad():
            trainer._logits(model, images)

    def forward_losses_backward():
        values, _ = trainer._losses_and_logits(model, images, labels, batch[2])
        state.optimizer.zero_grad(set_to_none=True)
        trainer.loss.total(values).backward()

    timed = {
        "transform (K4 + the labels' moves)": lambda: trainer.train_transform(
            batch[0], batch[1], draws),
        "forward alone, no_grad": forward_no_grad,
        "forward, losses and backward": forward_losses_backward,
        "Dice": lambda: trainer.dice(
            trainer._predictions(logits, batch[2]), labels),
        "Adam (foreach)": state.optimizer.step,  # on the gradients left above
    }
    phases = {name: time_ms(fn, 5) for name, fn in timed.items()}
    rest = step_s * 1e3 - sum(
        v for k, v in phases.items() if k != "forward alone, no_grad")
    print(f"[{label}] Model L step by part, ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"; the {step_s * 1e3:.3f} ms step less the transform, the "
          f"forward, losses and backward, the Dice and Adam: {rest:.3f}")
    profile_step(label, "Model L train step",
                 lambda: trainer.train_step(state, batch, draws))
    return trainer, state, batch, draws, launches, step_s


def phase_train_bf16(label, batch, draws):
    import torch
    from ctseg_tpu_torch.training.trainer import Trainer

    trainer = Trainer(_model_l_config("bfloat16"), DEVICE)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    reset_launches()
    losses = []
    for _ in range(2):
        state, metrics = trainer.train_step(state, batch, draws)
        losses.append(float(metrics["loss/total"]))
    launches = read_launches()
    dtypes = {p.dtype for p in state.model.parameters()}
    if dtypes != {torch.float32}:
        raise AssertionError(f"bf16 model has parameters of {dtypes}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bf16 losses {losses}")
    if launches != {k: 2 * v for k, v in PER_STEP.items()}:
        raise AssertionError(f"bf16 launches {launches} over 2 steps")
    print(f"[{label}] bfloat16 compute: 2 steps, float32 parameters, losses "
          f"{losses}, launches {launches}")


def _grads(trainer, model, batch, draws):
    import torch

    images, labels = trainer.train_transform(*batch[:2], draws)
    model.zero_grad(set_to_none=True)
    values, _ = trainer._losses_and_logits(model, images, labels, batch[2])
    trainer.loss.total(values).backward()
    return {k: p.grad.detach().to("cpu", torch.float64)
            for k, p in model.named_parameters()}


def _grads_and_slope_terms(trainer, model, batch, draws):
    """_grads on the CPU plain path, and for each PReLU slope the sum of
    the magnitudes of the terms its gradient adds up, sum |g * min(xhat, 0)|
    over the slope's site: the plain backwards are wrapped for one backward
    pass to read g and xhat there."""
    import torch
    from ctseg_tpu_torch.ops import conv_block as k2
    from ctseg_tpu_torch.ops import instance_norm as k1

    terms = {}  # the slope parameter's data_ptr -> sum of |terms|

    def record(alpha, g, xhat):
        t = float((g * torch.clamp_max(xhat, 0.0)).abs().sum())
        terms[alpha.data_ptr()] = terms.get(alpha.data_ptr(), 0.0) + t

    def k1_bwd(x, g, mean, var, alpha):
        stat = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        record(alpha, g, (x - mean.reshape(stat)) * torch.rsqrt(
            var.reshape(stat) + k1.EPS))
        return k1_plain(x, g, mean, var, alpha)

    def k2_bwd(g, xhat, rsinv, alpha):
        record(alpha, g, xhat)
        return k2_plain(g, xhat, rsinv, alpha)

    k1_plain, k2_plain = k1.instance_norm_prelu_bwd_plain, k2.in_prelu_bwd_plain
    k1.instance_norm_prelu_bwd_plain, k2.in_prelu_bwd_plain = k1_bwd, k2_bwd
    try:
        grads = _grads(trainer, model, batch, draws)
    finally:
        k1.instance_norm_prelu_bwd_plain, k2.in_prelu_bwd_plain = (
            k1_plain, k2_plain)
    slopes = {k: terms.get(p.data_ptr()) for k, p in model.named_parameters()
              if k.endswith("act.weight")}
    if None in slopes.values() or len(slopes) != len(terms):
        raise AssertionError(f"{len(terms)} IN+PReLU backwards recorded for "
                             f"{len(slopes)} slopes")
    return grads, slopes


def phase_grad_parity(label, trainer, state, batch, draws):
    import copy
    import dataclasses

    import torch
    from ctseg_tpu_torch.training.trainer import Trainer
    from ctseg_tpu_torch.transforms.augment import Degree2Draws

    two = tuple(t[:2] for t in batch)
    draws2 = Degree2Draws(*(t[:2] for t in draws))
    cpu_two = tuple(t.cpu() for t in two)
    cpu_draws = Degree2Draws(*(t.cpu() for t in draws2))
    g_cuda = _grads(trainer, state.model, two, draws2)
    g_cpu = _grads(Trainer(trainer.config, "cpu"),
                   copy.deepcopy(state.model).to("cpu"), cpu_two, cpu_draws)
    cfg64 = dataclasses.replace(trainer.config, compute_dtype="float64")
    model64 = copy.deepcopy(state.model).to("cpu", torch.float64)
    model64.compute_dtype = torch.float64
    g64, slope_terms = _grads_and_slope_terms(Trainer(cfg64, "cpu"), model64,
                                              cpu_two, cpu_draws)

    # Many of this model's float32 gradients are sums that nearly cancel
    # (cuDNN also picks FFT and Winograd convs, which round otherwise than
    # the CPU's), so each parameter is held to the float64 gradient by the
    # kind of its leaf:
    #   - a PReLU slope's gradient sums g * min(xhat, 0) over its site, and
    #     the sum nearly cancels (|g64| about 1e-5): its error is bounded,
    #     as phases 6-7's dalpha, relative to the sum of the terms'
    #     magnitudes (GRAD_SLOPE_RTOL);
    #   - conv weights and biases, and the shortcut convs', relative to
    #     their own norm (GRAD_PARAM_RTOL);
    #   - a conv bias that feeds an InstanceNorm has a zero gradient in
    #     exact arithmetic (the norm removes per-channel constants): its
    #     float32 gradient is rounding noise, held to the CPU float32 path
    #     relative to the unit's weight gradient (GRAD_RTOL).
    # The whole gradient is held to the CPU float32 path at GRAD_RTOL.
    # Every reading is printed before any bound is enforced.
    worst = {"slope": (0.0, ""), "param": (0.0, ""), "cancelled": (0.0, "")}
    worst_cpu32 = {"slope": 0.0, "param": 0.0}
    failures = []
    num = den = 0.0

    def note(kind, rel, name, bound):
        if rel > worst[kind][0]:
            worst[kind] = (rel, name)
        if not rel <= bound:
            failures.append(f"{name} ({kind}): {rel:.3e} > {bound:.0e}")

    for name, gc in g_cpu.items():
        prefix = name.rsplit(".", 2)[0]
        if name.endswith("conv.bias") and f"{prefix}.act.weight" in g_cpu:
            ref = float(g_cpu[f"{prefix}.conv.weight"].norm())
            note("cancelled", float((g_cuda[name] - gc).norm()) / ref, name,
                 GRAD_RTOL)
            continue
        num += float((g_cuda[name] - gc).norm()) ** 2
        den += float(gc.norm()) ** 2
        if name.endswith("act.weight"):
            kind, scale, bound = "slope", slope_terms[name], GRAD_SLOPE_RTOL
        else:
            kind, scale, bound = "param", float(g64[name].norm()), GRAD_PARAM_RTOL
        note(kind, float((g_cuda[name] - g64[name]).norm()) / scale, name, bound)
        worst_cpu32[kind] = max(worst_cpu32[kind],
                                float((gc - g64[name]).norm()) / scale)
    total = (num / den) ** 0.5
    if not total <= GRAD_RTOL:
        failures.append(f"whole gradient: {total:.3e} > {GRAD_RTOL:.0e}")
    print(f"[{label}] gradient parity, float32 Model L on 2 slices, CUDA "
          f"kernels vs CPU plain path from the same weights and draws: whole "
          f"gradient ||g_cuda - g_cpu|| / ||g_cpu|| {total:.3e} (bound "
          f"{GRAD_RTOL:.0e}); against float64, worst PReLU slope "
          f"|g_cuda - g64| / sum|g * min(xhat, 0)| {worst['slope'][0]:.3e} "
          f"({worst['slope'][1]}; CPU float32 path {worst_cpu32['slope']:.3e};"
          f" bound {GRAD_SLOPE_RTOL:.0e}), worst conv weight or bias "
          f"||g_cuda - g64|| / ||g64|| {worst['param'][0]:.3e} "
          f"({worst['param'][1]}; CPU float32 path {worst_cpu32['param']:.3e}"
          f"; bound {GRAD_PARAM_RTOL:.0e}); worst IN-cancelled bias "
          f"{worst['cancelled'][0]:.3e} of its weight's gradient norm "
          f"({worst['cancelled'][1]}; bound {GRAD_RTOL:.0e}); "
          f"{len(g_cpu)} parameters, {len(slope_terms)} slopes")
    if failures:
        raise AssertionError("gradient parity: " + "; ".join(failures))
    return total


def _k5_input(gen, b, k, l):
    """Squared distances as the EDT's first step leaves them: integers,
    with entries, one row and two whole maps at BIG."""
    import torch
    from ctseg_tpu_torch.ops.min_plus import BIG

    x = torch.floor(torch.rand((b, k, l), generator=gen, device=DEVICE) * 4000)
    hole = torch.rand((b, k, l), generator=gen, device=DEVICE) < 0.3
    x = torch.where(hole, torch.full_like(x, BIG), x)
    x[:, k // 3] = BIG
    x[0] = BIG
    x[b // 2] = BIG
    return x.contiguous()


def _eval_surfaces(seed):
    """The inverted surfaces and per-map spacings one evaluation batch hands
    to edt_squared: the structures of EVAL_BATCH slices of the evaluation's
    split as targets, the same shifted by (3, 5) pixels as predictions."""
    import torch
    from ctseg_tpu_torch.metrics.hd95 import _surface_device

    ds = _eval_split(seed, EVAL_BATCH)
    target = torch.from_numpy(ds.labels[:, :SIZE, :SIZE].copy()).to(DEVICE)
    pred = torch.roll(target, (3, 5), dims=(1, 2))
    classes = torch.arange(1, 10, device=DEVICE).reshape(9, 1, 1)
    ts = _surface_device(target.unsqueeze(1) == classes, 2)
    ps = _surface_device(pred.unsqueeze(1) == classes, 2)
    spacing = torch.from_numpy(ds.spacings).to(DEVICE).unsqueeze(1)
    return torch.logical_not(torch.stack([ts, ps])), spacing  # (2,64,9,H,W)


def _step_labels():
    """The 128 label maps of 256x256 of the Model M phase's timed steps: the
    same batch of the synthetic split, with the same degree-2 draws (crop,
    quarter turns, flip) applied."""
    import torch
    from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
    from ctseg_tpu_torch.transforms import augment

    train = DevicePipeline2D(_synthetic_split(0, 2 * TRAIN_BATCH), TRAIN_BATCH)
    batch = next(train.epoch(torch.Generator(device=DEVICE).manual_seed(2)))
    draws = augment.draw_degree2(
        torch.Generator(device=DEVICE).manual_seed(3), TRAIN_BATCH, RAW, RAW,
        SIZE)
    return augment.apply_degree2(batch[1], draws, SIZE).contiguous()


def phase_k5(label, gen):
    import torch
    from ctseg_tpu_torch.ops import edt
    from ctseg_tpu_torch.ops.min_plus import BIG, min_plus, min_plus_plain

    n_train = TRAIN_BATCH * 9 * 2  # both signs of every class mask of a step
    n_eval = EVAL_BATCH * 9 * 2    # both directions of every (slice, class)
    big = float(torch.tensor(BIG, dtype=torch.float32))
    ones = torch.ones(n_train, device=DEVICE)
    # The step's own maps: the row scan of both signs of the class masks.
    step_maps = edt.label_scan(_step_labels(), 10)[0].reshape(-1, SIZE, SIZE)
    # The evaluation's: the row scan of the inverted surfaces, each map with
    # its slice's spacings.
    surfaces, spacing = _eval_surfaces(5)
    sp = spacing.expand(2, EVAL_BATCH, 9, 2).reshape(-1, 2)
    eval_maps = edt.row_scan(surfaces.reshape(-1, SIZE, SIZE),
                             sp[:, 1].contiguous())
    # Nothing to prune: no value at BIG, no zero, and in every 32-column
    # tile one column that stays above the largest cost plus the smallest
    # value, so no walk ends early.
    dense = 1e6 + 10 * torch.rand((n_train, SIZE, SIZE), generator=gen,
                                  device=DEVICE)
    dense[:, :, 7::32] = 2e6
    cases = {
        # Random integers with entries, a row and two maps at BIG.
        "train": (_k5_input(gen, n_train, SIZE, SIZE), ones),
        "eval": (_k5_input(gen, n_eval, SIZE, SIZE), torch.rand(
            n_eval, generator=gen, device=DEVICE) * 2.7 + 0.3),
        "ragged": (_k5_input(gen, 37, 100, 70), torch.rand(
            37, generator=gen, device=DEVICE) * 2.7 + 0.3),
        "step maps": (step_maps, ones),
        "eval surfaces": (eval_maps, sp[:, 0].contiguous()),
        "unprunable": (dense, ones),
    }
    del step_maps, eval_maps, dense, surfaces
    times = {}
    for name in list(cases):
        x, scale = cases.pop(name)
        b, k, l = x.shape
        out = min_plus(x, scale)
        plain = min_plus_plain(x, scale)
        torch.cuda.synchronize()
        diff = (out - plain).abs()
        err = float(diff.max())
        if not torch.equal(out, plain):
            raise AssertionError(
                f"K5 {name} {(b, k, l)} differs from its plain version at "
                f"{int((diff > 0).sum())} values, by up to {float(diff.max())!r}")
        if name in ("train", "eval", "ragged") and (
                float(out.max()) != big or not bool((out[0] == big).all())):
            raise AssertionError(f"K5 {name}: an all-BIG map must stay at BIG")
        t_k = time_ms(lambda: min_plus(x, scale), 10)
        t_p = time_ms(lambda: min_plus_plain(x, scale), 1)
        # A pruned pass can beat the all-pairs operations count, so the
        # bound is the bytes; the all-pairs form's stands beside it.
        bound, by = bound_ms(0.0, 2 * 4.0 * b * k * l)
        all_pairs, _ = bound_ms(2.0 * b * k * k * l, 0.0)
        # The peak counts a multiply-add as 2 operations; a pair here is one
        # add and one min, 2 instructions, so the issue rate allows half.
        issue = 2.0 * b * k * k * l / (PEAK_FLOPS / 2) * 1e3
        times[name] = (t_k, t_p, bound, by, err, issue, all_pairs)
        print(f"[{label}] K5 {name} {(b, k, l)}: bit-equal to its plain "
              f"version (max |diff| {err!r}); kernel {t_k:.4f} ms, plain "
              f"{t_p:.3f} ms, bound {bound:.4f} ms by {by} ({bound / t_k:.2f} of"
              f" the kernel's time); all pairs would take {all_pairs:.4f} ms "
              f"at 2 operations a pair, {issue:.4f} ms at one instruction a "
              f"lane a cycle")
        del x, out, plain, diff
    return times


def phase_edt(label, gen):
    """The distance-map paths made of kernels (row scan, K5, signed map)
    against the plain compositions run on the card, torch.equal required,
    and the two kernels around K5 each against its plain version."""
    import torch
    from ctseg_tpu_torch.ops import edt

    def same(what, kernel, plain):
        """max |kernel - plain|, measured; anything but torch.equal raises."""
        torch.cuda.synchronize()
        diff = (kernel - plain).abs()
        if not torch.equal(kernel, plain):
            raise AssertionError(
                f"{what} differs from its plain version at "
                f"{int((diff > 0).sum())} values, by up to {float(diff.max())!r}")
        return float(diff.max())

    out = {}
    labels = _step_labels()
    n, e = TRAIN_BATCH, SIZE * SIZE
    for lab in (labels, labels.long(), labels.int()):
        same(f"signed_distance_maps_from_labels ({lab.dtype})",
             edt.signed_distance_maps_from_labels(lab),
             edt.signed_distance_maps_from_labels_plain(lab))
    # A class missing from a slice, an empty slice, a class filling rows.
    odd = labels.clone()
    odd[1][odd[1] == 3] = 0
    odd[2] = 0
    odd[3, 40:90] = 5
    same("signed_distance_maps_from_labels (missing and filling classes)",
         edt.signed_distance_maps_from_labels(odd),
         edt.signed_distance_maps_from_labels_plain(odd))
    vol = torch.rand((2, 3, 24, 20, 37), generator=gen, device=DEVICE) > 0.6
    vol[0, 1] = False
    same("signed_distance_map, 3D", edt.signed_distance_map(vol, 3),
         edt.signed_distance_map_plain(vol, 3))
    t_k = time_ms(lambda: edt.signed_distance_maps_from_labels(labels), 10)
    t_p = time_ms(lambda: edt.signed_distance_maps_from_labels_plain(labels), 3)
    print(f"[{label}] signed_distance_maps_from_labels, {n} label maps of "
          f"{SIZE}x{SIZE} (uint8, int32, int64; a missing class, an empty "
          f"slice; 3D masks): torch.equal to the plain composition; kernels "
          f"{t_k:.4f} ms, plain composition (K5 inside) {t_p:.3f} ms")
    out["maps"] = (t_k, t_p)

    surfaces, spacing = _eval_surfaces(6)
    same("edt_squared with per-sample spacings",
         edt.edt_squared(surfaces, spacing, 2),
         edt.edt_squared_plain(surfaces, spacing, 2))
    sp3 = torch.rand((2, 3, 3), generator=gen, device=DEVICE) * 2.7 + 0.3
    same("edt_squared, 3D with per-map spacings",
         edt.edt_squared(vol, sp3), edt.edt_squared_plain(vol, sp3))
    t_k = time_ms(lambda: edt.edt_squared(surfaces, spacing, 2), 10)
    t_p = time_ms(lambda: edt.edt_squared_plain(surfaces, spacing, 2), 3)
    print(f"[{label}] edt_squared of {tuple(surfaces.shape)} inverted "
          f"surfaces with one spacing per slice (and of 3D masks): "
          f"torch.equal to the plain composition; kernels {t_k:.4f} ms, "
          f"plain composition (K5 inside) {t_p:.3f} ms")
    out["edt_squared"] = (t_k, t_p)

    # The two kernels alone, at the Model M step's shape.
    d2, flags = edt.label_scan(labels, 10)
    pd2, pflags = edt.label_scan_plain(labels, 10)
    err = same("label_scan", d2, pd2)
    if not torch.equal(flags.bool(), pflags):
        raise AssertionError("label_scan's nonempty flags differ")
    masks = surfaces.reshape(-1, SIZE, SIZE)
    scale = spacing.expand(2, EVAL_BATCH, 9, 2).reshape(-1, 2)[:, 1].contiguous()
    err = max(err, same("row_scan", edt.row_scan(masks, scale),
                        edt.row_scan_plain(masks, scale)))
    # Rows the main path does not give: widths no multiple of 8 (element by
    # element), one segment and a few elements more, long rows (the segment
    # loop, up to MAX_W), an unaligned map; both modes, every label type; a
    # class missing, an empty map, a class filling rows, sparse sites and
    # sites only at the rows' ends (the carries between segments).
    shapes = ((16, 37), (16, 255), (12, 264), (4, 1000), (2, edt.MAX_W))
    for r, w in shapes + ((16, SIZE),):
        lab = torch.randint(0, 10, (6, r, w), generator=gen, device=DEVICE,
                            dtype=torch.uint8)
        lab[1][lab[1] == 3] = 0
        lab[2] = 0
        lab[3, :2] = 5
        lab[4] = torch.where(torch.rand((r, w), generator=gen, device=DEVICE)
                             < 0.002, 7, 0)
        lab[5] = 0
        lab[5, :, 0], lab[5, :, -1] = 8, 2
        mask = lab != 0
        if w == SIZE:  # unaligned: one byte into an allocation
            lab = torch.empty(lab.numel() + 1, dtype=torch.uint8,
                              device=DEVICE)[1:].view(lab.shape).copy_(lab)
            mask = torch.empty(mask.numel() + 1, dtype=torch.bool,
                               device=DEVICE)[1:].view(mask.shape).copy_(mask)
        for t in (lab, lab.int(), lab.long(), lab == 5):
            d, f = edt.label_scan(t, 10)
            pd, pf = edt.label_scan_plain(t, 10)
            err = max(err, same(f"label_scan {tuple(t.shape)} {t.dtype}", d,
                                pd))
            if not torch.equal(f.bool(), pf):
                raise AssertionError(f"label_scan {tuple(t.shape)}: flags")
        sc = torch.rand(6, generator=gen, device=DEVICE) * 2.7 + 0.3
        for m_scale in (None, sc):
            err = max(err, same(f"row_scan {tuple(mask.shape)}",
                                edt.row_scan(mask, m_scale),
                                edt.row_scan_plain(mask, m_scale)))
    # Rows of 8192 (the segment loop), as a 3D map's would be: timed only.
    long_rows = torch.randint(0, 10, (8, 32, 8192), generator=gen,
                              device=DEVICE, dtype=torch.uint8)
    t_long = time_ms(lambda: edt.label_scan(long_rows, 10), 10)
    bound_long = bound_ms(0.0, long_rows.numel() * (1 + 4.0 * 18))[0]
    del long_rows
    t_k = time_ms(lambda: edt.label_scan(labels, 10), 10)
    t_p = time_ms(lambda: edt.label_scan_plain(labels, 10), 3)
    t_ke = time_ms(lambda: edt.row_scan(masks, scale), 10)
    t_pe = time_ms(lambda: edt.row_scan_plain(masks, scale), 3)
    # Bytes: the labels (or the mask) read once, the distances written once.
    bound = bound_ms(0.0, labels.numel() * labels.element_size()
                     + 4.0 * d2.numel())
    bound_e = bound_ms(0.0, 5.0 * masks.numel())
    print(f"[{label}] EDT row scan: bit-equal to its plain version (max "
          f"|diff| {err!r}), also at widths {[w for _, w in shapes]}, "
          f"unaligned and for every label type; from "
          f"{n} label maps to {tuple(d2.shape)}: kernel {t_k:.4f} ms, plain "
          f"{t_p:.3f} ms, its bytes' bound {bound[0]:.4f} ms "
          f"({bound[0] / t_k:.2f} of the kernel's time); of "
          f"{tuple(masks.shape)} masks with spacings: kernel {t_ke:.4f} ms, "
          f"plain {t_pe:.3f} ms, bound {bound_e[0]:.4f} ms "
          f"({bound_e[0] / t_ke:.2f}); 8 label maps of 32 rows of 8192: "
          f"kernel {t_long:.4f} ms, bound {bound_long:.4f} ms "
          f"({bound_long / t_long:.2f})")
    out["scan"] = (t_k, t_p, bound, t_ke, t_pe, bound_e[0], err, t_long,
                   bound_long)

    d2 = edt._min_plus_passes(d2, 3, 2, None).reshape(2, n, 9, e)
    flat = labels.reshape(n, e)
    err = same("signed_map", edt.signed_map(d2, flat, flags),
               edt.signed_map_plain(d2, flat, flags))
    t_k = time_ms(lambda: edt.signed_map(d2, flat, flags), 10)
    t_p = time_ms(lambda: edt.signed_map_plain(d2, flat, flags), 3)
    bound = bound_ms(0.0, flat.numel() * flat.element_size()
                     + 4.0 * d2.numel() * 1.5)
    print(f"[{label}] EDT signed map {tuple(d2.shape)} -> {(n, 9, e)}: "
          f"bit-equal to its plain version (max |diff| {err!r}); kernel "
          f"{t_k:.4f} ms, plain {t_p:.3f} ms, its bytes' bound "
          f"{bound[0]:.4f} ms")
    out["signed"] = (t_k, t_p, bound, err)
    return out


def _model_m_config():
    import dataclasses

    from ctseg_tpu_torch.models.presets import PRESETS

    return dataclasses.replace(PRESETS["model_m"], epochs=1)


def phase_train_model_m(label, workdir: Path):
    import torch
    from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
    from ctseg_tpu_torch.training import mixup
    from ctseg_tpu_torch.training.trainer import Trainer
    from ctseg_tpu_torch.transforms.augment import draw_degree2

    cfg = _model_m_config()
    if (cfg.filters, cfg.batch_size, cfg.compute_dtype) != (
            FILTERS, TRAIN_BATCH, "float32"):
        raise AssertionError(f"Model M preset is {cfg}")
    trainer = Trainer(cfg)  # on the card by default
    state = trainer.init_state(torch.Generator().manual_seed(0))
    train = DevicePipeline2D(_synthetic_split(0, 2 * TRAIN_BATCH), TRAIN_BATCH)
    val = DevicePipeline2D(_synthetic_split(1, TRAIN_BATCH), TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.fit(state, train, val, epochs=1)
    torch.cuda.synchronize()
    print(f"[{label}] Model M Trainer.fit, 1 epoch (2 mixup steps + "
          f"validation of {TRAIN_BATCH} slices with the Boundary loss): "
          f"{time.perf_counter() - t0:.3f} s; steps {state.step}")

    batch = next(train.epoch(torch.Generator(device=DEVICE).manual_seed(2)))
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    draws = draw_degree2(gen, TRAIN_BATCH, RAW, RAW, SIZE)
    images, labels = trainer.train_transform(batch[0], batch[1], draws)
    mixup_draws = mixup.draw_mixup(gen, mixup.mixup_probability(labels),
                                   cfg.mixup_alpha)
    for _ in range(2):  # warm-up
        state, metrics = trainer.train_step(state, batch, draws,
                                            mixup_draws=mixup_draws)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TIMED_STEPS):
        state, metrics = trainer.train_step(state, batch, draws,
                                            mixup_draws=mixup_draws)
        losses.append(metrics["loss/total"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * TIMED_STEPS for k, v in PER_STEP_M.items()}
    if launches != want:
        raise AssertionError(f"Model M launches {launches} over {TIMED_STEPS} "
                             f"steps; want {want}")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"Model M loss over {TIMED_STEPS} steps on one "
                             f"batch: {losses}")
    parts = {k: round(float(v), 5) for k, v in metrics.items()
             if k.startswith("loss/")}
    print(f"[{label}] train step, Model M float32 batch {TRAIN_BATCH}: "
          f"{step_s * 1e3:.3f} ms/step, {TRAIN_BATCH / step_s:.2f} slices/s "
          f"(host clock over {TIMED_STEPS} steps after 2 warm-ups); peak "
          f"device memory {peak / 2**30:.3f} GiB since the fit began; "
          f"losses {[round(v, 5) for v in losses]}, the last step's {parts}; "
          f"launches {launches}")

    ckpt_path = workdir / "model_m.ckpt"
    trainer.save(ckpt_path, state)

    # The step's parts, each alone (CUDA events, mean of 5 after a warm-up).
    model = state.model.train()
    index, lam = mixup_draws
    mixed = mixup.mixup_tensors(images, images[index], lam)
    maps = trainer._dist_maps(labels)
    with torch.no_grad():
        logits = trainer._logits(model, mixed)

    def both_loss_sets():
        a = trainer.loss(logits, labels, batch[2], maps)
        b = trainer.loss(logits, labels[index], batch[2][index], maps[index])
        return trainer.loss.total(
            {k: mixup.mixup_tensors(a[k], b[k], lam) for k in a})

    def dice_twice():
        trainer.dice(trainer._predictions(logits, batch[2]), labels)
        trainer.dice(trainer._predictions(logits, batch[2][index]),
                     labels[index])

    def forward_no_grad():
        with torch.no_grad():
            trainer._logits(model, mixed)

    timed = {
        "transform (K4 + the labels' moves)": lambda: trainer.train_transform(
            batch[0], batch[1], draws),
        "mixup: probabilities, draw, mix": lambda: mixup.weighted_mixup(
            gen, images, labels, cfg.mixup_alpha),
        "signed distance maps (row scan, K5, signed map)":
            lambda: trainer._dist_maps(labels),
        "forward alone, no_grad": forward_no_grad,
        "both loss sets, forward only": both_loss_sets,
        "Dice of both target sets": dice_twice,
        "Adam (foreach)": state.optimizer.step,
    }
    phases = {name: time_ms(fn, 5) for name, fn in timed.items()}
    rest = step_s * 1e3 - sum(phases.values())
    print(f"[{label}] Model M step by part, ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"; the rest of the {step_s * 1e3:.3f} ms step (backward, the "
          f"losses' backward and what autograd saves in the forward) {rest:.3f}")

    profile_step(label, "Model M train step", lambda: trainer.train_step(
        state, batch, draws, mixup_draws=mixup_draws))
    return ckpt_path, launches, step_s


def _eval_split(seed, n):
    """Raw HU slices with rectangular structures (so the surfaces and their
    distances are those of compact shapes) and per-slice spacings."""
    from ctseg_tpu_torch.data.datasets import PackedDataset2D

    rng = np.random.default_rng(seed)
    labels = np.zeros((n, RAW, RAW), np.uint8)
    for i in range(n):
        for c in range(1, 10):
            if rng.random() < 0.15:
                continue
            y, x = rng.integers(10, RAW - 90, size=2)
            h, w = rng.integers(12, 80, size=2)
            labels[i, y:y + h, x:x + w] = c
    images = (rng.normal(40, 120, size=(n, RAW, RAW))
              + 60.0 * labels).astype(np.float32)
    indicators = np.stack([(labels == c).any(axis=(1, 2))
                           for c in range(1, 10)], axis=1).astype(np.float32)
    spacings = rng.uniform(0.5, 1.5, size=(n, 2)).astype(np.float32)
    return PackedDataset2D(images, labels, indicators, spacings=spacings)


def phase_evaluate(label, ckpt_path: Path):
    import torch
    from ctseg_tpu_torch.inference.evaluate import evaluate_2d, format_table
    from ctseg_tpu_torch.metrics.hd95 import (
        hd95_per_structure, hd95_per_structure_device,
    )
    from ctseg_tpu_torch.ops.min_plus import min_plus
    from ctseg_tpu_torch.training.trainer import Trainer

    trainer, state = Trainer.restore(ckpt_path)  # on the card by default
    dataset = _eval_split(5, EVAL_SLICES)
    batches = -(-EVAL_SLICES // EVAL_BATCH)
    evaluate_2d(trainer, state.model, dataset, EVAL_BATCH, with_hd95=True)
    reset_launches()
    result = evaluate_2d(trainer, state.model, dataset, EVAL_BATCH,
                         with_hd95=True)
    launches = read_launches()
    k5_launches = launches["k5"]
    want = {"k4": 0, "k1": 8 * batches, "k1b": 0, "k2": 4 * batches,
            "k2b": 0, "k5": batches, "scan": batches, "signed": 0}
    if launches != want:
        raise AssertionError(f"evaluate_2d launched {launches} over "
                             f"{batches} batches; want {want}")
    plain = evaluate_2d(trainer, state.model, dataset, EVAL_BATCH)
    if min_plus.launches != k5_launches:
        raise AssertionError("evaluate_2d without HD95 launched K5")
    if result["num_slices"] != EVAL_SLICES or result["hd95_unit"] != "mm":
        raise AssertionError(f"evaluate_2d reports {result}")
    # cuDNN's convs need not be bitwise deterministic, so an argmax near-tie
    # may flip between two runs (phase 4 allows the same 0.1%).
    moved = max(abs(result["per_structure_dice"][s] - v)
                for s, v in plain["per_structure_dice"].items())
    if moved > 1e-3:
        raise AssertionError(f"Dice differs by {moved:.3e} between the runs "
                             "with and without HD95")
    dice = list(result["per_structure_dice"].values())
    hd = [v for v in result["per_structure_hd95"].values() if v is not None]
    if not all(np.isfinite(dice)) or not hd or not all(np.isfinite(hd)):
        raise AssertionError(f"evaluate_2d values: {result}")
    print(format_table(result))
    share = 1.0 - result["slices_per_sec"] / plain["slices_per_sec"]
    print(f"[{label}] evaluate_2d, Model M float32, {EVAL_SLICES} slices of "
          f"{RAW}x{RAW} in batches of {EVAL_BATCH}: "
          f"{result['slices_per_sec']:.2f} slices/s with HD95 (mm), "
          f"{plain['slices_per_sec']:.2f} without: HD95 is {share:.3f} of "
          f"the time; K5 launches {k5_launches} over {batches} batches")

    # The device HD95 of 4 slices against the scipy host path, each slice
    # with its own spacing scaled to the model's grid.
    n = 4
    images, labels = trainer.test_transform(
        torch.from_numpy(dataset.images[:n]).to(DEVICE),
        torch.from_numpy(dataset.labels[:n]).to(DEVICE))
    x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        preds = trainer._predictions(
            state.model.eval()(x).float(),
            torch.from_numpy(dataset.indicators[:n]).to(DEVICE))
    spacing = dataset.spacings[:n] * np.float32(RAW / SIZE)
    value, valid = hd95_per_structure_device(
        preds, labels, spacing=torch.from_numpy(spacing).to(DEVICE))
    value, valid = value.cpu().numpy(), valid.cpu().numpy()
    preds, labels = preds.cpu().numpy(), labels.cpu().numpy()
    worst, held = 0.0, 0
    for i in range(n):
        host = hd95_per_structure(preds[i], labels[i], spacing=spacing[i])
        if not np.array_equal(valid[i], ~np.isnan(host)):
            raise AssertionError(f"slice {i}: valid {valid[i]} vs scipy {host}")
        rel = np.abs(value[i] - host)[valid[i]] / host[valid[i]]
        held += int(valid[i].sum())
        worst = max(worst, float(rel.max()) if rel.size else 0.0)
    if held < n or not worst <= HD95_RTOL:
        raise AssertionError(f"device HD95 vs scipy: {held} values, worst "
                             f"relative difference {worst:.3e}")
    print(f"[{label}] device HD95 vs scipy on {n} slices: {held} (slice, "
          f"structure) values, worst relative difference {worst:.3e} "
          f"(bound {HD95_RTOL:.0e})")
    _hd95_parts(label, trainer, state.model, dataset)
    return launches, result["slices_per_sec"]


def _hd95_parts(label, trainer, model, dataset):
    """HD95's device time by part on one evaluation batch (CUDA events,
    each part alone on the inputs the whole function gives it)."""
    import torch
    from ctseg_tpu_torch.metrics import hd95
    from ctseg_tpu_torch.ops import edt
    from ctseg_tpu_torch.ops.min_plus import min_plus

    n = EVAL_BATCH
    images, labels = trainer.test_transform(
        torch.from_numpy(dataset.images[:n]).to(DEVICE),
        torch.from_numpy(dataset.labels[:n]).to(DEVICE))
    x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        preds = trainer._predictions(
            model.eval()(x).float(),
            torch.from_numpy(dataset.indicators[:n]).to(DEVICE))
    spacing = torch.from_numpy(
        dataset.spacings[:n] * np.float32(RAW / SIZE)).to(DEVICE)
    classes = torch.arange(1, 10, device=DEVICE).reshape(9, 1, 1)

    def surfaces():
        return (hd95._surface_device(preds.unsqueeze(1) == classes, 2),
                hd95._surface_device(labels.unsqueeze(1) == classes, 2))

    ps, ts = surfaces()
    inverted = torch.logical_not(torch.stack([ts, ps]))
    masks = inverted.reshape(-1, SIZE, SIZE)
    sp = spacing[:, None].expand(2, n, 9, 2).reshape(-1, 2)
    col, row = sp[:, 1].contiguous(), sp[:, 0].contiguous()
    d2 = edt.row_scan(masks, col)
    done = min_plus(d2, row).reshape(2, n * 9, -1)
    flat_p, flat_t = ps.reshape(n * 9, -1), ts.reshape(n * 9, -1)
    parts = {
        "surfaces": surfaces,
        "inverting and stacking them":
            lambda: torch.logical_not(torch.stack([ts, ps])),
        "row scan": lambda: edt.row_scan(masks, col),
        "min-plus (K5)": lambda: min_plus(d2, row),
        "percentiles (sort)": lambda: (
            hd95._masked_percentile_sqrt(done[0], flat_p, 95.0),
            hd95._masked_percentile_sqrt(done[1], flat_t, 95.0)),
    }
    ms = {k: time_ms(fn, 5) for k, fn in parts.items()}
    whole = time_ms(lambda: hd95.hd95_per_structure_device(
        preds, labels, spacing=spacing), 5)
    print(f"[{label}] HD95 of one evaluation batch of {n} slices by part, "
          "ms: " + "; ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; the whole function {whole:.3f}; the rest "
          f"{whole - sum(ms.values()):.3f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels run only on a CUDA card", file=sys.stderr)
        return 1
    from ctseg_tpu_torch.ops import _build

    from ctseg_tpu_torch.training.config import use_float32_convs

    label = card_label()
    print(label)
    use_float32_convs()  # as every model the port builds does
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
    k1_err, k1_ms, k1_plain, k1_lib = phase_k1(label, gen)
    k2_err, k2_ms, k2_plain, k2_lib, k2_err64 = phase_k2(label, gen)
    k1b_err, k1b_ms, k1b_plain = phase_k1b(label, gen)
    k2b_err, k2b_ms, k2b_plain = phase_k2b(label, gen)
    k4_err, k4_ms, k4_plain, k4_02, k4_13 = phase_k4(label, gen)
    with tempfile.TemporaryDirectory() as tmp:
        service, ckpt, scan, serve_launches = phase_serve(label, Path(tmp))
        phase_forward(label, service, ckpt, scan)
        del service
        trainer, state, batch, draws, launches, _ = phase_train(
            label, Path(tmp), scan)
        phase_grad_parity(label, trainer, state, batch, draws)
        del trainer, state
        torch.cuda.empty_cache()
        phase_train_bf16(label, batch, draws)
        del batch, draws
        torch.cuda.empty_cache()
        k5_times = phase_k5(label, gen)
        edt_times = phase_edt(label, gen)
        torch.cuda.empty_cache()
        ckpt_m, launches_m, _ = phase_train_model_m(label, Path(tmp))
        torch.cuda.empty_cache()
        launches_eval, _ = phase_evaluate(label, ckpt_m)

    bounds = site_bounds()
    bounds["k5"] = k5_times["step maps"][2:4]
    bounds["scan"] = edt_times["scan"][2]
    bounds["signed"] = edt_times["signed"][2]

    def entry(name, key, source, replaces, err, ms, plain_ms):
        # No one PyTorch call computes any of these functions (IN + PReLU,
        # conv + IN + PReLU, their backwards from saved statistics, windows +
        # moves + normalize, a min-plus pass, a two-sided row scan, the
        # signed map), so there is no library time; K1 and K2 carry the
        # library's time for their norm and conv part alone beside it.
        return {"name": name, "route": "cuda",
                "source": f"ctseg_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": launches[key], "launches_model_m": launches_m[key],
                "launches_eval": launches_eval[key],
                "max_abs_err": err["float32"],
                "max_abs_err_bf16": err["bfloat16"],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[key][0],
                "bound_by": bounds[key][1], "library_ms": None}

    pallas = "ctseg_tpu/ops/pallas/"
    kernels = [
        entry("instance_norm_prelu", "k1", "instance_norm.cu",
              pallas + "instance_norm.py:254", k1_err, k1_ms["float32"],
              k1_plain["float32"]),
        entry("instance_norm_prelu_bwd", "k1b", "instance_norm.cu",
              pallas + "instance_norm.py:319", k1b_err, k1b_ms["float32"],
              k1b_plain["float32"]),
        entry("conv3x3_in_prelu", "k2", "conv_block.cu",
              pallas + "conv_block.py:146", k2_err, k2_ms["float32"],
              k2_plain["float32"]),
        entry("in_prelu_bwd", "k2b", "conv_block.cu",
              pallas + "conv_block.py:193", k2b_err, k2b_ms["float32"],
              k2b_plain["float32"]),
        entry("window_normalize_degree2", "k4", "preprocess.cu",
              pallas + "preprocess.py:81",
              {"float32": k4_err, "bfloat16": None}, k4_ms, k4_plain),
    ]
    # The bfloat16 totals of the norm kernels and the conv, with their bounds
    # at 2 bytes an element (K2: on the bfloat16 tensor-core peak).
    for i, key, ms, plain in ((0, "k1", k1_ms, k1_plain),
                              (1, "k1b", k1b_ms, k1b_plain),
                              (2, "k2", k2_ms, k2_plain),
                              (3, "k2b", k2b_ms, k2b_plain)):
        kernels[i].update(
            ms_bf16=ms["bfloat16"], plain_ms_bf16=plain["bfloat16"],
            bound_ms_bf16=bounds[key + "_bf16"][0],
            bound_by_bf16=bounds[key + "_bf16"][1])
    kernels[0].update(library_ms_norm=k1_lib["float32"],
                      library_ms_norm_bf16=k1_lib["bfloat16"])
    kernels[2].update(
        bound_ms_fp32_pipes=bounds["k2_fp32_pipes"][0],
        library_ms_conv=k2_lib["float32"],
        library_ms_conv_bf16=k2_lib["bfloat16"],
        max_abs_err_vs_float64=k2_err64["kernel"],
        plain_max_abs_err_vs_float64=k2_err64["plain"],
        # Read after the last main path; each path asserted 0 of its own.
        launches_simt=_counters()["k2"].launches_simt)
    kernels[4].update(ms_k_0_2=k4_02, ms_k_1_3=k4_13)
    # K4, K5 and the EDT kernels compute float32 only: no bfloat16
    # comparison exists to report, so that key is null for them.
    step, rand = k5_times["step maps"], k5_times["train"]
    k5 = entry("min_plus", "k5", "min_plus.cu", pallas + "min_plus.py:74",
               {"float32": step[4], "bfloat16": None}, step[0], step[1])
    # K5's main path is the Model M step; Model L's has no Boundary loss.
    k5.update(launches=launches_m["k5"], launches_model_l=launches["k5"],
              all_pairs_bound_ms=step[6], issue_bound_ms=step[5],
              ms_random=rand[0], plain_ms_random=rand[1],
              ms_unprunable=k5_times["unprunable"][0],
              ms_eval=k5_times["eval surfaces"][0],
              plain_ms_eval=k5_times["eval surfaces"][1],
              bound_ms_eval=k5_times["eval surfaces"][2],
              all_pairs_bound_ms_eval=k5_times["eval surfaces"][6],
              ms_eval_random=k5_times["eval"][0],
              max_abs_err_eval=k5_times["eval surfaces"][4])
    kernels.append(k5)
    # The two kernels around K5 replace no Pallas kernel: the JAX package
    # leaves these passes to XLA.
    scan = entry("edt_row_scan", "scan", "edt.cu",
                 "ctseg_tpu/ops/edt.py:28 (jnp, no Pallas kernel)",
                 {"float32": edt_times["scan"][6], "bfloat16": None},
                 edt_times["scan"][0], edt_times["scan"][1])
    scan.update(launches=launches_m["scan"], launches_model_l=launches["scan"],
                ms_eval=edt_times["scan"][3], plain_ms_eval=edt_times["scan"][4],
                bound_ms_eval=edt_times["scan"][5],
                ms_long_rows=edt_times["scan"][7],
                bound_ms_long_rows=edt_times["scan"][8])
    signed = entry("edt_signed_map", "signed", "edt.cu",
                   "ctseg_tpu/ops/edt.py:139 (jnp, no Pallas kernel)",
                   {"float32": edt_times["signed"][3], "bfloat16": None},
                   edt_times["signed"][0], edt_times["signed"][1])
    signed.update(launches=launches_m["signed"],
                  launches_model_l=launches["signed"])
    kernels += [scan, signed]
    kernels[0]["launches_serve"] = serve_launches["k1"]
    kernels[2]["launches_serve"] = serve_launches["k2"]
    print(f"(launches: phase 9's {TIMED_STEPS} timed Model L train steps, for "
          f"K5 and the EDT kernels phase 14's {TIMED_STEPS} Model M steps; "
          "launches_model_m: phase 14's; launches_serve: phase 4's requests; "
          "launches_eval: phase 15's evaluation; ms, plain_ms, bound_ms: "
          "float32 device "
          "time, kernel vs plain version vs the card's least, of the sites "
          f"of one forward at the serving batch {BATCH} for K1 and K2, of "
          f"one backward at the training batch {TRAIN_BATCH} for K1b and "
          f"K2b, of one batch-{TRAIN_BATCH} transform for K4 and of one "
          "Model M step's distance maps (made from the phase's labels) for "
          "K5 and the EDT kernels; max_abs_err: float32; "
          "ms_bf16, plain_ms_bf16, bound_ms_bf16: the same sums in bfloat16; "
          "K2's bound_ms: 3 tensor-core products for each one of the conv at "
          "the TF32 peak, bound_ms_fp32_pipes: the same work at the FP32 "
          "pipes' peak; library_ms_conv: F.conv2d alone, the conv part of "
          "K2 only; library_ms_norm: F.instance_norm alone, K1 without its "
          "PReLU; launches_simt: K2 launches on the FP32-pipe route, "
          "asserted 0 on every main path; K5's bound_ms: its bytes, "
          "all_pairs_bound_ms: the operations of the all-pairs form; "
          "ms_random, ms_unprunable: K5 on random maps with holes at BIG and "
          "on maps where no pair can be pruned; *_eval: on one evaluation "
          "batch's surfaces; K4's ms_k_0_2 and ms_k_1_3: every draw at k "
          "in {0, 2} and at k in {1, 3}, bound_ms: the crop read once and "
          "the output written once; the scan's *_long_rows: 8 label maps of "
          "32 rows of 8192)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
