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
 16. K1 and K1b at the 17 IN+PReLU sites of the 3D UNet at the bench
     configuration (batch 128, patches 128x128x16: six shapes from
     128x64x64x8x64 to 128x8x8x1x1024 and 128x128x128x16x10), float32 and
     bfloat16, against their plain versions as in phase 6; per site the
     training forward's and K1b's time beside their bytes' bound and the
     plain version's, and F.instance_norm alone (a yardstick).
 17. Train 3D, bench.py's second line: the 3D UNet (filters 64..1024, 2
     residual units, 1 -> 10 channels), CrossEntropy+Dice, patch mode
     (soft-tissue window, H and W flips) on 4 synthetic volumes of
     120x280x280 (HU ~ N(40, 300)), PatchPipeline3D at batch 128 x
     (128, 128, 16): Trainer.fit for one epoch (2 steps and a validation
     batch), then 5 timed steps on fresh sampled batches, in float32 (at
     the largest batch up to 128 that fits) and bfloat16. Each step must
     launch K1 and K1b 17 times and no other kernel. Patch sampling alone,
     peak memory, the float32 step by part and by group of kernels.
 18. Gradient parity of the 3D step, as phase 11, at a reduced width
     (filters 16..256, 2 patches of 64x64x16).
 19. The model_3d preset (resize mode, batch 1, volumes resized to
     256x256x96, raw HU, CrossEntropy): Trainer.fit for one epoch of 2
     volumes, then 3 timed steps; the same launches per step. K1's training
     forward and K1b held to their plain versions, as in phase 16, at each
     shape the step gave K1 (recorded at the call in a warm-up step: batch
     1 x 128x128x48x64 down to 16x16x6x1024, and 256x256x96x10).
 20. Evaluate 3D: phase 17's checkpoint through evaluate_3d_sliding_window
     with HD95 on 3 volumes of 280x280 and depths 120, 100 and 40 (box
     structures, per-volume spacings), patch (128, 128, 48), overlap 0.5,
     batch 4: K1 17 times per window batch, the row scan once and K5 twice
     per volume; vols/min with and without HD95 and with the volumes on
     the device; K1 held to its plain version at each shape the evaluation
     gave it (recorded in a warm-up run: window batches of 4 x
     64x64x24x64 down to 8x8x3x1024, and 128x128x48x10); HD95 of one
     volume by part, its row scan and K5 passes bit-equal to their plain
     versions on that volume's maps, and its value against scipy; the
     evaluation held to a CPU copy of the model (plain path) on one
     40x80x64 volume.
 21. Predict and serve 3D: predict_scan of one synthetic 120x512x512 scan
     by phase 17's checkpoint (timed after a warm-up run that records K1's
     shapes), one request to the HTTP server, and K1 held to its plain
     version at each shape predict gave it.

 22. Data preparation: 48 synthetic PDDCA patients (testing.synth, 512x512
     slices, depth cut to 28; made by 8 processes), then the CLIs `data.
     download miccai --no_download` (the 25/8/15 split), `data.process_
     miccai convert_2d` (the anatomical crop to 280x280) and `pack_2d`, and
     `data.stats`, each timed (host seconds).
 23. The reference's default workflow: the `train` CLI with its defaults
     (degree 0: one soft-tissue channel, crop, OneOf(elastic, grid)) at
     Model L's width (filters 64..1024, 2 residual units, exclude_missing),
     batch 128, on phase 22's packed splits, 2 epochs with an async save
     and 8 example panels each, under --profile: finite losses, the
     checkpoint (step, degree, one input channel), the panels and the
     trace's kernel events; no K4 launch.
 24. Model L at degree 0 timed as phase 9 times degree 2 (2 warm-ups, 5
     steps; K1 and K1b 8, K2 and K2b 9 launches a step, K4 none; no host
     sync in the timed steps, by torch's sync debug mode); an async save
     while 2 more steps run, the file equal to the state at the save; the
     step by group of kernels; then 2 Model M steps at degree 0 (the row
     scan, K5 and the signed map once a step).
 25. One model trained 2 steps at each of degrees 1, 3 and 4 (the same
     launches a step); each degree's train transform timed on a batch of
     128 (CUDA events).
 26. Each degree's train transform on the card against the same function
     on the CPU with the same draws: images within IMAGE_TOL_CPU, labels
     equal except where a warp's source coordinate lies within HALF_EPS of
     a half-integer (counted and printed).

 27. Export: phase 4's Model L checkpoint exported at 280x280 with the
     kernels (`--platforms cuda`: K1 and K2 as `ctseg::` custom ops), in
     float32 and bfloat16, and portable (aten ops only); each loaded with
     load_exported and run on 32 and on 1 cropped slices of phase 4's scan:
     8 K1 and 9 K2 launches a call for the kernel artifacts, none for the
     portable one; labels against predict_labels_2d's forward and each
     other within 0.1%; every K1 and K2 shape of a call at batch 1, in both
     types, held to its plain version; the portable one also in a process
     that cannot import the port; ms a batch of 32 beside the eager
     forward. Phase 17's 3D checkpoint exported as a patch scorer
     (128x128x48): 17 K1 launches a call of 4 patches, logits against the
     eager model.
 28. GradCAM: run_interpretability with phase 4's checkpoint on phase 22's
     test split, 16 samples in batches of 8 at feat_down1: K1b and K2b 9
     times the K1 and K2 sites after the layer (from the model's topology)
     a batch, finite non-negative maps, the .npy files; every K1 and K2
     shape of a batch of 8 held to its plain version, those after the layer
     in their training forms with K1b and K2b; 2 slices' maps against a
     float64 CPU referee and a CPU copy's plain path; ms a batch.
 29. The front door: `python -m ctseg_tpu_torch` lists the commands;
     evaluate and gradcam `--from_released model_l` from a local
     reference-layout model_large.ckpt; parity --checkpoint; parity
     --synthetic --max_epochs 1 (both small models, K5 in Model M's steps).

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


def _stat(t, x):
    """(N, C) statistics shaped to broadcast against x (N, *spatial, C)."""
    return t.reshape((t.shape[0],) + (1,) * (x.ndim - 2) + (t.shape[-1],))


def _k1b_site(label, x32, g32, sites, what="sites/step", plain_reps=20,
              dtypes=("float32", "bfloat16")):
    """K1b and K1's training forward against their plain versions on one
    site's x and cotangent, in each of `dtypes`; returns per type (worst
    dx error, kernel ms, plain ms) of the backward."""
    import torch
    from ctseg_tpu_torch.ops import instance_norm as k1

    shape = tuple(x32.shape)
    n, c = shape[0], shape[-1]
    s = x32.numel() // (n * c)
    out = {}
    for dname in dtypes:
        dtype = getattr(torch, dname)
        x, g = x32.to(dtype), g32.to(dtype)
        atol, rtol = BWD_TOL[dname]
        tag = f"K1b {shape} {dname}"
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
        xh0 = (x[..., 0].float() - _stat(mean, x)[..., 0]) * torch.rsqrt(
            _stat(var, x)[..., 0] + k1.EPS)
        check_close(f"{tag} y (channel 0)", y[..., 0],
                    torch.where(xh0 >= 0, xh0, 0.25 * xh0).to(dtype),
                    *TOL[("k1", dname)])
        del y, xh0
        # dx = rsqrt(var + eps) * (terms of the order of g), so its
        # absolute error scales with rsqrt(var + eps): about 316 on the
        # near-constant channel, which keeps its branch (sign(x - mean)
        # is one subtraction on both sides).
        dx_atol = atol * _stat(torch.clamp_min(torch.rsqrt(pvar + k1.EPS),
                                               1.0), x)
        worst = 0.0
        for a in ALPHAS:
            alpha = torch.full((1,), a, device=DEVICE)
            dx, da = k1.instance_norm_prelu_bwd(x, g, pmean, pvar, alpha)
            pdx, pda = k1.instance_norm_prelu_bwd_plain(
                x, g, pmean, pvar, alpha)
            worst = max(worst, check_close(f"{tag} alpha={a} dx", dx, pdx,
                                           dx_atol, rtol))
            del pdx
            xhat = (x.float() - _stat(pmean, x)) * torch.rsqrt(
                _stat(pvar, x) + k1.EPS)
            terms = (g.float() * torch.clamp_max(xhat, 0.0)).abs().sum()
            del xhat
            check_dalpha(f"{tag} alpha={a}", da, pda, terms)
        # Fixed-order sums, no atomics: a second call repeats both.
        dx2, da2 = k1.instance_norm_prelu_bwd(x, g, pmean, pvar, alpha)
        if not (torch.equal(da, da2) and torch.equal(dx, dx2)):
            raise AssertionError(f"{tag}: two calls on one input differ")
        del dx, dx2
        plan = k1.bwd_cluster_plan(n, s, c, x.element_size())
        form = "two-phase" if plan is None else \
            f"read-once in clusters of {plan['size']}"
        plan = plan or k1.bwd_plan(n, s, c, x.element_size())
        t_k = time_ms(lambda: k1.instance_norm_prelu_bwd(
            x, g, pmean, pvar, alpha), 20)
        t_p = time_ms(lambda: k1.instance_norm_prelu_bwd_plain(
            x, g, pmean, pvar, alpha), plain_reps)
        site_bound = 3 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
        print(f"[{label}] K1b {shape} {dname}: kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, its bytes' bound "
              f"{site_bound:.4f} ms ({site_bound / t_k:.2f} of the "
              f"kernel's time), {form}, grid {plan['grid']}, "
              f"{plan['vec']} elements a lane, {what} {sites}")
        out[dname] = (worst, t_k, t_p)
    return out


def phase_k1b(label, gen):
    """K1b and K1's training forward at the train step's shapes (batch
    TRAIN_BATCH), where phase 9 launches them."""
    import torch

    n = TRAIN_BATCH
    worst = {"float32": 0.0, "bfloat16": 0.0}
    ms = {"float32": 0.0, "bfloat16": 0.0}
    plain_ms = {"float32": 0.0, "bfloat16": 0.0}
    for (h, w, c), sites in K1_SITES.items():
        x32 = _k1_input(gen, (n, h, w, c))
        g32 = torch.randn((n, h, w, c), generator=gen, device=DEVICE)
        for dname, (err, t_k, t_p) in _k1b_site(label, x32, g32,
                                                 sites).items():
            worst[dname] = max(worst[dname], err)
            ms[dname] += sites * t_k
            plain_ms[dname] += sites * t_p
    print(f"K1b max |kernel - plain| (dx): float32 {worst['float32']:.3e}, "
          f"bfloat16 {worst['bfloat16']:.3e}; per step at batch {n}: float32 "
          f"kernel {ms['float32']:.3f} ms, plain {plain_ms['float32']:.3f} ms;"
          f" bfloat16 kernel {ms['bfloat16']:.3f} ms, plain "
          f"{plain_ms['bfloat16']:.3f} ms")
    return worst, ms, plain_ms


def _k2_weights(gen, cin, cout):
    """A 3x3 conv's weight (3, 3, Cin, Cout) and bias at torch's default
    init scale."""
    import torch

    bound = 1.0 / (9 * cin) ** 0.5
    w32 = (torch.rand((3, 3, cin, cout), generator=gen, device=DEVICE)
           * 2 - 1) * bound
    b = (torch.rand((cout,), generator=gen, device=DEVICE) * 2 - 1) * bound
    return w32, b


def _k2b_site(label, gen, n, h, w, cin, cout, what="sites/step", sites=None,
              dtypes=("float32", "bfloat16")):
    """K2b and K2's training forward against their plain versions at one
    site (batch n), in each of `dtypes`; returns per type (worst dy error,
    kernel ms, plain ms) of K2b."""
    import torch
    from ctseg_tpu_torch.ops import conv_block as k2

    out = {}
    g32 = torch.randn((n, h, w, cout), generator=gen, device=DEVICE)
    xh32 = torch.randn((n, h, w, cout), generator=gen, device=DEVICE)
    rsinv = torch.rand((n, cout), generator=gen, device=DEVICE) + 0.5
    for dname in dtypes:
        dtype = getattr(torch, dname)
        g, xhat = g32.to(dtype), xh32.to(dtype)
        atol, rtol = BWD_TOL[dname]
        tag = f"K2b {(n, h, w, cin, cout)} {dname}"
        worst = 0.0
        for a in ALPHAS:
            alpha = torch.full((1,), a, device=DEVICE)
            dy, da = k2.in_prelu_bwd(g, xhat, rsinv, alpha)
            pdy, pda = k2.in_prelu_bwd_plain(g, xhat, rsinv, alpha)
            err = check_close(f"{tag} alpha={a} dy", dy, pdy, atol, rtol)
            terms = (g.float() * torch.clamp_max(xhat.float(), 0.0)).abs().sum()
            check_dalpha(f"{tag} alpha={a}", da, pda, terms)
            worst = max(worst, err)
        t_k = time_ms(lambda: k2.in_prelu_bwd(g, xhat, rsinv, alpha), 20)
        t_p = time_ms(lambda: k2.in_prelu_bwd_plain(g, xhat, rsinv, alpha), 20)
        print(f"[{label}] K2b {(n, h, w, cin, cout)} {dname}: kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, {what} {sites}")
        out[dname] = (worst, t_k, t_p)
    del g32, xh32, g, xhat
    # K2's training forward: xhat and rsinv beside out, against the plain's.
    x32 = torch.randn((n, h, w, cin), generator=gen, device=DEVICE)
    w32, b = _k2_weights(gen, cin, cout)
    alpha = torch.full((1,), 0.25, device=DEVICE)
    for dname in dtypes:
        x, wt = x32.to(getattr(torch, dname)), w32.to(getattr(torch, dname))
        y, xhat, rsinv = k2._forward(x, wt, b, alpha, train=True)
        py, pxhat, prsinv = k2._fwd_plain(x, wt, b, alpha)
        tag = f"K2 train forward {(n, h, w, cin, cout)} {dname}"
        check_close(f"{tag} out", y, py, *TOL[("k2", dname)])
        check_close(f"{tag} xhat", xhat, pxhat, *TOL[("k2", dname)])
        check_close(f"{tag} rsinv", rsinv, prsinv, 1e-5, 1e-4)
        del y, xhat, py, pxhat
    return out


def phase_k2b(label, gen):
    """K2b and K2's training forward at the train step's shapes (batch
    TRAIN_BATCH), where phase 9 launches them."""
    n = TRAIN_BATCH
    worst = {"float32": 0.0, "bfloat16": 0.0}
    ms = {"float32": 0.0, "bfloat16": 0.0}
    plain_ms = {"float32": 0.0, "bfloat16": 0.0}
    for (h, w, cin, cout), sites in K2_SITES.items():
        for dname, (err, t_k, t_p) in _k2b_site(label, gen, n, h, w, cin,
                                                 cout, sites=sites).items():
            worst[dname] = max(worst[dname], err)
            ms[dname] += sites * t_k
            plain_ms[dname] += sites * t_p
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


def phase_grad_parity(label, trainer, state, batch, draws,
                      what="float32 Model L on 2 slices"):
    import copy
    import dataclasses

    import torch
    from ctseg_tpu_torch.training.trainer import Trainer

    two = tuple(t[:2] for t in batch)
    draws2 = type(draws)(*(t[:2] for t in draws))
    cpu_two = tuple(t.cpu() for t in two)
    cpu_draws = type(draws)(*(t.cpu() for t in draws2))
    g_cuda = _grads(trainer, state.model, two, draws2)
    g_cpu = _grads(Trainer(trainer.config, "cpu", trainer.train_transform,
                           trainer.test_transform),
                   copy.deepcopy(state.model).to("cpu"), cpu_two, cpu_draws)
    cfg64 = dataclasses.replace(trainer.config, compute_dtype="float64")
    model64 = copy.deepcopy(state.model).to("cpu", torch.float64)
    model64.compute_dtype = torch.float64
    g64, slope_terms = _grads_and_slope_terms(
        Trainer(cfg64, "cpu", trainer.train_transform, trainer.test_transform),
        model64, cpu_two, cpu_draws)

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
    print(f"[{label}] gradient parity, {what}, CUDA "
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


# ------------------------------------------------------------------- 3D
# bench.py's second line (bench_3d, bench.py:261-374): random patches of
# (H, W, D) = PATCH_3D at batch TRAIN_BATCH from 4 volumes of VOLUME_3D
# (HU ~ N(40, 300), labels 0..9, every structure annotated), the 3D UNet
# with filters 64..1024, 2 residual units and one input channel,
# CrossEntropy+Dice, the patch transform (soft-tissue window, H and W
# flips).
PATCH_3D = (128, 128, 16)
VOLUME_3D = (120, 280, 280)  # (D, H, W)
# Its IN+PReLU sites, per sample (H, W, D, C) -> sites per forward; every
# site is a library conv (strided, transposed or stride-1) then K1.
K1_SITES_3D = {
    (64, 64, 8, 64): 4,     # down0 units 0-1, up1 transposed conv + unit
    (32, 32, 4, 128): 4,    # down1 units 0-1, up2 transposed conv + unit
    (16, 16, 2, 256): 4,    # down2 units 0-1, up3 transposed conv + unit
    (8, 8, 1, 512): 2,      # down3 units 0-1
    (8, 8, 1, 1024): 2,     # bottom units 0-1
    (128, 128, 16, 10): 1,  # up0 transposed conv
}
PER_STEP_3D = {"k4": 0, "k1": 17, "k1b": 17, "k2": 0, "k2b": 0, "k5": 0,
               "scan": 0, "signed": 0}
GRAD_FILTERS_3D = (16, 32, 64, 128, 256)  # phase 18's reduced width
GRAD_PATCH_3D = (64, 64, 16)
RESIZE_STEPS = 3        # phase 19's timed steps of the model_3d preset
EVAL_PATCH_3D = (128, 128, 48)
EVAL_DEPTHS_3D = (120, 100, 40)   # phase 20's volumes, EVAL_HW_3D in-plane
EVAL_HW_3D = (280, 280)
EVAL_BATCH_3D = 4
HELD_VOLUME_3D = (40, 80, 64)     # phase 20's CPU-held volume (D, H, W)
HELD_PATCH_3D = (64, 64, 32)
DICE_TOL_3D = 1e-3      # the CPU copy's Dice (cuDNN vs CPU convs: near-ties)


def _volumes_3d(seed, n, shape=VOLUME_3D, boxes=False, spacings=False):
    """bench_3d's synthetic volumes (float32 HU, uniform random labels), or
    with `boxes` int16 volumes with box structures and z-first spacings
    (so the surfaces and their distances are those of compact shapes)."""
    from ctseg_tpu_torch.data.datasets import PackedDataset3D

    rng = np.random.default_rng(seed)
    if not boxes:
        return PackedDataset3D(
            images=[rng.normal(40, 300, size=shape).astype(np.float32)
                    for _ in range(n)],
            labels=[rng.integers(0, 10, size=shape).astype(np.uint8)
                    for _ in range(n)],
            indicators=[np.ones(9, np.float32)] * n)
    images, labels = [], []
    depths = shape if isinstance(shape[0], tuple) else [shape] * n
    for d, h, w in depths:
        lab = np.zeros((d, h, w), np.uint8)
        for c in range(1, 10):
            ez = rng.integers(d // 8 + 1, d // 3 + 2)
            ey, ex = rng.integers(h // 16 + 1, h // 4 + 2), \
                rng.integers(w // 16 + 1, w // 4 + 2)
            z = rng.integers(0, d - ez + 1)
            y, x = rng.integers(1, h - ey), rng.integers(1, w - ex)
            lab[z:z + ez, y:y + ey, x:x + ex] = c
        images.append((rng.normal(40, 120, (d, h, w)) + 60.0 * lab)
                      .astype(np.int16))
        labels.append(lab)
    return PackedDataset3D(
        images, labels, [np.ones(9, np.float32)] * len(images),
        spacings=[rng.uniform(0.8, 3.0, 3).astype(np.float32)
                  for _ in images] if spacings else None)


def _config_3d(dtype="float32", batch=TRAIN_BATCH, filters=FILTERS,
               patch=PATCH_3D):
    from ctseg_tpu_torch.training.config import TrainConfig

    return TrainConfig(filters=filters, num_res_units=2, transform_degree=0,
                       batch_size=batch, loss_fx=("CrossEntropy", "Dice"),
                       spatial_dims=3, input_shape=patch, in_channels=1,
                       epochs=1, compute_dtype=dtype,
                       volumetric_mode="patch")


def site_bounds_3d(n=TRAIN_BATCH):
    """K1's and K1b's bounds over the 3D step's 17 sites (as site_bounds)."""
    out = {}
    for key, ops_per, io in (("k1", 8, 2), ("k1b", 14, 3)):
        e = sum(n * h * w * d * c * sites
                for (h, w, d, c), sites in K1_SITES_3D.items())
        out[key] = bound_ms(ops_per * e, 4 * io * e)
        out[key + "_bf16"] = bound_ms(ops_per * e, 2 * io * e)
    return out


def phase_k1_3d(label, gen):
    """K1f (the training forward) and K1b at the 3D step's 17 sites, batch
    TRAIN_BATCH, against their plain versions; per site the time, the
    bytes' bound and the share, and F.instance_norm alone beside K1f."""
    import torch
    import torch.nn.functional as F
    from ctseg_tpu_torch.ops import instance_norm as k1

    n = TRAIN_BATCH
    names = ("float32", "bfloat16")
    tot = {k: dict.fromkeys(names, 0.0) for k in (
        "fwd", "fwd_plain", "fwd_lib", "bwd", "bwd_plain")}
    worst = {"fwd": dict.fromkeys(names, 0.0), "bwd": dict.fromkeys(names, 0.0)}
    rows = []
    for (h, w, d, c), sites in K1_SITES_3D.items():
        shape = (n, h, w, d, c)
        x32 = _k1_input(gen, shape)
        g32 = torch.randn(shape, generator=gen, device=DEVICE)
        bwd = _k1b_site(label, x32, g32, sites, "sites/step", plain_reps=3)
        del g32
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            dname = names[dtype == torch.bfloat16]
            alpha = torch.full((1,), 0.25, device=DEVICE)
            y = k1.instance_norm_prelu(x, alpha)
            err = check_close(f"K1 {shape} {dname}", y[..., 1:],
                              k1.instance_norm_prelu_plain(x, alpha)[..., 1:],
                              *TOL[("k1", dname)])
            if not torch.equal(y, k1.instance_norm_prelu(x, alpha)):
                raise AssertionError(f"K1 {shape} {dname}: two runs differ")
            del y
            worst["fwd"][dname] = max(worst["fwd"][dname], err)
            t_k = time_ms(lambda: k1._forward(x, alpha, train=True), 10)
            t_p = time_ms(lambda: k1._fwd_plain(x, alpha), 3)
            xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view of the same memory
            t_l = time_ms(lambda: F.instance_norm(xc), 10)
            plan = k1.fwd_cluster_plan(n, h * w * d, c, x.element_size())
            form = "two-phase" if plan is None else (
                f"read-once in clusters of {plan['size']}")
            b_f = 2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
            b_b = 1.5 * b_f
            bw_err, bt_k, bt_p = bwd[dname]
            worst["bwd"][dname] = max(worst["bwd"][dname], bw_err)
            print(f"[{label}] K1 3D site {shape} {dname}: training forward "
                  f"{t_k:.4f} ms (bound {b_f:.4f}, share {b_f / t_k:.2f}, "
                  f"{form}), plain {t_p:.4f}, F.instance_norm alone "
                  f"{t_l:.4f}; K1b {bt_k:.4f} ms (bound {b_b:.4f}, share "
                  f"{b_b / bt_k:.2f}), plain {bt_p:.4f}; sites/step {sites}")
            rows.append({"site": [h, w, d, c], "sites": sites, "dtype": dname,
                         "k1_ms": t_k, "k1_bound_ms": b_f,
                         "k1_plain_ms": t_p, "k1_library_ms": t_l,
                         "k1b_ms": bt_k, "k1b_bound_ms": b_b,
                         "k1b_plain_ms": bt_p})
            for k, v in (("fwd", t_k), ("fwd_plain", t_p), ("fwd_lib", t_l),
                         ("bwd", bt_k), ("bwd_plain", bt_p)):
                tot[k][dname] += sites * v
        del x, x32
        torch.cuda.empty_cache()
    b = site_bounds_3d()
    print(f"[{label}] K1 at the 17 3D sites, batch {n}, per step: float32 "
          f"forward {tot['fwd']['float32']:.3f} ms (bound {b['k1'][0]:.3f}, "
          f"plain {tot['fwd_plain']['float32']:.3f}, F.instance_norm alone "
          f"{tot['fwd_lib']['float32']:.3f}), K1b "
          f"{tot['bwd']['float32']:.3f} ms (bound {b['k1b'][0]:.3f}, plain "
          f"{tot['bwd_plain']['float32']:.3f}); bfloat16 forward "
          f"{tot['fwd']['bfloat16']:.3f} (bound {b['k1_bf16'][0]:.3f}), K1b "
          f"{tot['bwd']['bfloat16']:.3f} (bound {b['k1b_bf16'][0]:.3f}); "
          f"max |kernel - plain| forward {worst['fwd']['float32']:.3e}, dx "
          f"{worst['bwd']['float32']:.3e}")
    print("K1_SITES_3D " + json.dumps(rows))
    return tot, worst


def _train_3d(label, trainer, state, pipe, steps):
    """Timed train steps on fresh patch batches (sampling included); returns
    (state, ms/step, launches, losses)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    for _ in range(2):  # warm-up
        state, _ = trainer.train_step(state, pipe.gather(pipe.draw(gen)),
                                      generator=gen)
    torch.cuda.synchronize()
    reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.train_step(
            state, pipe.gather(pipe.draw(gen)), generator=gen)
        losses.append(metrics["loss/total"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = read_launches()
    want = {k: v * steps for k, v in PER_STEP_3D.items()}
    if launches != want:
        raise AssertionError(f"3D launches {launches} over {steps} steps; "
                             f"want {want}")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"3D losses {losses}")
    return state, step_s, launches, losses


def phase_train_3d(label, workdir: Path):
    """The 3D patch step at the bench configuration: Trainer.fit for one
    epoch through PatchPipeline3D, then timed steps, in float32 (at batch
    128, or the largest batch that fits) and bfloat16; patch sampling alone;
    peak memory; the step by group of kernels."""
    import torch
    from ctseg_tpu_torch.volumetric.pipeline3d import PatchPipeline3D
    from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d

    data = _volumes_3d(0, 4)
    out = {}
    for dtype in ("float32", "bfloat16"):
        batch = TRAIN_BATCH
        while True:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                trainer = make_trainer_3d(_config_3d(dtype, batch), "patch",
                                          PATCH_3D, DEVICE)
                state = trainer.init_state(torch.Generator().manual_seed(0))
                pipe = PatchPipeline3D(data, batch, PATCH_3D, 2, DEVICE)
                val = PatchPipeline3D(data, batch, PATCH_3D, 1, DEVICE)
                t0 = time.perf_counter()
                state = trainer.fit(state, pipe, val, epochs=1)
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
                state, step_s, launches, losses = _train_3d(
                    label, trainer, state, pipe, TIMED_STEPS)
                break
            except torch.cuda.OutOfMemoryError:
                trainer = state = pipe = val = None
                if batch == 1:
                    raise
                print(f"[{label}] 3D {dtype} at batch {batch}: out of "
                      "device memory; halving the batch")
                batch //= 2
        peak = torch.cuda.max_memory_allocated()
        gen = torch.Generator(device=DEVICE).manual_seed(6)
        t_sample = time_ms(lambda: pipe.gather(pipe.draw(gen)), 10)
        print(f"[{label}] 3D patch train step, {dtype}, batch {batch} x "
              f"{PATCH_3D}: {step_s * 1e3:.3f} ms/step, "
              f"{batch / step_s:.2f} patches/s (host clock over "
              f"{TIMED_STEPS} steps after 2 warm-ups, each on a fresh "
              f"sampled batch); patch sampling alone {t_sample:.3f} ms; peak "
              f"device memory {peak / 2**30:.3f} GiB; Trainer.fit, 1 epoch "
              f"(2 steps + 1 validation batch) {fit_s:.3f} s; losses "
              f"{[round(v, 5) for v in losses]}; launches {launches}")
        out[dtype] = {"batch": batch, "ms": step_s * 1e3,
                      "patches_per_s": batch / step_s, "peak_gib": peak / 2**30,
                      "sample_ms": t_sample, "launches": launches}
        if dtype == "float32":
            if batch != TRAIN_BATCH:
                print(f"[{label}] float32 does not fit at batch "
                      f"{TRAIN_BATCH}; the largest batch that fits is {batch}")
            b = pipe.gather(pipe.draw(gen))
            images, labels = trainer.train_transform(
                b[0], b[1], trainer.draw(gen, b[0]))
            with torch.no_grad():
                logits = trainer._logits(state.model.train(), images)
            timed = {
                "sampling": lambda: pipe.gather(pipe.draw(gen)),
                "transform": lambda: trainer.train_transform(
                    b[0], b[1], trainer.draw(gen, b[0])),
                "forward alone, no_grad": lambda: _no_grad(
                    trainer._logits, state.model, images),
                "Dice": lambda: trainer.dice(
                    trainer._predictions(logits, b[2]), labels),
            }
            parts = {k: time_ms(fn, 3) for k, fn in timed.items()}
            print(f"[{label}] 3D float32 step by part, ms: " + "; ".join(
                f"{k} {v:.3f}" for k, v in parts.items()))
            del logits, images, labels
            profile_step(label, "3D patch train step (float32)",
                         lambda: trainer.train_step(state, b, generator=gen))
            ckpt = workdir / "patch3d.ckpt"
            trainer.save(ckpt, state)
            out["ckpt"] = ckpt
        trainer = state = pipe = val = None
        torch.cuda.empty_cache()
    return out


def _no_grad(fn, *args):
    import torch

    with torch.no_grad():
        return fn(*args)


def phase_grad_parity_3d(label):
    """phase_grad_parity on the 3D step at a reduced width (filters
    GRAD_FILTERS_3D, 2 patches of GRAD_PATCH_3D)."""
    import torch
    from ctseg_tpu_torch.volumetric.pipeline3d import PatchPipeline3D
    from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d

    cfg = _config_3d(batch=2, filters=GRAD_FILTERS_3D, patch=GRAD_PATCH_3D)
    trainer = make_trainer_3d(cfg, "patch", GRAD_PATCH_3D, DEVICE)
    state = trainer.init_state(torch.Generator().manual_seed(1))
    pipe = PatchPipeline3D(_volumes_3d(2, 2, (40, 96, 96)), 2, GRAD_PATCH_3D,
                           device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    batch = pipe.gather(pipe.draw(gen))
    return phase_grad_parity(
        label, trainer, state, batch, trainer.draw(gen, batch[0]),
        f"float32 3D UNet {GRAD_FILTERS_3D} on 2 patches of {GRAD_PATCH_3D}")


def _k1_shapes(fn):
    """Run fn() and return the (shape, dtype name) -> calls of K1 that the
    model's units made in it, in either form (from _site_shapes)."""
    sites = _site_shapes(fn)
    seen = dict(sites[("k1", False)])
    for key, calls in sites[("k1", True)].items():
        seen[key] = seen.get(key, 0) + calls
    return seen


def _hold_k1_at(label, what, shapes, gen, backward):
    """K1 (and with `backward` K1b and K1's training forward, as phase 16)
    against their plain versions at each shape a main path gave it (from
    _k1_shapes), at phase 16's tolerances: the plans pick their geometry
    from the shape, so each shape is held where the path launched it. Per
    shape the forward's time (the training form with `backward`), its
    bytes' bound and share, and the plain version's; the totals over the
    path's calls. Returns the rows."""
    import torch
    from ctseg_tpu_torch.ops import instance_norm as k1

    rows = []
    for (shape, dname), calls in sorted(shapes.items()):
        x32 = _k1_input(gen, shape)
        row = {"shape": list(shape), "dtype": dname, "calls": calls}
        if backward:
            g32 = torch.randn(shape, generator=gen, device=DEVICE)
            err, t_b, t_bp = _k1b_site(label, x32, g32, calls,
                                       f"calls in {what}", 3, (dname,))[dname]
            row.update(k1b_ms=t_b, k1b_plain_ms=t_bp, k1b_err=err,
                       k1b_bound_ms=3 * x32.numel()
                       * getattr(torch, dname).itemsize / PEAK_BYTES * 1e3)
            del g32
        x = x32.to(getattr(torch, dname))
        alpha = torch.full((1,), 0.25, device=DEVICE)
        y = k1.instance_norm_prelu(x, alpha)
        err = check_close(f"K1 {shape} {dname} ({what})", y[..., 1:],
                          k1.instance_norm_prelu_plain(x, alpha)[..., 1:],
                          *TOL[("k1", dname)])
        if not torch.equal(y, k1.instance_norm_prelu(x, alpha)):
            raise AssertionError(f"K1 {shape} {dname}: two runs differ")
        n, c = shape[0], shape[-1]
        plan = k1.fwd_cluster_plan(n, x.numel() // (n * c), c,
                                   x.element_size())
        form = "two-phase" if plan is None else (
            f"read-once in clusters of {plan['size']}")
        t_k = time_ms(lambda: k1._forward(x, alpha, train=backward), 10)
        t_p = time_ms(lambda: k1._fwd_plain(x, alpha), 3)
        bound = 2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
        print(f"[{label}] K1 {shape} {dname}, as {what} launches it "
              f"({calls} calls): max |kernel - plain| {err:.3e}, {form}; "
              f"{'training ' if backward else ''}forward {t_k:.4f} ms (bound "
              f"{bound:.4f}, share {bound / t_k:.2f}), plain {t_p:.4f}")
        row.update(k1_ms=t_k, k1_plain_ms=t_p, k1_bound_ms=bound, k1_err=err)
        rows.append(row)
        del x, x32, y
    torch.cuda.empty_cache()
    tot = {k: sum(r["calls"] * r[k] for r in rows)
           for k in rows[0] if k.endswith("_ms")}
    print(f"[{label}] K1 over {what}'s calls, ms: " + "; ".join(
        f"{k[:-3]} {v:.3f}" for k, v in tot.items()))
    print(f"K1_SITES_OF {what}: " + json.dumps(rows))
    return rows


def _site_shapes(fn):
    """Run fn() and return the K1 and K2 calls that the model's units made
    in it (recorded at the call in models/layers.py), by kernel and form:
    {("k1" or "k2", training form?): {key: calls}}, the key (x shape, dtype
    name) for K1 and (x shape, Cout, dtype name) for K2. A call takes the
    training form where the wrapper does: grad enabled and an input
    requiring it."""
    import torch
    from ctseg_tpu_torch.models import layers

    seen = {("k1", False): {}, ("k1", True): {}, ("k2", False): {},
            ("k2", True): {}}
    k1, k2 = layers.instance_norm_prelu, layers.conv3x3_in_prelu

    def note(kind, key, *args):
        train = torch.is_grad_enabled() and any(t.requires_grad for t in args)
        calls = seen[(kind, train)]
        calls[key] = calls.get(key, 0) + 1

    def record_k1(x, alpha):
        note("k1", (tuple(x.shape), str(x.dtype).split(".")[-1]), x, alpha)
        return k1(x, alpha)

    def record_k2(x, w, b, alpha):
        note("k2", (tuple(x.shape), w.shape[-1], str(x.dtype).split(".")[-1]),
             x, w, b, alpha)
        return k2(x, w, b, alpha)

    layers.instance_norm_prelu, layers.conv3x3_in_prelu = record_k1, record_k2
    try:
        fn()
    finally:
        layers.instance_norm_prelu, layers.conv3x3_in_prelu = k1, k2
    return seen


def _hold_k2_at(label, what, shapes, gen, train):
    """K2 (and with `train` K2b and K2's training forward, as phase 6)
    against their plain versions at each shape a main path gave it (from
    _site_shapes), at phases 3 and 6's tolerances, on the tensor-core route;
    per shape the inference forward's time and the plain version's."""
    import torch
    from ctseg_tpu_torch.ops import conv_block as k2

    rows = []
    for (shape, cout, dname), calls in sorted(shapes.items()):
        n, h, w, cin = shape
        if k2.conv_route(cin, cout, h, w) != "tc":
            raise AssertionError(f"K2 {shape} -> {cout} ({what}) is not on "
                                 "the tensor-core route")
        row = {"shape": [*shape, cout], "dtype": dname, "calls": calls}
        if train:
            err, t_b, t_bp = _k2b_site(label, gen, n, h, w, cin, cout,
                                       f"calls in {what}", calls,
                                       (dname,))[dname]
            row.update(k2b_ms=t_b, k2b_plain_ms=t_bp, k2b_err=err)
        dtype = getattr(torch, dname)
        x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        w32, b = _k2_weights(gen, cin, cout)
        wt = w32.to(dtype)
        alpha = torch.full((1,), 0.25, device=DEVICE)
        y = k2.conv3x3_in_prelu(x, wt, b, alpha)
        err = check_close(f"K2 {shape} -> {cout} {dname} ({what})", y,
                          k2.conv3x3_in_prelu_plain(x, wt, b, alpha),
                          *TOL[("k2", dname)])
        if not torch.equal(y, k2.conv3x3_in_prelu(x, wt, b, alpha)):
            raise AssertionError(f"K2 {shape} {dname}: two runs differ")
        t_k = time_ms(lambda: k2._forward(x, wt, b, alpha, train=False), 10)
        t_p = time_ms(lambda: k2._fwd_plain(x, wt, b, alpha), 3)
        print(f"[{label}] K2 {shape} -> {cout} {dname}, as {what} launches "
              f"it ({calls} calls{', training form' if train else ''}): max "
              f"|kernel - plain| {err:.3e}; inference forward {t_k:.4f} ms, "
              f"plain {t_p:.4f}")
        row.update(k2_ms=t_k, k2_plain_ms=t_p, k2_err=err)
        rows.append(row)
        del x, y
    torch.cuda.empty_cache()
    print(f"K2_SITES_OF {what}: " + json.dumps(rows))
    return rows


def _hold_sites(label, what, sites, gen):
    """Every K1 and K2 shape of `sites` (from _site_shapes) held to its
    plain version, the training forms with their backward kernels."""
    for (kind, train), shapes in sites.items():
        if not shapes:
            continue
        form = "training" if train else "inference"
        if kind == "k1":
            _hold_k1_at(label, f"{what} ({form} form)", shapes, gen, train)
        else:
            _hold_k2_at(label, f"{what} ({form} form)", shapes, gen, train)


def phase_train_resize_3d(label):
    """The model_3d preset (resize mode, batch 1 at 256x256x96, raw HU,
    CrossEntropy): Trainer.fit for one epoch on 2 resized volumes, then
    RESIZE_STEPS timed steps."""
    import dataclasses

    import torch
    from ctseg_tpu_torch.models.presets import PRESETS
    from ctseg_tpu_torch.volumetric.pipeline3d import DevicePipeline3D
    from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d

    cfg = dataclasses.replace(PRESETS["model_3d"], epochs=1)
    trainer = make_trainer_3d(cfg, "resize", device=DEVICE)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    data = _volumes_3d(3, 2)
    pipe = DevicePipeline3D(data, 1, tuple(cfg.input_shape), DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.fit(state, pipe, pipe, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    batch = next(pipe.epoch())
    shapes = _k1_shapes(lambda: trainer.train_step(state, batch))
    state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(RESIZE_STEPS):
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss/total"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / RESIZE_STEPS
    launches = read_launches()
    want = {k: v * RESIZE_STEPS for k, v in PER_STEP_3D.items()}
    if launches != want:
        raise AssertionError(f"model_3d launches {launches}; want {want}")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"model_3d losses on one batch: {losses}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[{label}] model_3d preset (resize mode, float32, batch 1 at "
          f"{tuple(cfg.input_shape)}, CrossEntropy): {step_s * 1e3:.3f} "
          f"ms/step over {RESIZE_STEPS} steps on one batch; Trainer.fit, 1 "
          f"epoch of 2 volumes with validation {fit_s:.3f} s; peak "
          f"{peak / 2**30:.3f} GiB; losses {[round(v, 5) for v in losses]}; "
          f"launches {launches}")
    trainer = state = pipe = batch = None
    torch.cuda.empty_cache()
    _hold_k1_at(label, "the model_3d step", shapes,
                torch.Generator(device=DEVICE).manual_seed(8), backward=True)
    return {"ms": step_s * 1e3, "peak_gib": peak / 2**30}


def phase_evaluate_3d(label, ckpt: Path):
    """evaluate_3d_sliding_window with HD95 on 3 volumes of mixed depths
    with spacings, by the patch-mode checkpoint of phase 17: launches,
    vols/min with and without HD95, HD95's parts on one volume; the device
    HD95 of one volume against scipy; the whole evaluation held to the plain
    path on a CPU copy of one small volume."""
    import torch
    from ctseg_tpu_torch.inference.evaluate import (
        evaluate_3d_sliding_window, format_table, sliding_window_throughput,
    )
    from ctseg_tpu_torch.inference.sliding_window import (
        compute_window_grid, padded_shape,
    )
    from ctseg_tpu_torch.training.config import load_checkpoint

    cfg, model = load_checkpoint(ckpt, DEVICE)
    data = _volumes_3d(4, 3, tuple((d,) + EVAL_HW_3D for d in EVAL_DEPTHS_3D),
                       boxes=True, spacings=True)
    kw = dict(patch_size=EVAL_PATCH_3D, overlap=0.5,
              batch_size=EVAL_BATCH_3D, device=DEVICE)
    shapes = _k1_shapes(lambda: evaluate_3d_sliding_window(
        model, cfg, data, with_hd95=True, **kw))
    reset_launches()
    result = evaluate_3d_sliding_window(model, cfg, data, with_hd95=True,
                                        **kw)
    launches = read_launches()
    batches = sum(-(-len(compute_window_grid(
        padded_shape((h, w, d), EVAL_PATCH_3D), EVAL_PATCH_3D, 0.5))
        // EVAL_BATCH_3D) for d, h, w in (v.shape for v in data.images))
    n = len(data.images)
    want = {"k4": 0, "k1": 17 * batches, "k1b": 0, "k2": 0, "k2b": 0,
            "k5": 2 * n, "scan": n, "signed": 0}
    if launches != want:
        raise AssertionError(f"3D evaluation launched {launches} over {n} "
                             f"volumes, {batches} window batches; want {want}")
    hd = [v for v in result["per_structure_hd95"].values() if v is not None]
    if result["hd95_unit"] != "mm" or not hd or not all(np.isfinite(hd)):
        raise AssertionError(f"3D evaluation: {result}")
    print(format_table(result))
    no_hd95 = evaluate_3d_sliding_window(model, cfg, data, **kw)
    share = 1.0 - result["vols_per_min"] / no_hd95["vols_per_min"]
    steady = sliding_window_throughput(model, cfg, data, EVAL_PATCH_3D, 0.5,
                                       EVAL_BATCH_3D, reps=1, device=DEVICE)
    print(f"[{label}] 3D evaluation, patch-mode checkpoint float32, volumes "
          f"{EVAL_HW_3D} x {EVAL_DEPTHS_3D}, patch {EVAL_PATCH_3D}, overlap 0.5, "
          f"batch {EVAL_BATCH_3D}: {result['vols_per_min']:.2f} vols/min "
          f"with HD95 (mm), {no_hd95['vols_per_min']:.2f} without: HD95 is "
          f"{share:.3f} of the time; steady state without metrics "
          f"{steady['vols_per_min']:.2f} vols/min; {batches} window batches, "
          f"{result['compiled_programs']} window grids; launches {launches}")
    _hold_k1_at(label, "the 3D evaluation", shapes,
                torch.Generator(device=DEVICE).manual_seed(9), backward=False)
    parts = _hd95_parts_3d(label, model, cfg, data)
    _evaluate_3d_held(label, cfg, model)
    return launches, parts


def _hd95_parts_3d(label, model, cfg, data):
    """HD95's device time by part on the first (deepest) volume, and its
    value on the last against the scipy host path."""
    import torch
    from ctseg_tpu_torch.inference.predict import predict_labels_3d
    from ctseg_tpu_torch.metrics import hd95
    from ctseg_tpu_torch.ops import edt
    from ctseg_tpu_torch.ops.min_plus import min_plus, min_plus_plain

    def labels_of(i):
        """(predicted, annotated) (H, W, D) label maps of volume i."""
        preds = predict_labels_3d(model, cfg, data.images[i], DEVICE,
                                  EVAL_PATCH_3D, 0.5, EVAL_BATCH_3D)
        return tuple(torch.from_numpy(a).to(DEVICE).movedim(0, -1)
                     for a in (preds, data.labels[i]))

    preds, target = labels_of(0)
    spc = data.spacings[0][[1, 2, 0]]
    spacing = torch.from_numpy(spc).to(DEVICE)
    h, w, d = preds.shape
    classes = torch.arange(1, 10, device=DEVICE).reshape(9, 1, 1, 1)

    def surfaces():
        return (hd95._surface_device(preds.unsqueeze(0) == classes, 3),
                hd95._surface_device(target.unsqueeze(0) == classes, 3))

    ps, ts = surfaces()
    masks = torch.logical_not(torch.stack([ts, ps])).reshape(-1, h * w, d)
    col = spacing[2].repeat(18).contiguous()
    d2 = edt.row_scan(masks, col)
    d2a = min_plus(d2.reshape(18, h, w * d), spacing[0].repeat(18))
    d2b = d2a.reshape(18 * h, w, d)
    done = min_plus(d2b, spacing[1].repeat(18 * h))
    # The row scan and both K5 passes at the shapes the evaluation gives
    # them, on this volume's own maps, bit-equal to their plain versions.
    for name, out, plain in (
            ("row scan", d2, lambda: edt.row_scan_plain(masks, col)),
            ("K5 along H", d2a, lambda: min_plus_plain(
                d2.reshape(18, h, w * d), spacing[0].repeat(18))),
            ("K5 along W", done, lambda: min_plus_plain(
                d2b, spacing[1].repeat(18 * h)))):
        if not torch.equal(out, plain()):
            raise AssertionError(f"3D HD95's {name} {tuple(out.shape)} "
                                 "differs from its plain version")
    print(f"[{label}] 3D HD95's row scan {tuple(masks.shape)} and K5 "
          f"passes {(18, h, w * d)} and {tuple(d2b.shape)}: bit-equal to "
          "their plain versions on one volume's maps")
    done = done.reshape(2, 9, -1)
    flat_p, flat_t = ps.reshape(9, -1), ts.reshape(9, -1)
    parts = {
        "surfaces": surfaces,
        "row scan (along D)": lambda: edt.row_scan(masks, col),
        "K5 along H": lambda: min_plus(d2.reshape(18, h, w * d),
                                       spacing[0].repeat(18)),
        "K5 along W": lambda: min_plus(d2b, spacing[1].repeat(18 * h)),
        "percentiles (sort)": lambda: (
            hd95._masked_percentile_sqrt(done[0], flat_p, 95.0),
            hd95._masked_percentile_sqrt(done[1], flat_t, 95.0)),
    }
    ms = {k: time_ms(fn, 3) for k, fn in parts.items()}
    whole = time_ms(lambda: hd95.hd95_per_structure_device(
        preds, target, spacing=spacing), 3)
    # Bytes' bounds: the scan reads 18 boolean maps and writes them as
    # float32; a K5 pass reads and writes 18 float32 maps.
    voxels = 18 * h * w * d
    bounds = {"scan": bound_ms(0, 5 * voxels), "k5": bound_ms(0, 8 * voxels)}
    print(f"[{label}] HD95 of one {(h, w, d)} volume by part, ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; the whole function {whole:.3f}; the rest "
          f"{whole - sum(ms.values()):.3f}; the row scan's rows have "
          f"{d} elements (its segment loop starts above 256); bytes' bounds: "
          f"the scan {bounds['scan'][0]:.4f} ms "
          f"({bounds['scan'][0] / ms['row scan (along D)']:.2f} of its time),"
          f" a K5 pass {bounds['k5'][0]:.4f} ms "
          f"({bounds['k5'][0] / ms['K5 along H']:.2f} and "
          f"{bounds['k5'][0] / ms['K5 along W']:.2f})")
    # against scipy on the shallowest volume (scipy's EDT takes seconds a
    # map at this size)
    preds, target = labels_of(len(data.images) - 1)
    spc = data.spacings[-1][[1, 2, 0]]
    value, valid = hd95.hd95_per_structure_device(
        preds, target, spacing=torch.from_numpy(spc).to(DEVICE))
    host = hd95.hd95_per_structure(preds.cpu().numpy(), target.cpu().numpy(),
                                   spacing=spc)
    value, valid = value.cpu().numpy(), valid.cpu().numpy()
    if not np.array_equal(valid, ~np.isnan(host)) or not valid.any():
        raise AssertionError(f"3D HD95 valid {valid} vs scipy {host}")
    rel = float((np.abs(value - host)[valid] / host[valid]).max())
    if not rel <= HD95_RTOL:
        raise AssertionError(f"3D device HD95 vs scipy: {rel:.3e}")
    print(f"[{label}] 3D device HD95 vs scipy on one {tuple(preds.shape)} "
          "volume: "
          f"{int(valid.sum())} structures, worst relative difference "
          f"{rel:.3e} (bound {HD95_RTOL:.0e})")
    return {"scan": (ms["row scan (along D)"], bounds["scan"][0]),
            "k5": (ms["K5 along H"] + ms["K5 along W"], 2 * bounds["k5"][0])}


def _evaluate_3d_held(label, cfg, model):
    """The 3D evaluation with the kernels against the plain path, a CPU copy
    of the model, on one small volume: the blended logits, HD95 of the same
    label maps, and the whole evaluation's Dice."""
    import copy

    import torch
    from ctseg_tpu_torch.inference.evaluate import evaluate_3d_sliding_window
    from ctseg_tpu_torch.inference.sliding_window import (
        AIR_HU, pad_volume_dhw, padded_shape, volume_logits,
    )
    from ctseg_tpu_torch.metrics.hd95 import hd95_per_structure_device

    data = _volumes_3d(5, 1, HELD_VOLUME_3D, boxes=True, spacings=True)
    cpu_model = copy.deepcopy(model).to("cpu")
    d, h, w = HELD_VOLUME_3D
    shape = padded_shape((h, w, d), HELD_PATCH_3D)
    img = torch.from_numpy(
        pad_volume_dhw(data.images[0], shape, AIR_HU)).movedim(0, -1)
    t0 = time.perf_counter()
    plain = volume_logits(cpu_model, img, HELD_PATCH_3D, 0.5, 2, True)
    cpu_s = time.perf_counter() - t0
    card = volume_logits(model, img.to(DEVICE), HELD_PATCH_3D, 0.5, 2,
                         True).cpu()
    logit_err = float(((card - plain).abs() / (1 + plain.abs())).max())
    agree = float((card.argmax(-1) == plain.argmax(-1)).float().mean())
    if not logit_err <= LOGIT_TOL or not agree >= MIN_AGREEMENT:
        raise AssertionError(f"3D blended logits, card vs CPU: {logit_err:.3e}"
                             f", argmax agreement {agree:.5f}")
    preds = card.argmax(-1)[:h, :w, :d]
    target = torch.from_numpy(data.labels[0]).movedim(0, -1)
    spacing = torch.from_numpy(data.spacings[0][[1, 2, 0]])
    v_card, ok_card = hd95_per_structure_device(
        preds.to(DEVICE), target.to(DEVICE), spacing=spacing.to(DEVICE))
    v_cpu, ok_cpu = hd95_per_structure_device(preds, target, spacing=spacing)
    ok = ok_cpu.numpy()
    if not np.array_equal(ok_card.cpu().numpy(), ok) or not ok.any():
        raise AssertionError(f"3D HD95 valid: {ok_card} vs {ok_cpu}")
    hd_rel = float(((v_card.cpu() - v_cpu).abs() / v_cpu)[ok_cpu].max())
    if not hd_rel <= HD95_RTOL:
        raise AssertionError(f"3D HD95, card vs CPU on one map: {hd_rel:.3e}")
    kw = dict(patch_size=HELD_PATCH_3D, overlap=0.5, batch_size=2,
              with_hd95=True)
    on_card = evaluate_3d_sliding_window(model, cfg, data, device=DEVICE,
                                         **kw)
    on_cpu = evaluate_3d_sliding_window(cpu_model, cfg, data, device="cpu",
                                        **kw)
    dice = max(abs(on_card["per_structure_dice"][s] - v)
               for s, v in on_cpu["per_structure_dice"].items())
    if dice > DICE_TOL_3D:
        raise AssertionError(f"3D evaluation Dice, card vs CPU: {dice:.3e}")
    print(f"[{label}] 3D evaluation of one {HELD_VOLUME_3D} volume, the "
          f"card's kernels against a CPU copy's plain path: blended logits "
          f"within {logit_err:.3e} of (1 + |plain|) (bound {LOGIT_TOL:.0e}), "
          f"argmax agreement {agree:.5f}; HD95 of the same map within "
          f"{hd_rel:.3e} relative on {int(ok.sum())} structures (bound "
          f"{HD95_RTOL:.0e}); the whole evaluation's Dice within {dice:.3e} "
          f"(bound {DICE_TOL_3D:.0e}); the CPU's logits took {cpu_s:.1f} s")


def phase_serve_3d(label, workdir: Path, ckpt: Path):
    """predict_scan and one served request of the patch-mode checkpoint."""
    import torch
    from ctseg_tpu_torch.inference.predict import predict_scan
    from ctseg_tpu_torch.inference.serve import SegmentationService, serve
    from ctseg_tpu_torch.testing.synth import make_patient
    from ctseg_tpu_torch.utils import nrrd_io
    from ctseg_tpu_torch.utils.miccai import Volume

    scan = make_patient(workdir / "0522c0100", shape=SCAN, seed=9,
                        with_landmarks=False)
    service = SegmentationService(str(ckpt), DEVICE, patch_size=EVAL_PATCH_3D)
    volume = Volume.from_nrrd(scan / "img.nrrd")
    shapes = _k1_shapes(lambda: predict_scan(
        service.model, service.config, volume, DEVICE,
        patch_size=EVAL_PATCH_3D))
    t0 = time.perf_counter()
    labels = predict_scan(service.model, service.config, volume, DEVICE,
                          patch_size=EVAL_PATCH_3D)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    if labels.shape != SCAN or labels.dtype != np.uint8 or labels.max() > 9:
        raise AssertionError(f"3D predict_scan gave {labels.shape} "
                             f"{labels.dtype}")
    httpd = serve(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        status, payload = _request(httpd.server_address[1], "POST",
                                   "/segment", (scan / "img.nrrd").read_bytes())
        lat = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if status != 200:
        raise AssertionError(f"/segment answered {status}: {payload[:300]!r}")
    out = workdir / "seg3d.nrrd"
    out.write_bytes(payload)
    served, _ = nrrd_io.read(out)
    moved = int((np.transpose(served, (2, 0, 1)) != labels).sum())
    if moved > 1e-3 * labels.size:
        raise AssertionError(f"served map differs from predict_scan's in "
                             f"{moved} voxels")
    print(f"[{label}] 3D checkpoint: predict_scan of one {SCAN} scan "
          f"(cropped to the anatomical box) {predict_s:.3f} s; one served "
          f"request {lat:.3f} s, {moved} voxels from predict_scan's map")
    _hold_k1_at(label, "3D predict", shapes,
                torch.Generator(device=DEVICE).manual_seed(10),
                backward=False)


# ----------------------------------------------- the default 2D workflow
PATIENT_DEPTH = 28      # phase 22: slices a patient (PDDCA: 100-200)
PATIENT_HW = (512, 512)
PATIENT_IDS = list(range(1, 34)) + list(range(555, 570))  # the 48 of PDDCA
WORKFLOW_EPOCHS = 2     # phase 23's CLI run
# Degree 0 (and 1, 3, 4) run K1, K1b, K2 and K2b as degree 2 does; their
# transforms are plain torch (no TPU kernel is replaced there), so no K4.
PER_STEP_D0 = dict(PER_STEP, k4=0)
DEGREE_STEPS = 2        # phase 25's steps at each of degrees 1, 3 and 4
IMAGE_TOL_CPU = 1e-5    # phase 26: |card - CPU| of a transform's images
HALF_EPS = 1e-4         # phase 26: a label may differ within this of a half


def _run_module(args, storage: Path):
    """`python -m <args>` from the checkout with CTSEG_DATA_STORAGE set;
    its seconds (host clock). Its output goes to ours."""
    import os

    env = dict(os.environ, CTSEG_DATA_STORAGE=str(storage))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m"] + args,
                         cwd=Path(__file__).resolve().parent, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(args)} exited {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    seconds = time.perf_counter() - t0
    return seconds, out.stdout


def phase_data_prep(label, workdir: Path):
    """48 synthetic PDDCA patients of 512x512 slices, then the reference's
    preparation CLIs: the split, conversion with the anatomical crop,
    packing and the dataset statistics."""
    import multiprocessing

    from ctseg_tpu_torch.data.datasets import PackedDataset2D
    from ctseg_tpu_torch.testing.synth import make_patient

    storage = workdir / "storage"
    raw = storage / "miccai"
    jobs = [(raw / f"0522c{pid:04d}", (PATIENT_DEPTH,) + PATIENT_HW, None, i,
             pid < 480) for i, pid in enumerate(PATIENT_IDS)]
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(8) as pool:
        pool.starmap(make_patient, jobs)
    made = time.perf_counter() - t0
    times = {}
    times["download miccai --no_download"], _ = _run_module(
        ["ctseg_tpu_torch.data.download", "miccai", "--no_download"], storage)
    split = {s: len(list((raw / s).iterdir())) for s in ("train", "valid",
                                                         "test")}
    if split != {"train": 25, "valid": 8, "test": 15}:
        raise AssertionError(f"split {split}")
    times["process_miccai convert_2d"], _ = _run_module(
        ["ctseg_tpu_torch.data.process_miccai", "convert_2d"], storage)
    times["process_miccai pack_2d"], packed = _run_module(
        ["ctseg_tpu_torch.data.process_miccai", "pack_2d"], storage)
    times["stats"], report = _run_module(["ctseg_tpu_torch.data.stats"],
                                         storage)
    report = json.loads(report)
    weights = report["class_weights"]["derived"]
    if not all(np.isfinite(list(weights.values()))):
        raise AssertionError(f"class weights {weights}")
    data_dir = storage / "miccai_2d"
    sizes = {s: len(PackedDataset2D.load(data_dir / f"{s}_packed.npz"))
             for s in ("train", "valid", "test")}
    train = PackedDataset2D.load(data_dir / "train_packed.npz")
    if train.images.shape[1:] != (280, 280) or sizes["train"] < TRAIN_BATCH:
        raise AssertionError(f"packed train split {train.images.shape}")
    print(f"[{label}] data preparation: 48 synthetic patients of "
          f"{PATIENT_DEPTH}x{PATIENT_HW[0]}x{PATIENT_HW[1]} (depth cut from "
          f"PDDCA's 100-200 slices to fit the time limit; made in "
          f"{made:.3f} s by 8 processes), split 25/8/15; host seconds: "
          + "; ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; packed slices {sizes} of {train.images.shape[1:]} (the "
          f"anatomical crop); {packed.strip().splitlines()[0]}; derived "
          f"stacked-window mean "
          f"{report['stacked_window_stats']['derived']['mean']}")
    return data_dir, sizes


def phase_default_workflow(label, workdir: Path, data_dir: Path, sizes):
    """The reference's default workflow through the port's train CLI:
    degree 0 (one soft-tissue channel, crop, OneOf(elastic, grid)), Model
    L's width, batch 128, 256 crops, 2 epochs, a save and example panels
    every epoch, a profile of the fit."""
    import torch
    from ctseg_tpu_torch.training import checkpoint, cli

    ck = workdir / "default_run"
    steps = sizes["train"] // TRAIN_BATCH
    reset_launches()
    t0 = time.perf_counter()
    cli.main(["train", "--data_dir", str(data_dir), "--device", DEVICE,
              "--use_res_units", "--exclude_missing", "--max_epochs",
              str(WORKFLOW_EPOCHS), "--checkpoint_dir", str(ck),
              "--checkpoint_every", "1", "--profile"])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for key in ("k1", "k1b", "k2", "k2b"):
        if launches[key] < PER_STEP_D0[key] * steps * WORKFLOW_EPOCHS:
            raise AssertionError(f"the CLI run launched {launches}")
    if launches["k4"] != 0:
        raise AssertionError(f"degree 0 launched K4: {launches}")
    logs = [json.loads(line) for line in
            (ck / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss/total"] for r in logs if "train/loss/total" in r]
    val = [r["val/dice/mean"] for r in logs if "val/dice/mean" in r]
    if len(losses) != WORKFLOW_EPOCHS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"train losses {losses}")
    cfg, state = checkpoint.load(ck / "model.ckpt", "cpu")
    stem = state.model.state_dict()["unet.model.0.conv.unit0.conv.weight"]
    if (cfg.transform_degree, stem.shape[1], cfg.filters, cfg.batch_size,
            cfg.num_res_units, state.step) != (
            0, 1, FILTERS, TRAIN_BATCH, 2, steps * WORKFLOW_EPOCHS):
        raise AssertionError(f"the run's checkpoint: {cfg}, step {state.step}")
    panels = {e: len(list((ck / "examples" / f"epoch_{e:04d}").glob("*.npy")))
              for e in range(1, WORKFLOW_EPOCHS + 1)}
    if panels != {e: 8 for e in panels}:
        raise AssertionError(f"example panels {panels}")
    trace = ck / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if kernels == 0:
        raise AssertionError("the profile holds no kernel")
    print(f"[{label}] train CLI, its defaults (degree 0, 1 channel in) at "
          f"Model L's width, batch {TRAIN_BATCH}, {WORKFLOW_EPOCHS} epochs "
          f"of {steps} steps with validation of {sizes['valid']} slices, an "
          f"async save and 8 example panels every epoch, --profile: "
          f"{seconds:.3f} s (host clock, the first steps and the trace's "
          f"export included); train losses {[round(v, 5) for v in losses]}, "
          f"val Dice {[round(v, 5) for v in val]}; launches {launches}; "
          f"checkpoint step {state.step}; trace {trace.stat().st_size} "
          f"bytes, {kernels} kernel events")
    del state
    torch.cuda.empty_cache()


def _sync_warnings(fn):
    """fn() under torch's sync debug mode: the warnings of the operations
    that made the host wait for the card, as (file:line, message)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [(f"{Path(w.filename).name}:{w.lineno}", str(w.message)[:80])
            for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def _model_l_degree(degree):
    import dataclasses

    return dataclasses.replace(_model_l_config(), transform_degree=degree)


def phase_train_degree0(label, workdir: Path):
    """Model L at degree 0 as phase 9 times degree 2: 2 warm-up and 5 timed
    steps on one fixed batch with fixed draws, the launches asserted, no
    host sync in a step; an async save while the loop goes on; the step by
    group of kernels; then Model M at degree 0 (K5 in its step)."""
    import torch
    from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
    from ctseg_tpu_torch.training import checkpoint
    from ctseg_tpu_torch.training.trainer import Trainer

    trainer = Trainer(_model_l_degree(0), DEVICE)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    train = DevicePipeline2D(_synthetic_split(0, 2 * TRAIN_BATCH),
                             TRAIN_BATCH, DEVICE)
    batch = next(train.epoch(torch.Generator(device=DEVICE).manual_seed(2)))
    draws = trainer.draw(torch.Generator(device=DEVICE).manual_seed(3),
                         batch[0])
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):  # warm-up
        state, metrics = trainer.train_step(state, batch, draws)
    torch.cuda.synchronize()
    reset_launches()
    losses = []

    def timed():
        nonlocal state
        for _ in range(TIMED_STEPS):
            state, metrics = trainer.train_step(state, batch, draws)
            losses.append(metrics["loss/total"])

    t0 = time.perf_counter()
    syncs = _sync_warnings(timed)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * TIMED_STEPS for k, v in PER_STEP_D0.items()}
    if launches != want:
        raise AssertionError(f"degree 0 launches {launches} over "
                             f"{TIMED_STEPS} steps; want {want}")
    if syncs:
        raise AssertionError(f"{len(syncs)} host syncs in {TIMED_STEPS} "
                             f"degree-0 steps: {sorted(set(syncs))}")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"degree-0 losses {losses}")
    print(f"[{label}] train step, Model L degree 0 float32 batch "
          f"{TRAIN_BATCH}: {step_s * 1e3:.3f} ms/step, "
          f"{TRAIN_BATCH / step_s:.2f} slices/s (host clock over "
          f"{TIMED_STEPS} steps after 2 warm-ups; branch choices "
          f"{torch.bincount(draws.choice.long()).tolist()}); peak device "
          f"memory {peak / 2**30:.3f} GiB; host syncs 0 (sync debug mode); "
          f"losses {[round(v, 5) for v in losses]}; launches {launches}")

    # The async save: the file holds the state at the save while the loop
    # takes 2 more steps. Beside it, the synchronous save and 2 steps
    # without a save (host clock).
    def two_steps():
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(2):
            state, _ = trainer.train_step(state, batch, draws)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    trainer.save(workdir / "sync.ckpt", state)
    sync_ms = (time.perf_counter() - t0) * 1e3
    bare_ms = two_steps()
    saver = checkpoint.AsyncCheckpointer()
    path = workdir / "async.ckpt"
    save_ms, loop_ms = [], []
    for _ in range(2):  # the second save finds the allocator's blocks
        saver.wait()
        want_sd = {k: v.cpu().clone()
                   for k, v in state.model.state_dict().items()}
        want_step = state.step
        t0 = time.perf_counter()
        saver.save(path, trainer.config, state)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        loop_ms.append((time.perf_counter() - t0) * 1e3 + two_steps())
    saver.wait()
    _, saved = checkpoint.load(path, "cpu")
    if saved.step != want_step or not all(
            torch.equal(v, want_sd[k])
            for k, v in saved.model.state_dict().items()):
        raise AssertionError("the async checkpoint is not the state at the "
                             "save")
    if all(torch.equal(v.cpu(), want_sd[k])
           for k, v in state.model.state_dict().items()):
        raise AssertionError("the loop did not go on")
    print(f"[{label}] checkpoint of {path.stat().st_size} bytes, host "
          f"clock: the synchronous save {sync_ms:.3f} ms; 2 steps alone "
          f"{bare_ms:.3f} ms; the async save() returned in "
          f"{save_ms[0]:.3f} and {save_ms[1]:.3f} ms, with 2 steps behind "
          f"each {loop_ms[0]:.3f} and {loop_ms[1]:.3f} ms; the file equals "
          f"the state at step {want_step} (the loop reached {state.step})")
    del saved
    profile_step(label, "Model L degree-0 train step",
                 lambda: trainer.train_step(state, batch, draws))

    # Model M at degree 0: the Boundary loss's maps on the row scan, K5 and
    # the signed-map kernel.
    import dataclasses

    del trainer, state
    torch.cuda.empty_cache()
    trainer_m = Trainer(dataclasses.replace(_model_m_config(),
                                            transform_degree=0), DEVICE)
    state_m = trainer_m.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    reset_launches()
    losses_m = []
    for _ in range(2):
        state_m, metrics = trainer_m.train_step(state_m, batch, generator=gen)
        losses_m.append(float(metrics["loss/total"]))
    launches_m = read_launches()
    want_m = {k: 2 * v for k, v in dict(PER_STEP_M, k4=0).items()}
    if launches_m != want_m or not all(np.isfinite(losses_m)):
        raise AssertionError(f"Model M degree 0: launches {launches_m}, "
                             f"want {want_m}; losses {losses_m}")
    print(f"[{label}] Model M at degree 0: 2 steps, losses "
          f"{[round(v, 5) for v in losses_m]}, launches {launches_m}")
    del trainer_m, state_m
    torch.cuda.empty_cache()
    return launches, launches_m, step_s


def phase_other_degrees(label):
    """One 3-channel model trained 2 steps at each of degrees 1, 3 and 4
    (the same weights throughout), each degree's transform on the card
    timed on a batch of 128 (degrees 0 and 2 too), CUDA events."""
    import torch
    from ctseg_tpu_torch.data.pipeline import DevicePipeline2D
    from ctseg_tpu_torch.training.trainer import Trainer

    train = DevicePipeline2D(_synthetic_split(0, 2 * TRAIN_BATCH),
                             TRAIN_BATCH, DEVICE)
    batch = next(train.epoch(torch.Generator(device=DEVICE).manual_seed(5)))
    state = None
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    per_degree = {}
    for degree in (1, 3, 4):
        trainer = Trainer(_model_l_degree(degree), DEVICE)
        if state is None:
            state = trainer.init_state(torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        losses = []
        for _ in range(DEGREE_STEPS):
            state, metrics = trainer.train_step(state, batch, generator=gen)
            losses.append(float(metrics["loss/total"]))
        seconds = (time.perf_counter() - t0) / DEGREE_STEPS
        launches = read_launches()
        if launches != {k: DEGREE_STEPS * v for k, v in PER_STEP_D0.items()} \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"degree {degree}: launches {launches}, "
                                 f"losses {losses}")
        per_degree[degree] = (seconds * 1e3, losses)
    print(f"[{label}] degrees 1, 3 and 4 on one model, {DEGREE_STEPS} steps "
          "each (host clock, ms/step, the first steps included; losses): "
          + "; ".join(f"degree {d} {ms:.3f} {[round(v, 5) for v in ls]}"
                      for d, (ms, ls) in per_degree.items())
          + f"; launches per step {PER_STEP_D0}")

    from ctseg_tpu_torch.transforms.pipelines import get_transform

    transform_ms = {}
    for degree in range(5):
        transform = get_transform(degree, True)
        draws = transform.draw(torch.Generator(device=DEVICE).manual_seed(7),
                               tuple(batch[0].shape), DEVICE)
        transform_ms[degree] = time_ms(
            lambda: transform(batch[0], batch[1], draws), 20)
    print(f"[{label}] train transform of a batch of {TRAIN_BATCH} raw "
          f"{RAW}x{RAW} slices to {SIZE}x{SIZE}, ms (CUDA events, 20 calls): "
          + "; ".join(f"degree {d} {ms:.4f}" for d, ms in transform_ms.items())
          + " (degree 2: K4 and the labels' moves; 1: the test transform; "
          "0, 3, 4: crop, windows, both warps' coordinates, one pair of "
          "gathers)")
    del state
    torch.cuda.empty_cache()
    return transform_ms


def _warp_coords(degree, draws):
    """The two passes' coordinates a degree-0/3/4 transform used."""
    import torch
    from ctseg_tpu_torch.transforms import augment

    size = SIZE
    cy, cx = augment.elastic_coords(draws.elastic, size, size)
    if degree == 3:
        return cy, cx
    gy, gx = augment.grid_coords(draws.grid, size, size)
    pick = (draws.choice == 1)[:, None, None]
    return torch.where(pick, gy, cy), torch.where(pick, gx, cx)


def _label_risk(cy, cx, eps):
    """Output pixels whose label may round either way (torch, (N, H, W)):
    the horizontal coordinate within eps of a half, or one of the two
    mid-pass pixels it reads has its vertical coordinate there."""
    import torch

    def near(c):
        return torch.abs(c - torch.floor(c) - 0.5) < eps

    risk_v = near(cy)
    w = cx.shape[2]
    lo = torch.clamp(torch.floor(cx).long(), 0, w - 1)
    hi = torch.clamp(lo + 1, 0, w - 1)
    return (near(cx) | torch.gather(risk_v, 2, lo)
            | torch.gather(risk_v, 2, hi))


def phase_transforms_vs_cpu(label):
    """Each degree's train transform on the card against the same function
    on the CPU, with the same draws moved across: images within
    IMAGE_TOL_CPU, labels equal except where a warp's source coordinate
    lies within HALF_EPS of a half-integer (counted)."""
    import torch
    from ctseg_tpu_torch.transforms.augment import move_draws
    from ctseg_tpu_torch.transforms.pipelines import get_transform

    split = _synthetic_split(8, TRAIN_BATCH)
    images = torch.as_tensor(split.images)
    labels = torch.as_tensor(split.labels)
    rows = []
    for degree in range(5):
        transform = get_transform(degree, True)
        draws = transform.draw(torch.Generator(device=DEVICE).manual_seed(9),
                               tuple(images.shape), DEVICE)
        img, lab = transform(images.to(DEVICE), labels.to(DEVICE), draws)
        cpu_draws = move_draws(draws, "cpu")
        want_img, want_lab = transform(images, labels, cpu_draws)
        err = float((img.cpu() - want_img).abs().max())
        if not err <= IMAGE_TOL_CPU or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"degree {degree}: images differ by {err}")
        differ = lab.cpu() != want_lab
        risk = torch.zeros_like(differ)
        if degree in (0, 3, 4):
            risk = _label_risk(*_warp_coords(degree, cpu_draws), HALF_EPS)
        if bool((differ & ~risk).any()):
            raise AssertionError(
                f"degree {degree}: {int((differ & ~risk).sum())} labels "
                "differ away from a half")
        rows.append(f"degree {degree}: images {err:.3e}, labels differing "
                    f"{int(differ.sum())} of {differ.numel()} (within "
                    f"{HALF_EPS} of a half: {int(risk.sum())})")
    print(f"[{label}] train transforms on the card vs the CPU, {TRAIN_BATCH} "
          f"slices, the same draws: " + "; ".join(rows))


# ------------------------- export, GradCAM, released names, the front door
EXPORT_SLICE = (280, 280)  # phase 27: the native slice shape baked in
EXPORT_TIMED = 5           # phase 27: timed calls per artifact
LABEL_TOL = 1e-3           # phases 27-28: share of labels that may differ
                           # (cuDNN near-ties, as phase 4's requests)
GRADCAM_SAMPLES = 16       # phase 28: 2 batches of 8
GRADCAM_BATCH = 8
GRADCAM_LAYER = "feat_down1"
CAM_REFEREE_FACTOR = 2     # phase 28: the card's median map error against
                           # a float64 referee, against the CPU float32 one's
CAM_WORST_RTOL = 1e-2      # phase 28: the card's worst map, of its max


def _region(scan: Path, n: int):
    """The first n cropped 280x280 slices of a synthetic scan, raw HU."""
    from ctseg_tpu_torch.utils.miccai import CropBox, Volume

    data = Volume.from_nrrd(scan / "img.nrrd").as_numpy()[0]
    region = CropBox.anatomical(data.shape[0]).apply(data[None])[0]
    return np.asarray(region[:n], np.float32)


def _label_share(a, b) -> float:
    return float(np.mean(np.asarray(a) != np.asarray(b)))


_TORCH_ONLY_LOADER = """
import sys
sys.modules["ctseg_tpu_torch"] = None  # any import of the port raises
import numpy as np, torch
from torch.export.passes import move_to_device_pass
torch.backends.cudnn.allow_tf32 = False  # float32 convs, as the port runs them
ep = move_to_device_pass(torch.export.load(sys.argv[1]), "cuda")
fn = ep.module()
with torch.inference_mode():
    out = fn(torch.from_numpy(np.load(sys.argv[2])).cuda())
np.save(sys.argv[3], out.cpu().numpy())
print("torch-only load ok", tuple(out.shape), out.dtype)
"""


def phase_export(label, workdir: Path, ckpt: Path, scan: Path, ckpt_3d: Path):
    """Phase 27: Model L exported with the kernels (`--platforms cuda`) and
    portable, in float32 and bfloat16, and a 3D patch scorer."""
    import torch
    from ctseg_tpu_torch.inference.export import (
        export_checkpoint, load_exported,
    )
    from ctseg_tpu_torch.inference.predict import slice_labels
    from ctseg_tpu_torch.inference.sliding_window import model_apply_fn
    from ctseg_tpu_torch.training.config import load_checkpoint
    from ctseg_tpu_torch.transforms.pipelines import get_transform
    from ctseg_tpu_torch.transforms.windowing import apply_window

    out = workdir / "export"
    t0 = time.perf_counter()
    paths = {
        "kernel": export_checkpoint(ckpt, out / "kernel.pt2", EXPORT_SLICE,
                                    platforms=("cuda",), device=DEVICE),
        "portable": export_checkpoint(ckpt, out / "portable.pt2",
                                      EXPORT_SLICE, device=DEVICE),
        "kernel_bf16": export_checkpoint(
            ckpt, out / "kernel_bf16.pt2", EXPORT_SLICE, platforms=("cuda",),
            infer_dtype="bfloat16", device=DEVICE),
    }
    export_s = time.perf_counter() - t0
    metas = {k: json.loads(Path(str(p) + ".json").read_text())
             for k, p in paths.items()}
    if metas["portable"]["custom_ops"] or not metas["kernel"]["custom_ops"]:
        raise AssertionError(f"custom ops: {metas}")
    fns = {k: load_exported(p, device=DEVICE) for k, p in paths.items()}

    config, model = load_checkpoint(ckpt, DEVICE)
    transform = get_transform(config.transform_degree, train=False,
                              size=(config.input_size,) * 2)
    slices = _region(scan, BATCH)
    x32 = torch.from_numpy(slices).to(DEVICE)
    eager = {}  # predict's forward at each batch and compute dtype
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            model.compute_dtype = dtype
            for n in (BATCH, 1):
                eager[(dtype, n)] = slice_labels(
                    model, transform, x32[:n], dtype).cpu().numpy()
        model.compute_dtype = torch.float32
    want = {"kernel": (8, 9), "portable": (0, 0), "kernel_bf16": (8, 9)}
    labels, launches, shares = {}, {}, {}
    for kind, fn in fns.items():
        for n in (BATCH, 1):
            reset_launches()
            with torch.inference_mode():
                got = fn(x32[:n]).cpu().numpy()
            seen = read_launches()
            if (seen["k1"], seen["k2"]) != want[kind] or got.shape != (
                    n, *EXPORT_SLICE) or got.dtype != np.uint8:
                raise AssertionError(
                    f"{kind} artifact, batch {n}: K1/K2 launches "
                    f"{seen['k1']}/{seen['k2']} (want {want[kind]}), "
                    f"{got.shape} {got.dtype}")
            ref = eager[(torch.bfloat16 if kind == "kernel_bf16"
                         else torch.float32, n)]
            shares[f"{kind} batch {n}"] = _label_share(got, ref)
            if shares[f"{kind} batch {n}"] > LABEL_TOL:
                raise AssertionError(f"{kind} artifact, batch {n}: "
                                     f"{shares[f'{kind} batch {n}']:.5f} of "
                                     "labels differ from predict's")
            if n == BATCH:
                launches[kind] = seen
                labels[kind] = got
    apart = _label_share(labels["kernel"], labels["portable"])
    if apart > LABEL_TOL:
        raise AssertionError(f"kernel and portable artifacts: {apart:.5f}")

    # Every K1 and K2 shape of a kernel artifact's call at batch 1, in both
    # types, held to its plain version: the artifacts launch the eager
    # model's shapes, and the kernels' plans depend on the batch.
    def batch_1():
        with torch.inference_mode():
            for dtype in (torch.float32, torch.bfloat16):
                model.compute_dtype = dtype
                slice_labels(model, transform, x32[:1], dtype)
        model.compute_dtype = torch.float32

    _hold_sites(label, "an export call at batch 1", _site_shapes(batch_1),
                torch.Generator(device=DEVICE).manual_seed(27))

    # The portable artifact in a process that cannot import the port.
    np.save(out / "slices.npy", slices)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", _TORCH_ONLY_LOADER, str(paths["portable"]),
         str(out / "slices.npy"), str(out / "torch_only.npy")],
        cwd=out, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"torch-only loader: {r.stderr[-3000:]}")
    alone = _label_share(np.load(out / "torch_only.npy"), labels["portable"])
    if alone > LABEL_TOL:
        raise AssertionError(f"torch-only run vs in-process: {alone:.5f}")
    loader_s = time.perf_counter() - t0

    with torch.inference_mode():
        times = {k: time_ms(lambda f=f: f(x32), EXPORT_TIMED)
                 for k, f in fns.items()}
        times["eager"] = time_ms(lambda: slice_labels(model, transform, x32),
                                 EXPORT_TIMED)
    del fns, model
    torch.cuda.empty_cache()

    # 3D: the patch scorer with the kernels, against the eager model.
    p3 = export_checkpoint(ckpt_3d, out / "patch.pt2",
                           patch_size=EVAL_PATCH_3D, platforms=("cuda",),
                           device=DEVICE)
    fn3 = load_exported(p3, device=DEVICE)
    _, m3 = load_checkpoint(ckpt_3d, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(27)
    patches = torch.randn((EVAL_BATCH_3D, *EVAL_PATCH_3D), generator=gen,
                          device=DEVICE) * 300 + 40
    reset_launches()
    with torch.inference_mode():
        got3 = fn3(patches)
    seen3 = read_launches()
    with torch.inference_mode():
        ref3 = model_apply_fn(m3)(apply_window(patches[..., None], 350, 20))
    err3 = float(((got3.float() - ref3.float()).abs()
                  / (1 + ref3.float().abs())).max())
    if seen3["k1"] != PER_STEP_3D["k1"] or got3.shape != (
            EVAL_BATCH_3D, *EVAL_PATCH_3D, 10) or not err3 <= LOGIT_TOL:
        raise AssertionError(f"3D artifact: {seen3['k1']} K1 launches, "
                             f"{tuple(got3.shape)}, error {err3:.3e}")
    with torch.inference_mode():
        ms3 = time_ms(lambda: fn3(patches), 3)
        eager3 = time_ms(lambda: model_apply_fn(m3)(
            apply_window(patches[..., None], 350, 20)), 3)
    del fn3, m3
    torch.cuda.empty_cache()
    print(f"[{label}] export of full-width Model L at {EXPORT_SLICE} (3 "
          f"artifacts, {export_s:.3f} s host; sizes "
          + ", ".join(f"{k} {p.stat().st_size}" for k, p in paths.items())
          + f" bytes): launches K1/K2 at batch {BATCH} and 1: kernel 8/9, "
          "bfloat16 kernel 8/9, portable 0/0 (FP32-pipe route 0); share of "
          "labels differing from predict_labels_2d's forward: "
          + ", ".join(f"{k} {v:.6f}" for k, v in shares.items())
          + f"; kernel vs portable {apart:.6f}; torch-only process (port "
          f"unimportable) vs in-process portable {alone:.6f} ({loader_s:.3f}"
          f" s); ms a batch of {BATCH} (CUDA events): kernel "
          f"{times['kernel']:.3f}, bfloat16 kernel {times['kernel_bf16']:.3f},"
          f" portable {times['portable']:.3f}, eager predict forward "
          f"{times['eager']:.3f}; 3D patch scorer at batch {EVAL_BATCH_3D} x "
          f"{EVAL_PATCH_3D}: {seen3['k1']} K1 launches a call, logits within "
          f"{err3:.3e} of (1 + |eager|), {ms3:.3f} ms a call (eager "
          f"{eager3:.3f})")
    return {"launches": {k: launches[k] for k in ("kernel", "portable")},
            "launches_3d": seen3, "ms": times, "ms_3d": ms3,
            "eager_ms_3d": eager3}


def _sites_after(model, layer: str):
    """(K1 sites, K2 sites) that run after `layer` in the forward: the
    units GradCAM's backward passes go through, from the model's topology
    (each unit's forward hook records the order on a small input)."""
    import torch
    from ctseg_tpu_torch.interpret.gradcam import layers
    from ctseg_tpu_torch.models.layers import ConvTransposeUnit, ConvUnit

    order, handles = [], []
    for m in model.modules():
        if isinstance(m, (ConvUnit, ConvTransposeUnit)) and \
                m.act is not None:
            kind = "k2" if getattr(m, "fused", False) else "k1"
            handles.append(m.register_forward_hook(
                lambda *_, k=kind: order.append(k)))
    handles.append(layers(model)[layer].register_forward_hook(
        lambda *_: order.append("layer")))
    try:
        x = torch.zeros((1, 3, 64, 64), device=DEVICE)
        with torch.inference_mode():
            model(x.contiguous(memory_format=torch.channels_last))
    finally:
        for h in handles:
            h.remove()
    after = order[order.index("layer") + 1:]
    return after.count("k1"), after.count("k2")


def phase_gradcam(label, workdir: Path, ckpt: Path, data_dir: Path):
    """Phase 28: run_interpretability at Model L's width on the packed test
    split, and its maps against a CPU copy's plain path."""
    import copy

    import torch
    from ctseg_tpu_torch.data.datasets import PackedDataset2D
    from ctseg_tpu_torch.interpret.gradcam import (
        class_activation_maps, gradcam_all_structures,
    )
    from ctseg_tpu_torch.interpret.run import run_interpretability
    from ctseg_tpu_torch.models.layers import channels_last
    from ctseg_tpu_torch.training.config import load_checkpoint
    from ctseg_tpu_torch.transforms.pipelines import get_transform

    config, model = load_checkpoint(ckpt, DEVICE)
    dataset = PackedDataset2D.load(data_dir / "test_packed.npz")
    k1_sites, k2_sites = _sites_after(model, GRADCAM_LAYER)
    # The JAX script's filter is 5 structures; the synthetic slices carry
    # fewer on some: the largest count that keeps 16 samples.
    counts = dataset.indicators.sum(axis=1)
    min_structures = next(m for m in range(5, -1, -1)
                          if (counts >= m).sum() >= GRADCAM_SAMPLES)
    out = workdir / "gradcam"
    run_interpretability(config, model, dataset, out / "warm", 2,
                         min_structures, GRADCAM_LAYER, 2)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    done = run_interpretability(config, model, dataset, out / "run",
                                GRADCAM_SAMPLES, min_structures,
                                GRADCAM_LAYER, GRADCAM_BATCH)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    seen = read_launches()
    batches = -(-GRADCAM_SAMPLES // GRADCAM_BATCH)
    want = {"k1": 8, "k2": 9, "k1b": 9 * k1_sites, "k2b": 9 * k2_sites}
    if done != GRADCAM_SAMPLES or any(seen[k] != v * batches
                                      for k, v in want.items()):
        raise AssertionError(f"GradCAM: {done} samples, launches {seen} "
                             f"over {batches} batches, want {want} a batch")
    per_batch = {k: seen[k] // batches for k in want}
    cams = sorted((out / "run").glob("*_gradcam.npy"))
    if len(cams) != GRADCAM_SAMPLES or len(list(
            (out / "run").glob("*_pred.npy"))) != GRADCAM_SAMPLES:
        raise AssertionError(f"GradCAM wrote {len(cams)} maps")
    for p in cams:
        m = np.load(p)
        if m.shape != (9, SIZE, SIZE) or not np.isfinite(m).all() \
                or m.min() < 0:
            raise AssertionError(f"{p.name}: {m.shape}, min {m.min()}")

    # The GradCAM alone on one batch (CUDA events): run_interpretability's time above
    # also holds the transform, the copies and the files.
    keep = np.flatnonzero(counts >= min_structures)[:GRADCAM_BATCH]
    transform = get_transform(config.transform_degree, train=False,
                              size=(config.input_size,) * 2)
    img, _ = transform(torch.from_numpy(dataset.images[keep].astype(
        np.float32)).to(DEVICE))
    x8 = channels_last(img.permute(0, 3, 1, 2))
    cam_ms = time_ms(lambda: class_activation_maps(
        model, x8, range(1, 10), GRADCAM_LAYER), 3)
    # Each K1 and K2 shape of one batch held to its plain version, the
    # training forms (after the layer) with K1b and K2b.
    sites = _site_shapes(lambda: class_activation_maps(
        model, x8, range(1, 10), GRADCAM_LAYER))
    calls = {k: sum(v.values()) for k, v in sites.items()}
    if calls != {("k1", False): 8 - k1_sites, ("k1", True): k1_sites,
                 ("k2", False): 9 - k2_sites, ("k2", True): k2_sites}:
        raise AssertionError(f"GradCAM's forward made {calls} calls")
    del img, x8
    _hold_sites(label, f"a GradCAM batch of {GRADCAM_BATCH}", sites,
                torch.Generator(device=DEVICE).manual_seed(28))

    # Two slices' maps on the card and on a CPU copy's plain path, both
    # float32, each held to a float64 CPU copy (the referee). The gradient
    # at the layer is ill-conditioned in float32 (on either path up to about
    # 0.1 of its max from the referee, some 0.01 at the median), and a map
    # is a ReLU of a sum over the channels that cancels: the CPU's float32
    # maps are up to 2e-3 of their max from the referee. The card's median
    # map error may be at most CAM_REFEREE_FACTOR times the CPU's, its
    # worst map at most CAM_WORST_RTOL of the map's max.
    keep = keep[:2]
    img, _ = transform(torch.from_numpy(dataset.images[keep].astype(
        np.float32)))
    x = channels_last(img.permute(0, 3, 1, 2))
    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    plain = gradcam_all_structures(cpu_model, x, GRADCAM_LAYER)
    cpu_s = time.perf_counter() - t0
    cpu_model.to(torch.float64).compute_dtype = torch.float64
    referee = gradcam_all_structures(cpu_model, x.double(), GRADCAM_LAYER)
    card = gradcam_all_structures(model, x.to(DEVICE), GRADCAM_LAYER).cpu()
    scale = referee.flatten(2).abs().amax(-1)

    def rel(maps):
        """(worst, median) over the maps of |maps - referee| / its max."""
        err = (maps.double() - referee).abs().flatten(2).amax(-1)
        err = err / scale.clamp_min(1e-30)
        return float(err.max()), float(err.median())

    card_err, plain_err = rel(card), rel(plain)
    apart = float(((card - plain).abs().flatten(2).amax(-1)
                   / scale.clamp_min(1e-30)).max())
    if not card_err[1] <= CAM_REFEREE_FACTOR * plain_err[1] + 1e-7 \
            or not card_err[0] <= CAM_WORST_RTOL \
            or not bool((scale > 0).any()):
        raise AssertionError(
            f"GradCAM against float64, (worst, median) of each map's max: "
            f"card {card_err}, CPU float32 {plain_err}")
    del cpu_model
    print(f"[{label}] GradCAM of full-width Model L at {GRADCAM_LAYER} "
          f"({k1_sites} K1 and {k2_sites} K2 sites after it), "
          f"run_interpretability on {done} test slices (at least "
          f"{min_structures} structures) in batches of {GRADCAM_BATCH}: "
          f"{seconds / batches * 1e3:.3f} ms a batch (host clock, .npy and "
          f"PNG writes included), the GradCAM alone (one forward and 9 "
          f"backwards) {cam_ms:.3f} ms a batch (CUDA events); launches a batch K1 {per_batch['k1']:g}, "
          f"K2 {per_batch['k2']:g}, K1b {per_batch['k1b']:g}, K2b "
          f"{per_batch['k2b']:g}, every K1 and K2 shape of a batch held to its "
          f"plain version; 2 slices' 18 maps against a float64 CPU "
          f"copy, worst and median of each map's max: card {card_err[0]:.3e}"
          f" and {card_err[1]:.3e}, CPU float32 plain path {plain_err[0]:.3e}"
          f" and {plain_err[1]:.3e} (bounds: the worst {CAM_WORST_RTOL:.0e}, "
          f"the median {CAM_REFEREE_FACTOR:g} x the CPU's); card vs CPU "
          f"float32 {apart:.3e} (the CPU's float32 maps took {cpu_s:.1f} s)")
    return {"launches_per_batch": per_batch,
            "ms_per_batch": seconds / batches * 1e3, "cam_ms": cam_ms}


def phase_front_door(label, workdir: Path, ckpt: Path, data_dir: Path):
    """Phase 29: `python -m ctseg_tpu_torch`, released names, parity."""
    import torch
    from ctseg_tpu_torch import __main__ as front
    from ctseg_tpu_torch.data.datasets import PackedDataset2D

    r = subprocess.run([sys.executable, "-m", "ctseg_tpu_torch"],
                       cwd=Path(__file__).resolve().parent,
                       capture_output=True, text=True, timeout=120)
    if r.returncode != 2 or not all(c in r.stdout for c in front.COMMANDS):
        raise AssertionError(f"the front door printed {r.stdout!r}")

    # A reference-layout model_large.ckpt (Lightning keys and hparams).
    released = workdir / "released"
    released.mkdir()
    port = torch.load(str(ckpt), map_location="cpu", weights_only=False)
    hp = dict(port["hyper_parameters"], use_res_units=True)
    torch.save({"state_dict": {k.replace(".act.", ".adn.A."): v
                               for k, v in port["state_dict"].items()},
                "hyper_parameters": hp}, released / "model_large.ckpt")
    from_released = ["--from_released", "model_l", "--released_source",
                     str(released), "--device", DEVICE]
    test = PackedDataset2D.load(data_dir / "test_packed.npz")
    times = {}
    reset_launches()
    t0 = time.perf_counter()
    front.main(["evaluate", *from_released, "--data_dir", str(data_dir),
                "--out", str(workdir / "eval_released.json")])
    times["evaluate"] = time.perf_counter() - t0
    seen = read_launches()
    result = json.loads((workdir / "eval_released.json").read_text())
    batches = -(-len(test) // 64)
    if result["num_slices"] != len(test) or (seen["k1"], seen["k2"]) != (
            8 * batches, 9 * batches):
        raise AssertionError(f"evaluate --from_released: {result['num_slices']}"
                             f" slices, launches {seen}")
    t0 = time.perf_counter()
    front.main(["gradcam", *from_released, "--data_dir", str(data_dir),
                "--out_dir", str(workdir / "cams_released"),
                "--max_samples", "8", "--min_structures", "0"])
    times["gradcam"] = time.perf_counter() - t0
    if len(list((workdir / "cams_released").glob("*_gradcam.npy"))) != 8:
        raise AssertionError("gradcam --from_released did not write 8 maps")
    t0 = time.perf_counter()
    front.main(["parity", "--checkpoint", str(ckpt), "--models", "model_l",
                "--data_dir", str(data_dir), "--out_dir",
                str(workdir / "parity_ckpt"), "--device", DEVICE])
    times["parity --checkpoint"] = time.perf_counter() - t0
    report = json.loads((workdir / "parity_ckpt" /
                         "parity_report.json").read_text())
    if report["models"]["model_l"]["result"]["num_slices"] != len(test) or \
            not (workdir / "parity_ckpt" / "parity_report.md").exists():
        raise AssertionError(f"parity --checkpoint: {report}")
    reset_launches()
    t0 = time.perf_counter()
    front.main(["parity", "--synthetic", "--max_epochs", "1", "--data_dir",
                str(data_dir), "--out_dir", str(workdir / "parity_synth"),
                "--device", DEVICE])
    times["parity --synthetic"] = time.perf_counter() - t0
    seen_synth = read_launches()
    report = json.loads((workdir / "parity_synth" /
                         "parity_report.json").read_text())
    if sorted(report["models"]) != ["model_l", "model_m"] or \
            seen_synth["k5"] < 1 or seen_synth["k4"] < 2:
        raise AssertionError(f"parity --synthetic: {sorted(report['models'])}"
                             f", launches {seen_synth}")
    torch.cuda.empty_cache()
    print(f"[{label}] front door: `python -m ctseg_tpu_torch` lists "
          f"{len(front.COMMANDS)} commands; --from_released model_l from a "
          f"local reference-layout model_large.ckpt: evaluate on "
          f"{len(test)} test slices (mean Dice {result['mean_dice']:.4f}, "
          f"K1/K2 launches {seen['k1']}/{seen['k2']}), gradcam of 8; parity "
          f"--checkpoint and parity --synthetic (both small models, 1 epoch; "
          f"launches {seen_synth}); host seconds: "
          + "; ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return times


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
        torch.cuda.empty_cache()
        k1_3d, _ = phase_k1_3d(label, gen)
        train_3d = phase_train_3d(label, Path(tmp))
        phase_grad_parity_3d(label)
        torch.cuda.empty_cache()
        phase_train_resize_3d(label)
        torch.cuda.empty_cache()
        train_3d_launches = train_3d["float32"]["launches"]
        launches_eval_3d, hd95_3d = phase_evaluate_3d(label,
                                                      train_3d["ckpt"])
        phase_serve_3d(label, Path(tmp), train_3d["ckpt"])
        ckpt_3d = train_3d["ckpt"]
        del train_3d
        torch.cuda.empty_cache()
        data_dir, sizes = phase_data_prep(label, Path(tmp))
        phase_default_workflow(label, Path(tmp), data_dir, sizes)
        launches_d0, launches_d0_m, _ = phase_train_degree0(label, Path(tmp))
        transform_ms = phase_other_degrees(label)
        phase_transforms_vs_cpu(label)
        torch.cuda.empty_cache()
        seconds = {}  # phases 27-29, host clock
        t0 = time.perf_counter()
        exported = phase_export(label, Path(tmp), ckpt, scan, ckpt_3d)
        seconds["27"] = time.perf_counter() - t0
        cams = phase_gradcam(label, Path(tmp), ckpt, data_dir)
        seconds["28"] = time.perf_counter() - t0 - seconds["27"]
        front_s = phase_front_door(label, Path(tmp), ckpt, data_dir)
        seconds["29"] = time.perf_counter() - t0 - seconds["27"] - seconds["28"]

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
    # The 3D paths: launches over phase 17's timed float32 steps and phase
    # 20's evaluation; K1f's and K1b's float32 totals over the 17 3D sites.
    bounds_3d = site_bounds_3d()
    keys = ("k1", "k1b", "k2", "k2b", "k4", "k5", "scan", "signed")
    for k, key in zip(kernels, keys, strict=True):
        k["launches_3d"] = train_3d_launches[key]
        k["launches_3d_eval"] = launches_eval_3d[key]
        k["launches_degree0"] = launches_d0[key]
        k["launches_degree0_model_m"] = launches_d0_m[key]
    for i, key, fwd in ((0, "k1", "fwd"), (1, "k1b", "bwd")):
        kernels[i].update(
            ms_3d=k1_3d[fwd]["float32"],
            plain_ms_3d=k1_3d[fwd + "_plain"]["float32"],
            bound_ms_3d=bounds_3d[key][0], bound_by_3d=bounds_3d[key][1],
            ms_3d_bf16=k1_3d[fwd]["bfloat16"],
            bound_ms_3d_bf16=bounds_3d[key + "_bf16"][0])
    kernels[0]["library_ms_norm_3d"] = k1_3d["fwd_lib"]["float32"]
    for k, key in ((k5, "k5"), (scan, "scan")):
        k.update(ms_3d_eval=hd95_3d[key][0], bound_ms_3d_eval=hd95_3d[key][1])
    # Phases 27-28: a call of the kernel artifact at the serving batch (the
    # portable one launches none), and a GradCAM batch.
    for k, key in zip(kernels[:4], ("k1", "k1b", "k2", "k2b")):
        k["launches_export"] = exported["launches"]["kernel"][key]
        k["launches_export_portable"] = exported["launches"]["portable"][key]
        k["launches_gradcam"] = cams["launches_per_batch"][key]
    kernels[0]["launches_export_3d"] = exported["launches_3d"]["k1"]
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
          "32 rows of 8192; launches_3d: phase 17's timed float32 3D steps, "
          "launches_3d_eval: phase 20's 3D evaluation; K1's and K1b's "
          "*_3d: one 3D step's 17 sites at batch 128 (K1: the training "
          "forward); K5's and the scan's *_3d_eval: the HD95 of one "
          "280x280x120 volume (K5: both passes); launches_degree0: phase "
          f"24's {TIMED_STEPS} timed Model L steps at degree 0, "
          "launches_degree0_model_m: its 2 Model M steps at degree 0; "
          f"launches_export: one call of phase 27's kernel artifact at batch "
          f"{BATCH} (launches_export_portable: the portable one's, "
          "launches_export_3d: the 3D patch scorer's at batch "
          f"{EVAL_BATCH_3D}); launches_gradcam: one batch of "
          f"{GRADCAM_BATCH} of phase 28's GradCAM)")
    # The train transforms of degrees 0, 1, 3 and 4 replace no TPU kernel
    # (the reference's warps are jnp, outside any Pallas call); their times
    # stand on a line of their own.
    print(json.dumps({"train_transform_ms": {
        f"degree_{d}": ms for d, ms in transform_ms.items()}}))
    # Phases 27-29: ms a call of batch 32 (CUDA events), ms a GradCAM batch,
    # the front door's commands' seconds and each phase's (host clock).
    print(json.dumps({
        "phase_seconds": seconds,
        "export_ms_batch_32": exported["ms"],
        "export_patch_ms": {"kernel": exported["ms_3d"],
                            "eager": exported["eager_ms_3d"]},
        "gradcam_ms_per_batch": {
            "run_interpretability": cams["ms_per_batch"],
            "gradcam": cams["cam_ms"]},
        "front_door_s": front_s}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
