"""The segmentation loop: one client sends scans back to back to the port's
SegmentationService.segment (inference/serve.py), with no HTTP.

Set-up makes the configuration's weights on the card from the seed and
writes them once to a checkpoint under TMPDIR, which the service loads;
makes one scan of each of the traffic's depths on the card from the seed
(HU ~ N(mean, std), rounded to int16 and clipped to the scanner's range)
and copies them to the host once, as an NRRD parse would leave them; and
segments each scan once, which warms every batch size the depths leave
(the crop's slices in batches of 32). The window sends each depth once a
round, in an order drawn from the seed, so every seed does the same work.

A sample of the window's requests, drawn from the seed, with the first of
the deepest scans in it, is kept and judged once the window has closed:
the reference (benchmark/reference/segment.py) recomputes each sampled
scan's logits from the same weights and scan, and every served label must
lie within the limit of the reference's best logit, and be 0 outside the
head-and-neck box.
"""

import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from benchmark import harness
from benchmark.loops.train import train_config
from benchmark.reference import segment as ref
from benchmark.reference.unet import Model, make_weights


def make_scans(traffic, seed: int, device):
    """{depth: (D, H, W) int16 host array} made on the card from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, w = traffic["hw"]
    lo, hi = traffic["hu_range"]
    scans = {}
    for d in traffic["depths"]:
        x = torch.randn((d, h, w), generator=gen, device=device)
        x = torch.round(x * traffic["hu_std"] + traffic["hu_mean"])
        scans[d] = torch.clamp(x, lo, hi).to(torch.int16).cpu().numpy()
    return scans


def write_checkpoint(path: Path, config: Dict, weights) -> None:
    torch.save({"hyper_parameters": train_config(config).as_dict(),
                "state_dict": {k: v.cpu() for k, v in weights.items()}},
               str(path))


class Order:
    """Each depth once a round, the rounds' orders and the sample drawn
    from the seed."""

    def __init__(self, depths, seed: int, share: float):
        self.depths = list(depths)
        self.rng = np.random.default_rng([seed, 1])
        self.pick = np.random.default_rng([seed, 2])
        self.share = share
        self.deepest_seen = False
        self.queue = []

    def next(self):
        """(depth, whether the request is in the sample)."""
        if not self.queue:
            self.queue = list(self.rng.permutation(self.depths))
        d = int(self.queue.pop(0))
        sampled = self.pick.random() < self.share
        if d == max(self.depths) and not self.deepest_seen:
            self.deepest_seen, sampled = True, True
        return d, sampled


def set_up(cell, seed: int, device, tmp: Path, kinds=None):
    """The service, the scans as Volumes, the host weights, and (with
    `kinds`) each kind's least seconds for one request of each depth."""
    from ctseg_tpu_torch.inference.serve import SegmentationService
    from ctseg_tpu_torch.utils.miccai import Volume

    config, traffic = cell.config, cell.traffic
    clock = harness.Clock()
    clock.runtime(device)
    weights = make_weights(config, seed, device)
    ckpt = tmp / "model.ckpt"
    write_checkpoint(ckpt, config, weights)
    host = {k: v.cpu() for k, v in weights.items()}
    del weights
    clock.mark("weights and checkpoint")
    scans = make_scans(traffic, seed, device)
    volumes = {d: Volume(s[None]) for d, s in scans.items()}
    clock.mark("scans")
    service = SegmentationService(str(ckpt), device=str(device),
                                  crop=traffic["crop"])
    clock.mark("service")
    least = {}
    for d, vol in volumes.items():
        if kinds is not None:
            sites, remove = harness.unit_sites(service.model)
            harness.reset_counters(kinds)
        service.segment(vol)
        if kinds is not None:
            remove()
            least[d] = harness.least_seconds(sites, kinds,
                                             harness.read_counters(kinds))
    harness.synchronize(device)
    clock.mark("warm-up")
    return SimpleNamespace(service=service, scans=scans, volumes=volumes,
                           weights=host, least=least)


def reference_logits(config, weights, scans, device, tf32=False):
    """{depth: the box's logits} for the given scans, from the reference."""
    model = Model(config).to(device).eval()
    model.load_state_dict({k: v.to(device) for k, v in weights.items()})
    size = config["input_shape"]
    return {d: ref.crop_logits(model, s, size, device, tf32=tf32)
            for d, s in scans.items()}


def judge(served, logits) -> Dict[str, float]:
    """The widest label gap over the served maps [(depth, labels)], and the
    voxels outside the box that are not 0."""
    gap, outside = 0.0, 0
    for d, labels in served:
        g, o = ref.label_gap(labels, logits[d])
        gap, outside = max(gap, g), outside + o
    return {"label_gap": gap, "outside_box": float(outside)}


def print_latencies(depths, latencies) -> None:
    """Each depth's requests and their least, median and largest ms, on
    standard error."""
    by = {}
    for d, t in zip(depths, latencies):
        by.setdefault(d, []).append(t * 1e3)
    print("latency ms by depth: " + "; ".join(
        f"{d}: {len(v)} x {min(v):.2f}/{float(np.median(v)):.2f}/"
        f"{max(v):.2f}" for d, v in sorted(by.items())), file=sys.stderr)


def run(cell, seed: int, seconds: float, trace: bool, device,
        kinds: Dict) -> SimpleNamespace:
    traffic = cell.traffic
    with tempfile.TemporaryDirectory() as tmp:
        setup = set_up(cell, seed, device, Path(tmp), kinds)
    service, volumes = setup.service, setup.volumes
    order = Order(traffic["depths"], seed, traffic["sample_share"])
    latencies, depths, kept, failed = [], [], [], 0
    prof = harness.start_profiler() if trace else None
    with harness.span("window", prof):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            d, sampled = order.next()
            start = time.perf_counter()
            try:
                with harness.span("segment", prof):
                    labels = service.segment(volumes[d])
            except Exception as e:  # noqa: BLE001: a failed request counts
                failed += 1
                print(f"request of depth {d} failed: {e!r}", file=sys.stderr)
                continue
            latencies.append(time.perf_counter() - start)
            depths.append(d)
            if sampled:
                kept.append((d, labels))
        harness.synchronize(device)
        t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
    print_latencies(depths, latencies)
    memory = harness.memory_peak(device)
    del service
    setup.service = None
    harness.free(device)
    scans = {d: setup.scans[d] for d in {d for d, _ in kept}}
    with harness.timed("reference"):
        checks = judge(kept, reference_logits(cell.config, setup.weights,
                                              scans, device))
    if failed:
        checks["failed_requests"] = float(failed)
    window = t1 - t0
    box = [ref.box(d)[0] for d in depths]
    model_slices = sum(z.stop - z.start for z in box)
    least = {k: sum(setup.least[d][k] for d in depths)
             if all(setup.least[d][k] is not None for d in depths) else None
             for k in kinds} if setup.least else {}
    return SimpleNamespace(
        window_start=t0, window_s=window,
        attempted=len(depths) + failed, failed=failed,
        end_to_end={
            "segment_slices_per_s": sum(depths) / window,
            "scan_latency_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
        },
        checks=checks, memory_peak=memory, profiler=prof,
        ctx=dict(steps=0, batch=0, scans=len(depths),
                 model_slices=model_slices, least_s=least))
