"""The benchmark of ctseg_tpu_torch, the PyTorch and CUDA port, on NVIDIA
cards. From the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

runs one cell of BENCHMARK.json: set-up (the cell's inputs and weights
from --seed, made on the card, every shape the window uses warmed), a
window of --seconds, then the check of what the window produced against
the plain reference (benchmark/reference/). With --trace 0 it reports the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, read from
torch.profiler's trace of the window. The last line of standard output is
one JSON object: correct, attempted, failed, metrics, device, with --trace
1 breakdown, and last `checks`, each number compared beside its limit,
which are also the last lines of standard error.

It exits with another code than 0, and prints no result, without enough
CUDA cards, or when the run has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Import the benchmark as a package from the checkout's root, and let none
# of its files shadow a module of the standard library.
sys.path[0] = str(ROOT)
# Every build and kernel cache at a fixed place inside the checkout, the
# interpreter's compiled modules too: where the installed packages hold
# none, each run would compile torch's Python anew (seconds of set-up).
CACHE = ROOT / "benchmark" / "_cache"
sys.pycache_prefix = str(CACHE / "pycache")
sys.dont_write_bytecode = False
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)

from benchmark import devtrace, harness  # noqa: E402


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def per_layer(cell, out, trace):
    """{metric: {value, unit}} of the per-layer metrics a reader found."""
    ctx = SimpleNamespace(trace=trace, window_s=out.traced_window_s,
                          chips=cell.chips, config=cell.config,
                          kinds=out.kinds, **out.ctx)
    metrics = {}
    for m in cell.per_layer:
        value = harness.reader(m["name"]).read(ctx)
        if value is None:
            print(f"per-layer {m['name']}: nothing to read", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def print_kinds(trace, out) -> None:
    """Each kind's device ms in the traced window, its least ms and the
    share, on standard error."""
    device = {}
    for e in trace.kernels:
        kind = harness.kind_of(e.name, out.kinds)
        if kind is not None:
            device[kind] = device.get(kind, 0) + e.end_ns - e.start_ns
    for kind, least in sorted(out.ctx["least_s"].items()):
        ms = device.get(kind, 0) / 1e6
        share = (f"{100 * least * 1e3 / ms:.4g}%" if least is not None and ms
                 else "-")
        least = "unknown" if least is None else f"{least * 1e3:.6g}"
        print(f"kind {kind}: device {ms:.6g} ms, least {least} ms, {share}",
              file=sys.stderr)


def run_workload(workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", cell=None, t_start: float = T_START):
    """One run of a cell; returns the result's dict, or None where the run
    loaded a forbidden module (named on standard error)."""
    import torch

    print(f"setup imports: {time.perf_counter() - t_start:.3f} s",
          file=sys.stderr)
    cell = cell or harness.load_cell(workload)
    device = torch.device(device)
    kinds = harness.kernel_kinds()
    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    out = loop.run(cell, seed, seconds, trace, device, kinds)
    out.kinds = kinds
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: no result", file=sys.stderr)
        return None
    metrics = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": out.memory_peak}
    breakdown = None
    if trace:
        tr = devtrace.collect(out.profiler, harness.WINDOW_SPAN, "bench.")
        out.traced_window_s = (tr.window_ns[1] - tr.window_ns[0]) / 1e9
        metrics = per_layer(cell, out, tr)
        print_kinds(tr, out)
        busy = getattr(out, "busy_ranks", None) or [devtrace.busy_seconds(tr)]
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = out.traced_window_s
        breakdown = {"device_ops": devtrace.device_ops(tr),
                     "idle_gaps": devtrace.idle_gaps(tr)}
    else:
        setup_s = out.window_start - t_start
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" \
                else out.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {}
    for name, value in out.checks.items():
        limit = cell.limits.get(name, 0.0)
        checks[name] = {"value": value, "limit": limit}
    correct = out.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark.peaks import PEAK_BF16, PEAK_BYTES, PEAK_FP32, PEAK_TF32

    print(f"card: {card_label()}; peaks: float32 products "
          f"{PEAK_TF32:.4g}, bfloat16 {PEAK_BF16:.4g}, elementwise "
          f"{PEAK_FP32:.4g} FLOP/s, {PEAK_BYTES:.4g} B/s", file=sys.stderr,
          flush=True)
    result = run_workload(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", cell)
    if result is None:
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
