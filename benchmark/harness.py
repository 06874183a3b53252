"""What every cell shares: the cell's files found by name, the result line,
the sites of the program's conv units, the port's launch counters, the
kernel kinds and the per-layer readers.

Everything that belongs to one configuration, traffic mix, kernel kind or
per-layer metric is a file of its own, found by the name that
BENCHMARK.json gives it:

  configs/<config>.json     the configuration's sizes
  traffic/<traffic>.json    the traffic mix's parameters; its "loop" names
                            the code that runs it, loops/<loop>.py
  limits/<workload>.json    the limits of the numbers `correct` compares
  kernels/<kind>.py         one kind of the port's kernels: FRAGMENTS of
                            its kernels' names, COUNTER (the port's op whose
                            `.launches` counts its calls), work(site)
  metrics/<metric>.py       one per-layer metric: read(ctx) -> value or
                            None where it finds nothing to read
"""

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that no run may load: JAX, and the JAX package
# (compared whole: the port's name begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "ctseg_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    spec = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])

    def mine(m):
        return workload in m.get("workloads", [workload])

    return Cell(
        name=workload, config=config,
        traffic=_load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        chips=w["chips"],
        limits=_load_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if mine(m)],
        per_layer=[m for m in spec["per_layer"] if mine(m)],
    )


def _load_file(path: Path, prefix: str):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_kinds() -> Dict:
    """Every kind of the port's kernels, by file name."""
    return {p.stem: _load_file(p, "benchmark_kind_")
            for p in sorted((HERE / "kernels").glob("*.py"))}


def reader(metric: str):
    return _load_file(HERE / "metrics" / f"{metric}.py", "benchmark_metric_")


def kind_of(kernel: str, kinds: Dict) -> Optional[str]:
    """The kind whose longest fragment the kernel's name holds, or None
    (a library or torch kernel)."""
    best, length = None, 0
    for name, kind in kinds.items():
        for frag in kind.FRAGMENTS:
            if frag in kernel and len(frag) > length:
                best, length = name, len(frag)
    return best


# ------------------------------------------------------------ the program
def unit_sites(model):
    """Forward hooks on the program's conv units (modules with a torch
    conv as `.conv`); returns (the list they fill, a function removing
    them). A site records what the kernels' work depends on."""
    import torch
    from torch.nn.modules.conv import _ConvNd, _ConvTransposeNd

    sites: List[Dict] = []

    def hook(module, args, out):
        c, x = module.conv, args[0]
        sites.append({
            "op": "conv_unit", "dims": c.weight.ndim - 2,
            "transposed": isinstance(c, _ConvTransposeNd),
            "k": c.kernel_size[0], "stride": c.stride[0],
            "act": getattr(module, "act", None) is not None,
            "x": tuple(x.shape), "y": tuple(out.shape),
            "itemsize": x.element_size(),
            "grad": torch.is_grad_enabled()
            and any(p.requires_grad for p in module.parameters()),
        })

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(getattr(m, "conv", None), _ConvNd)]

    def remove():
        for h in handles:
            h.remove()

    return sites, remove


def _counter(kind):
    mod, fn = kind.COUNTER
    return getattr(importlib.import_module(mod), fn)


def reset_counters(kinds: Dict) -> None:
    for kind in kinds.values():
        _counter(kind).launches = 0


def read_counters(kinds: Dict) -> Dict[str, int]:
    return {name: int(getattr(_counter(kind), "launches", 0))
            for name, kind in kinds.items()}


def least_seconds(sites: List[Dict], kinds: Dict, launches: Dict[str, int]
                  ) -> Dict[str, Optional[float]]:
    """Each kind's least time over `sites` (peaks.least_seconds a call,
    summed), or None where the kind's sites are not as many as the port's
    counter says it launched: then its work is not known."""
    from benchmark.peaks import least_seconds as least

    out = {}
    for name, kind in kinds.items():
        calls = [w for w in (kind.work(s) for s in sites) if w is not None]
        out[name] = (sum(least(*w) for w in calls)
                     if len(calls) == launches.get(name, 0) else None)
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def itemsize(config: Dict) -> int:
    return 2 if config["dtype"] in ("bfloat16", "float16") else 4


def kernels_roofline(ctx) -> Optional[float]:
    """The port's kernels' least time over their device time in the traced
    window, in %: None without a trace, or where a kind's work is not
    known."""
    if ctx.trace is None or any(v is None for v in ctx.least_s.values()):
        return None
    device = sum(e.end_ns - e.start_ns for e in ctx.trace.kernels
                 if kind_of(e.name, ctx.kinds) is not None)
    if device == 0:
        return None
    return 100.0 * sum(ctx.least_s.values()) / (device / 1e9)


def idle_share(ctx) -> Optional[float]:
    """The share of the traced window in which the device ran nothing, in
    %."""
    from benchmark.devtrace import busy_seconds

    if ctx.trace is None or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(ctx.trace) / ctx.window_s)


# ------------------------------------------------------------- the device
def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def start_profiler():
    """torch.profiler over the host and, where there is one, the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


WINDOW_SPAN = "bench.window"


def span(name: str, prof):
    """A span of the benchmark's own around a call into the program, in
    the trace of a traced run (nothing otherwise)."""
    import torch

    if prof is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(
        WINDOW_SPAN if name == "window" else f"bench.{name}")


@contextlib.contextmanager
def timed(what: str):
    """Prints the seconds a part of a run took, on standard error."""
    import time

    t0 = time.perf_counter()
    yield
    print(f"{what}: {time.perf_counter() - t0:.3f} s", file=sys.stderr,
          flush=True)


class Clock:
    """Marks the set-up's phases on standard error: each phase's seconds
    since the last mark."""

    def __init__(self, verbose: bool = True):
        import time

        self._time = time.perf_counter
        self.last = self._time()
        self.verbose = verbose

    def runtime(self, device) -> None:
        """The card's runtime and cuDNN loaded, marked apart."""
        import torch

        if device.type == "cuda":
            torch.cuda.init()
            self.mark("cuda")
            torch.nn.functional.conv2d(torch.ones(1, 1, 3, 3, device=device),
                                       torch.ones(1, 1, 3, 3, device=device))
            torch.cuda.synchronize(device)
            self.mark("cudnn")

    def mark(self, phase: str) -> None:
        now = self._time()
        if self.verbose:
            print(f"setup {phase}: {now - self.last:.3f} s",
                  file=sys.stderr, flush=True)
        self.last = now
