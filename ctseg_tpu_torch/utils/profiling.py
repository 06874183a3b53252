"""Profiling and debug instrumentation (port of ctseg_tpu/utils/profiling.py).

  - `trace(log_dir)`: context manager around torch.profiler (host and, on a
    card, CUDA activity) writing a Chrome trace (`trace.json`, for
    chrome://tracing or ui.perfetto.dev) into `log_dir`;
  - `span(name, args)`: the port's own named range in that trace (every
    name starts with `ctseg.`), recorded only while a profiler records;
  - `to_host(t, out)`: `t.cpu()` (or a copy into `out`) inside the span
    `ctseg.sync`, the one place where the port means to wait for the
    device;
  - `debug_mode()`: autograd anomaly detection (NaN in a backward raises,
    with the forward's traceback) plus a check that every module's forward
    output is finite.
"""

import contextlib
from pathlib import Path
from typing import Dict, Optional

import torch

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str = "profile"):
    """Profile the block and write `<log_dir>/trace.json`; yields the
    profiler (its `key_averages()` sums time by operator and kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    # Shapes on: the spans' args reach the trace only with them.
    prof = profile(activities=activities, record_shapes=True)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / "trace.json"))


def span(name: str, args: Optional[Dict] = None):
    """A context naming the code it wraps `name` in the profiler's trace,
    on the clock of the device's kernels, its parent the span open around
    it; `args` (a dict of ints and strings: the step, the scan's depth)
    appear beside it where the profiler records shapes. With no profiler
    recording it is one shared no-op context.

    torch's fast record, not `record_function`: that one drops its string
    of args from the trace, and costs about 10 us a span when on."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name, (), args or {})


def to_host(t: torch.Tensor,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`t` copied to the host (into `out`, a host tensor of its shape, when
    given): a wait for the device, named `ctseg.sync`."""
    with span("ctseg.sync"):
        return t.cpu() if out is None else out.copy_(t)


class NonFiniteError(FloatingPointError):
    """A module's forward output held a NaN or an infinity."""


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Anomaly detection in autograd and a finiteness check after every
    module's forward (each check waits for the device: for debugging runs
    only)."""
    if not nans:
        yield
        return

    def check(module, inputs, output):
        for t in (output if isinstance(output, (tuple, list)) else (output,)):
            if torch.is_tensor(t) and t.is_floating_point() \
                    and not bool(torch.isfinite(t).all()):
                raise NonFiniteError(
                    f"{type(module).__name__} produced a non-finite output")

    handle = torch.nn.modules.module.register_module_forward_hook(check)
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        handle.remove()
