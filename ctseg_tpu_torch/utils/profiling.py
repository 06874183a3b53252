"""Profiling and debug instrumentation (port of ctseg_tpu/utils/profiling.py).

  - `trace(log_dir)`: context manager around torch.profiler (host and, on a
    card, CUDA activity) writing a Chrome trace (`trace.json`, for
    chrome://tracing or ui.perfetto.dev) into `log_dir`;
  - `StepTimer`: rolling per-step wall-time statistics whose `stop` waits
    for the device on a CUDA event;
  - `debug_mode()`: autograd anomaly detection (NaN in a backward raises,
    with the forward's traceback) plus a check that every module's forward
    output is finite.
"""

import contextlib
import time
from pathlib import Path

import torch


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
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Rolling wall-time statistics of steps.

    `stop(sync_value)` first waits until the work that produced
    `sync_value` (a tensor from the step's output) is done: on a CUDA
    tensor it records an event on the current stream and synchronises on
    it; a CPU tensor is ready when the step returns.
    """

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        if torch.is_tensor(sync_value) and sync_value.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(sync_value.device))
            done.synchronize()
        dt = time.perf_counter() - self._last
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.times else 0.0


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
