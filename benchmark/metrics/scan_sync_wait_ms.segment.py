"""Host milliseconds a scan spent waiting for the device: inside the
program's `ctseg.sync` spans (ctseg_tpu_torch/utils/profiling.py::to_host:
each batch's labels copied to the host). None where the trace holds no
such span."""

NAME = "ctseg.sync"


def read(ctx):
    if ctx.trace is None or not ctx.scans:
        return None
    waits = [e.end_ns - e.start_ns for e in ctx.trace.host if e.name == NAME]
    return sum(waits) / 1e6 / ctx.scans if waits else None
