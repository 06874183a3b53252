"""Device milliseconds a scan of host-to-device and device-to-host copies
in the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.scans:
        return None
    ns = sum(e.end_ns - e.start_ns for e in ctx.trace.copies
             if e.name in ("HtoD", "DtoH"))
    return ns / 1e6 / ctx.scans
