"""Device-idle milliseconds a scan while the host runs the scan's numpy
work: the idle gaps whose middle falls, by the innermost program span
(`ctseg.`, ctseg_tpu_torch/utils/profiling.py) open there, under
`ctseg.scan.crop`, `.cast`, `.store` or `.paste`. None where the trace
holds no span of those names."""

from benchmark.devtrace import idle_gaps

NAMES = ("ctseg.scan.crop", "ctseg.scan.cast", "ctseg.scan.store",
         "ctseg.scan.paste")


def read(ctx):
    if ctx.trace is None or not ctx.scans:
        return None
    spans = [e for e in ctx.trace.host if e.name.startswith("ctseg.")]
    if not any(e.name in NAMES for e in spans):
        return None
    gaps = dict(idle_gaps(ctx.trace._replace(host=spans), top=len(spans) + 1))
    return 1e3 * sum(gaps.get(n, 0.0) for n in NAMES) / ctx.scans
