"""Device milliseconds a step of the library's (cuDNN's) conv kernels,
found by a frozen list of name fragments among the kernels that no kind of
the port's claims."""

from benchmark.harness import kind_of

FRAGMENTS = ("fprop", "dgrad", "wgrad", "convolve", "conv2d", "conv3d",
             "implicit_gemm", "winograd", "fft2d", "fft3d", "cudnn",
             "xmma", "nchwToNhwc", "nhwcToNchw")


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    ns = sum(e.end_ns - e.start_ns for e in ctx.trace.kernels
             if kind_of(e.name, ctx.kinds) is None
             and any(f in e.name for f in FRAGMENTS))
    return ns / 1e6 / ctx.steps
