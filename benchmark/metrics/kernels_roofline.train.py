"""The port's own kernels' share of their roofline: the sum over every
call in the traced window of the least time its work allows
(kernels/<kind>.py's work at peaks.py's peaks), over the device time of the
kernels whose names the kinds' fragments find, in %."""

from benchmark.harness import kernels_roofline


def read(ctx):
    return kernels_roofline(ctx)
