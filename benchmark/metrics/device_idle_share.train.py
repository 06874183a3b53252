"""The share of the traced window in which the device ran no kernel, copy
or set (the union of the device's intervals), in %."""

from benchmark.harness import idle_share


def read(ctx):
    return idle_share(ctx)
