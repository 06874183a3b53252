"""The slice model's share of the chip's peak while it segments: the
analytic conv FLOPs of one slice's forward (flops.config_flops), times the
slices the model ran on in the traced window (the crops' slices), over the
window and the product peak, in %."""

from benchmark.flops import config_flops
from benchmark.harness import itemsize
from benchmark.peaks import product_peak


def read(ctx):
    if not ctx.model_slices or ctx.window_s <= 0:
        return None
    per_slice = config_flops(ctx.config, 1)["forward"]
    peak = ctx.chips * product_peak(itemsize(ctx.config))
    return 100.0 * per_slice * ctx.model_slices / ctx.window_s / peak
