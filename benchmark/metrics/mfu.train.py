"""The training step's share of the chip's peak: the analytic conv FLOPs
of a step (flops.config_flops: forward, weight gradients, input gradients
but the images'), times the steps completed in the traced window, over the
window and the chips' product peak (peaks.product_peak for the
configuration's type), in %."""

from benchmark.flops import config_flops
from benchmark.harness import itemsize
from benchmark.peaks import product_peak


def read(ctx):
    if not ctx.steps or ctx.window_s <= 0:
        return None
    step = config_flops(ctx.config, ctx.batch)["train_step"]
    peak = ctx.chips * product_peak(itemsize(ctx.config))
    return 100.0 * step * ctx.steps / ctx.window_s / peak
