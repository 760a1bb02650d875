"""% of the card's bfloat16 peak in the SDXL cell: the step's model FLOPs
(counts/prior_sdxl.py, from the configuration's shapes) over the
unprofiled window's time a step times 989 TFLOP/s."""
from portbench.peaks import BF16_FLOPS


def read(ctx):
    flops = ctx.counts("prior_sdxl").step_flops(ctx.conf)
    return 100.0 * flops / (ctx.unit_s * BF16_FLOPS)
