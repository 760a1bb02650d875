"""Device ms a step launched inside `hg.guidance.unet.xformer` in the
SDXL cell: the UNet's 11 transformer stacks (70 blocks) with their norms
and projections. None where the program has no such span."""
from portbench.metrics._hg_spans import launched_ms


def read(ctx):
    return launched_ms(ctx, "hg.guidance.unet.xformer")
