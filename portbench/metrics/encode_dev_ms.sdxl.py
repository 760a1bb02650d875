"""Device ms a step launched inside `hg.guidance.encode` in the SDXL
cell: the render's VAE encode at 1024^2 and its recompute in the
backward."""
from portbench.metrics._hg_spans import launched_ms


def read(ctx):
    return launched_ms(ctx, "hg.guidance.encode")
