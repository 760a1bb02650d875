"""Device ms a step launched inside `hg.guidance.unet` in the SDXL cell:
the UNet pass on the 3B noisy latents and the ANPG gradient."""
from portbench.metrics._hg_spans import launched_ms


def read(ctx):
    return launched_ms(ctx, "hg.guidance.unet")
