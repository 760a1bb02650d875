"""Device ms a step launched inside `hg.guidance.encode`: the resizes to
the prior's size and the three VAE encodes, and the two differentiated
encodes' recompute in the backward."""
from portbench.metrics._hg_spans import launched_ms


def read(ctx):
    return launched_ms(ctx, "hg.guidance.encode")
