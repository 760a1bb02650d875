"""Device-idle ms a frame while the host was inside `hg.render` (the
frame's render: projection, binning, K1): the traced window's idle time
inside those spans' host intervals (`_hg_spans.idle_split`)."""
from portbench.metrics._hg_spans import SERVE_LAYERS, SERVE_UNIT, idle_ms


def read(ctx):
    return idle_ms(ctx, SERVE_UNIT, SERVE_LAYERS, "hg.render")
