"""Device-idle ms a frame outside `hg.repose` and `hg.render`: the
frame's camera and pose, its copy to the host (`hg.read.frame`) and the
harness between frames. With the other two `*_idle_ms.serve` it sums to
the traced window's idle time a frame (`_hg_spans.idle_split`)."""
from portbench.metrics._hg_spans import SERVE_LAYERS, SERVE_UNIT, idle_ms


def read(ctx):
    return idle_ms(ctx, SERVE_UNIT, SERVE_LAYERS, None)
