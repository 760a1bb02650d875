"""Device-idle ms a step while the host was inside `hg.optim`
(`apply_grads`: the densify statistics, Adam, the metrics): the traced
window's idle time inside those spans' host intervals
(`_hg_spans.idle_split`)."""
from portbench.metrics._hg_spans import TRAIN_LAYERS, TRAIN_UNIT, idle_ms


def read(ctx):
    return idle_ms(ctx, TRAIN_UNIT, TRAIN_LAYERS, "hg.optim")
