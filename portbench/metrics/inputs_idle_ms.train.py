"""Device-idle ms a step while the host was inside `hg.inputs`
(`sample_step_inputs`: the cameras, the pose images, the text): the traced
window's idle time inside those spans' host intervals
(`_hg_spans.idle_split`)."""
from portbench.metrics._hg_spans import TRAIN_LAYERS, TRAIN_UNIT, idle_ms


def read(ctx):
    return idle_ms(ctx, TRAIN_UNIT, TRAIN_LAYERS, "hg.inputs")
