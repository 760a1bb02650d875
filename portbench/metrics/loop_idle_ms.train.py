"""Device-idle ms a step outside the step's five layer spans (`hg.inputs`,
`hg.render`, `hg.guidance`, `hg.backward`, `hg.optim`): the losses,
density control, the loop's metrics read, the loop and the harness between
steps. With the five `*_idle_ms.train` it sums to the traced window's idle
time a step (`_hg_spans.idle_split`)."""
from portbench.metrics._hg_spans import TRAIN_LAYERS, TRAIN_UNIT, idle_ms


def read(ctx):
    return idle_ms(ctx, TRAIN_UNIT, TRAIN_LAYERS, None)
