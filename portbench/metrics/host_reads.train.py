"""Blocking host syncs a step: the program's `hg.read.*` spans in the
traced window over its steps. Each is one call that waits for the card:
binning's `nonzero` once a camera, `linalg.inv`'s error check, host
values copied to the card (the cameras' constants, the pose images'
tables, the UNet's time ids) and the loop's metrics read every
`log_every` steps."""
from portbench.metrics._hg_spans import TRAIN_UNIT, reads


def read(ctx):
    return reads(ctx, TRAIN_UNIT)
