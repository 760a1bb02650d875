"""Blocking host syncs a frame: the program's `hg.read.*` spans in the
traced window over its frames. Each is one call that waits for the card:
the frame's camera and pose copied to the card, `linalg.inv`'s error
check, LBS's constant row, binning's `nonzero` and the frame's copy to
the host."""
from portbench.metrics._hg_spans import SERVE_UNIT, reads


def read(ctx):
    return reads(ctx, SERVE_UNIT)
