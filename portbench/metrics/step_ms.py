"""ms a training step: the window's wall time over the steps completed in
it (host clock, every step of the window, stalls included)."""


def read(ctx):
    return ctx.wall_s / ctx.units * 1e3
