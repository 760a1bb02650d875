"""Frames on the host a second: the window's frames over its wall time."""


def read(ctx):
    return ctx.units / ctx.wall_s
