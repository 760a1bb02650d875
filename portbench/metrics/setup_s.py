"""s from the process's start to the window's start: imports, inputs and
weights made from the seed, building the program, kernel builds or loads,
the checked first steps or frames and the warm-up."""


def read(ctx):
    return ctx.setup_s
