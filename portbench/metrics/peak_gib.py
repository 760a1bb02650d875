"""GiB, the most device memory the program held during the window
(`torch.cuda.max_memory_allocated`, reset when the window starts)."""


def read(ctx):
    return ctx.peak_bytes / 2**30
