"""Device ms a step launched inside the span around
`GaussianDreamerSystem.render_batch`: projection, binning and K1."""


def read(ctx):
    tr = ctx.trace
    if tr is None or "portbench.render_batch" not in tr.spans:
        return None
    return tr.span_device_s("portbench.render_batch") / ctx.traced_units * 1e3
