"""Device ms a step launched inside the span around the system's guidance
call: the three encodes, the UNet and the ANPG gradient."""


def read(ctx):
    tr = ctx.trace
    if tr is None or "portbench.guidance" not in tr.spans:
        return None
    return tr.span_device_s("portbench.guidance") / ctx.traced_units * 1e3
