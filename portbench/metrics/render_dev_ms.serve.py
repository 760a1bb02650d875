"""Device ms a frame launched inside the span around
`AvatarAnimator.render_frame` but not inside its `frame_scene` span:
projection, binning and K1."""


def read(ctx):
    tr = ctx.trace
    if tr is None or "portbench.render_frame" not in tr.spans:
        return None
    s = (tr.span_device_s("portbench.render_frame")
         - tr.span_device_s("portbench.frame_scene"))
    return s / ctx.traced_units * 1e3
