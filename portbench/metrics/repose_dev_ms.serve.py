"""Device ms a frame launched inside the span around
`AvatarAnimator.frame_scene`: LBS and the re-pose through the binding."""


def read(ctx):
    tr = ctx.trace
    if tr is None or "portbench.frame_scene" not in tr.spans:
        return None
    return tr.span_device_s("portbench.frame_scene") / ctx.traced_units * 1e3
