"""Device ms a step launched inside the span around
`GaussianDreamerSystem.loss_and_grads` but not inside its render or
guidance spans: the losses and autograd's backward through the encodes
(recomputed), the resize and the render (K2, K2b)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or "portbench.loss_and_grads" not in tr.spans:
        return None
    s = (tr.span_device_s("portbench.loss_and_grads")
         - tr.span_device_s("portbench.render_batch")
         - tr.span_device_s("portbench.guidance"))
    return s / ctx.traced_units * 1e3
