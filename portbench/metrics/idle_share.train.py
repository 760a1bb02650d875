"""% of the traced window in which no device operation ran: one minus the
union of the device's operation intervals over the window's wall time."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
