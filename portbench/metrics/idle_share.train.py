"""idle_share.train: the device's idle share of the traced window, one
less the seconds covered by the union of its operations (kernels, copies,
memsets) over the window's seconds."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return 1.0 - t.busy_s() / t.window_s
