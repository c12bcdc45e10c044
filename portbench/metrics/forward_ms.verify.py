"""forward_ms.verify: device milliseconds a request, read from the trace:
the union of the window's kernel intervals (copies and memsets left out)
over the requests completed (each is one padded batch)."""


def read(ctx):
    t, n = ctx.trace, ctx.counts.get("requests")
    if t is None or not n or not t.kernels():
        return None
    return 1e3 * t.busy_s(t.kernels()) / n
