"""forward_ms.score: device milliseconds a batch of the forward, read from
the trace: the union of the window's kernel intervals (copies and memsets
left out) over the batches the window ran."""


def read(ctx):
    t, n = ctx.trace, ctx.counts.get("batches")
    if t is None or not n or not t.kernels():
        return None
    return 1e3 * t.busy_s(t.kernels()) / n
