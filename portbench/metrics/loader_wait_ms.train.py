"""loader_wait_ms.train: mean milliseconds a step that the loop waits in
``next()`` on the TrainBatcher's iterator, by the host's clock around the
call in the benchmark's own loop."""


def read(ctx):
    return ctx.host.get("loader_wait_ms")
