"""bn_ms.train: device milliseconds a step of BatchNorm's forward and
backward kernels, matched by the name patterns below (cuDNN's and
PyTorch's own), read from the trace."""

PATTERNS = ("bn_fw", "bn_bw", "batch_norm", "batchnorm")


def read(ctx):
    t, n = ctx.trace, ctx.counts.get("steps")
    if t is None or not n:
        return None
    seconds = t.seconds(PATTERNS)
    return 1e3 * seconds / n if seconds > 0 else None
