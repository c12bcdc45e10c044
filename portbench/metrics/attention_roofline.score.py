"""attention_roofline.score: the attention's share of its roofline, in %.

The least time of one batch's attention at the cell's shapes
(``bound_ms``) over the mean device time a batch of the kernels whose
names hold one of ``KERNELS`` (case blind): those of
``F.scaled_dot_product_attention``'s fused backends (flash,
memory-efficient ``fmha``, cuDNN's ``sdpa``).  A trace with none of them
gives no reading.

The bound is the larger of the operations over the serving type's peak
and the bytes over the memory rate, for ``layers`` attentions of
``heads`` x (S, D / heads) each: 4 B S^2 D operations (q k^T and the
weights times v) and 4 B S D elements (q, k and v read and the output
written once).  S is the frame count of the configuration's conv
extractor at the serving window, D its embedding width."""

KERNELS = ("flash", "fmha", "sdpa", "attention")


def frames(conv_layers, length: int) -> int:
    """Frames out of the conv extractor's ``[dim, kernel, stride]``
    blocks, unpadded, from ``length`` samples."""
    for _, k, stride in conv_layers:
        length = (length - k) // stride + 1
    return length


def bound_ms(b: int, s: int, d: int, layers: int, dtype: str, roofline):
    """(least ms, what bounds it) of ``layers`` attentions on a batch
    ``b`` of ``s`` frames of width ``d``."""
    flops = layers * 4.0 * b * s * s * d
    nbytes = layers * 4.0 * b * s * d * roofline.ESIZE[dtype]
    t_ops = flops / roofline.PEAK_FLOPS[dtype]
    t_bytes = nbytes / roofline.PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def read(ctx):
    t, n = ctx.trace, ctx.counts.get("batches")
    if t is None or not n:
        return None
    seconds = t.seconds(KERNELS)
    if seconds <= 0:
        return None
    serve, mc = ctx.config["serve"], ctx.config["model_config"]
    ms, _ = bound_ms(serve["batch_size"],
                     frames(mc["conv_feature_layers"], serve["window"]),
                     mc["encoder_embed_dim"], mc["encoder_layers"],
                     serve["dtype"], ctx.roofline)
    return 100.0 * ms / (1e3 * seconds / n)
