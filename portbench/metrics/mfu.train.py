"""mfu.train: the whole train step's share of the card's peak, in %.

The reference's forward and backward FLOPs an utterance at the mix's crop
(the configuration's ``flops``, counted by ``FlopCounterMode`` on the
plain reference) times the rows stepped, over the traced window's seconds
and the peak of the training type (float32 with TF32 off: the CUDA cores'
67 TFLOP/s)."""


def read(ctx):
    flops = ctx.config.get("flops", {}).get(f"train@{ctx.traffic['crop']}")
    t, n = ctx.trace, ctx.counts.get("rows")
    if t is None or not flops or not n or t.window_s <= 0:
        return None
    return 100.0 * flops * n / t.window_s / ctx.roofline.PEAK_FLOPS[
        ctx.config["train"]["dtype"]]
