"""mfu.score: the whole forward's share of the card's peak, in %.

The reference's FLOPs an utterance at the serving window (the
configuration's ``flops``, counted by ``FlopCounterMode`` on the plain
reference) times the utterances scored, over the traced window's seconds
and the peak of the serving type."""


def read(ctx):
    serve = ctx.config["serve"]
    flops = ctx.config.get("flops", {}).get(f"forward@{serve['window']}")
    t, n = ctx.trace, ctx.counts.get("utterances")
    if t is None or not flops or not n or t.window_s <= 0:
        return None
    return 100.0 * flops * n / t.window_s / ctx.roofline.PEAK_FLOPS[
        serve["dtype"]]
