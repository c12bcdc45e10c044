"""frontend_roofline: the sinc frontend's share of its roofline, in %.

The least time of one frontend call at the cell's shapes
(``lib/roofline.py:frontend_bound``: batch, window, filters and the
serving type of the configuration) over the mean device time a batch of
the kernels that compute it.  ``KERNELS`` names them; a trace with none
of them gives no reading."""

KERNELS = ("frontend_dot_kernel", "frontend_dot_wg_kernel",
           "fused_frontend_kernel", "frontend_ffma_kernel",
           "frontend_f32_kernel")


def read(ctx):
    t, n = ctx.trace, ctx.counts.get("batches")
    if t is None or not n:
        return None
    seconds = t.seconds(KERNELS)
    if seconds <= 0:
        return None
    serve, mc = ctx.config["serve"], ctx.config["model_config"]
    bound_ms, _ = ctx.roofline.frontend_bound(
        serve["batch_size"], serve["window"], mc["filts"][0], serve["dtype"])
    return 100.0 * bound_ms / (1e3 * seconds / n)
