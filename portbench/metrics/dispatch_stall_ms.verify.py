"""dispatch_stall_ms.verify: device-idle milliseconds a request while the
host is inside the Scorer's ``serving.dispatch`` span
(``aasist_tpu_torch/serving.py``): the part of the device's idle time that
those spans overlap, over the requests completed.  The time a request's
batch waits for the host to fill the slot and queue its work.  A program
without the span gives no reading."""

from portbench.lib import spans


def read(ctx):
    return spans.stall_ms(ctx.trace, "serving.dispatch",
                          ctx.counts.get("requests"))
