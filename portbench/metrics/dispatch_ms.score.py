"""dispatch_ms.score: host milliseconds a batch of the Scorer's own work
before it queues the forward, read from the program's spans
(``aasist_tpu_torch/serving.py``): the mean length of ``serving.dispatch``
less the ``serving.acquire`` and the ``serving.forward`` inside it.  What
is left is filling the slot (``serving.fill``: ``pad_into`` of each row
and the repeated padding rows) and sending it (``serving.send``: the
non-blocking copy in).  The wait for a free slot is the device's pace, and
so is most of ``serving.forward`` while the card is busy: a full CUDA
launch queue blocks the forward's enqueue (79.6 of 96.9 ms a batch in
``model.graph``'s launches on an H100 running the AASIST score cell), so
that span reads the card's time, not the host's.  The forward's own
enqueue cost is therefore not in this reading.  A program without these
spans gives no reading."""

from portbench.lib import spans


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    dispatch = spans.named(t, "serving.dispatch")
    if not dispatch:
        return None
    waits = spans.named(t, "serving.acquire", "serving.forward")
    own = sum(b - a for a, b in dispatch) - spans.overlap_ns(dispatch, waits)
    return own / 1e6 / len(dispatch)
