"""step_stall_ms.train: device-idle milliseconds a step while the host is
inside the train step's ``train.step`` span
(``aasist_tpu_torch/train/loop.py:make_train_step``): the part of the
device's idle time that those spans overlap, over the steps run.  The
host's own share of the step's stalls, apart from waiting for the batch
and its copy.  A program without the span gives no reading.

The profiler inflates it: it slows the host's launches, most of all the
backward's, so the card waits longer under ``train.backward`` than it
would untraced.  On an H100 the traced AASIST train cell reads 53-69 ms
a step, while the untraced step leaves at most about 24 ms a step of
device idle in all (322.6 ms a step by ``train_utt_s`` against 298.7 ms
of device operations a step in the traced window).  Compare it between
traced runs only."""

from portbench.lib import spans


def read(ctx):
    return spans.stall_ms(ctx.trace, "train.step", ctx.counts.get("steps"))
