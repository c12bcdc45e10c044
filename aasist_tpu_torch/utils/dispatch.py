"""Pipelined dispatch (own copy of ``aasist_tpu/utils/dispatch.py``).

A CUDA forward returns as soon as its kernels are queued; the host blocks
only when it reads a result.  Every batched driver of the port keeps
``depth`` calls in flight and drains the oldest, so that the host's work on
batch k + 1 (padding, the copy into a pinned buffer, queueing the forward)
overlaps the device's work on batch k.  With ``depth`` calls in flight a
new dispatch is made before the oldest is drained, so ``depth + 1`` tickets
exist at once: a driver that reuses buffers per ticket needs that many.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable


def pipelined(items: Iterable[Any],
              dispatch: Callable[[Any], Any],
              drain: Callable[[Any], None],
              depth: int = 2) -> None:
    """Run ``dispatch(item)`` for every item, calling ``drain(ticket)``
    on each dispatch's return value in order, with up to ``depth``
    tickets in flight.  ``depth=0`` degenerates to fully synchronous.
    """
    pending = collections.deque()
    for it in items:
        pending.append(dispatch(it))
        if len(pending) > depth:
            drain(pending.popleft())
    while pending:
        drain(pending.popleft())
