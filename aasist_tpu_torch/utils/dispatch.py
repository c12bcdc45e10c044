"""Pipelined dispatch (own copy of ``aasist_tpu/utils/dispatch.py``).

A CUDA forward returns as soon as its kernels are queued; the host blocks
only when it reads a result.  Every batched driver of the port keeps
``depth`` calls in flight and drains the oldest, so that the host's work on
batch k + 1 (padding, the copy into a pinned buffer, queueing the forward)
overlaps the device's work on batch k.  With ``depth`` calls in flight a
new dispatch is made before the oldest is drained, so ``depth + 1`` tickets
exist at once: a driver that reuses buffers per ticket needs that many.

On a card a batch goes through a ``SlotRing``: its rows are written into a
pinned host buffer, sent with a non-blocking copy, and its scores come back
into a pinned buffer behind an event.  A slot takes the next batch only
after that event has completed, so no copy still in flight reads a buffer
the host is refilling.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, List, Sequence

import torch


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


def record(device: torch.device) -> torch.cuda.Event:
    """An event recorded on ``device``'s current stream, where a batch's
    copies and forward were queued, whichever device is current."""
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class Slot:
    """Pinned host buffers of one batch in flight: its ``rows`` and its
    ``scores``; ``events`` mark the end of its last batch's work on each
    device that took a part of it, and ``gen`` counts the batches the slot
    has carried."""

    def __init__(self, rows_shape: Sequence[int], n_scores: int):
        self.rows = torch.empty(tuple(rows_shape), pin_memory=True)
        self.scores = torch.empty((n_scores,), pin_memory=True)
        self.events: List[torch.cuda.Event] = []
        self.gen = 0

    def wait(self) -> None:
        for event in self.events:
            event.synchronize()

    def check(self, gen: int, what: str) -> None:
        """Wait for batch ``gen`` of this slot; raise if the slot has taken
        another batch since, whose buffers have overwritten it."""
        if self.gen != gen:
            raise RuntimeError(
                f"{what}: a batch was drained after its slot was reused "
                "by a later one")
        self.wait()


class SlotRing:
    """``n`` pinned slots used in turn, made at first use: a caller with
    ``depth`` batches in flight needs ``depth + 1``."""

    def __init__(self, n: int, rows_shape: Sequence[int], n_scores: int):
        self.n, self.rows_shape, self.n_scores = n, rows_shape, n_scores
        self._slots: List[Slot] = []
        self._next = 0

    def acquire(self) -> Slot:
        """The next slot, once its last batch is off its buffers."""
        if not self._slots:
            self._slots = [Slot(self.rows_shape, self.n_scores)
                           for _ in range(self.n)]
        slot = self._slots[self._next]
        self._next = (self._next + 1) % self.n
        slot.wait()
        slot.gen += 1
        return slot
