"""Waveform loading, the eval padding policy and the eval batcher (own copy
of the eval half of ``aasist_tpu/data/dataset.py``).

Audio is decoded on host threads (``data/audio_io.py``: the native FLAC
decoder, the NumPy WAV reader) and padded to the 64,600-sample eval window.
``EvalBatcher`` yields host batches from a producer thread, two ahead; the
host-to-device copy is the dispatch's (``train/loop.py:produce_scores``),
from pinned memory.  Read errors raise: the reference's silent zero tensor
for an unreadable file, which scored it as bonafide, is not reproduced.
The training batcher and its padding waits for the training slice.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import threading
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from aasist_tpu_torch.data import audio_io

FIXED_EVAL_LEN = 64600      # ~4.04 s at 16 kHz, the reference's eval window


def pad_to_fixed(x: np.ndarray, max_len: int = FIXED_EVAL_LEN) -> np.ndarray:
    """Crop, or tile-repeat then crop, to exactly ``max_len`` samples."""
    n = x.shape[0]
    if n >= max_len:
        return x[:max_len]
    reps = max_len // n + 1
    return np.tile(x, reps)[:max_len]


def pad_into(dst: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``pad_to_fixed(x, len(dst))`` written into the row ``dst`` with no
    intermediate array (the Scorer fills its pinned buffer with it)."""
    max_len, n = dst.shape[0], x.shape[0]
    if n >= max_len:
        dst[:] = x[:max_len]
        return dst
    dst[:n] = x
    done = n
    while done < max_len:                  # double the repeated prefix
        k = min(done, max_len - done)
        dst[done:done + k] = dst[:k]
        done += k
    return dst


# ------------------------------------------------------------- audio store
class AudioStore:
    """Reads waveforms for utterance ids from a dataset directory.

    Layout matches ASVspoof2019: ``{base_dir}/flac/{utt_id}.flac``; plain
    ``.wav`` files are also accepted (the synthetic corpus's WAV form).
    """

    def __init__(self, base_dir):
        self.base_dir = Path(base_dir)
        self._flac = self.base_dir / "flac"

    def read(self, utt_id: str) -> np.ndarray:
        p = self._flac / f"{utt_id}.flac"
        if p.exists():
            # one native pass to float32 (exact for <= 24-bit PCM)
            from aasist_tpu_torch.data.flac_native import read_flac_f32
            data, _sr = read_flac_f32(p)
            if data.ndim > 1:
                # multichannel: mean-downmix, as the WAV reader does
                data = data.mean(axis=1, dtype=np.float32)
            return data
        p = self._flac / f"{utt_id}.wav"
        if p.exists():
            data, _sr = audio_io.read_audio(p)
            return np.asarray(data)
        raise FileNotFoundError(
            f"no audio for {utt_id!r} under {self._flac}")


# ---------------------------------------------------------------- batchers
class _ConsumerGone(BaseException):
    """Raised inside a producer thread when its consumer went away."""


def _iter_prefetched(produce: Callable, prefetch: int) -> Iterator:
    """Items produced on a daemon thread, with bounded prefetch.

    ``produce(emit)`` is run on the thread and calls ``emit(item)`` once
    per batch; producer errors re-raise in the consumer.  Closing the
    returned generator (or abandoning iteration: ``break``, an exception,
    garbage collection) sets a stop flag that ``emit`` polls while blocked
    on the bounded queue, so the producer thread and its prefetched batches
    are released at once.
    """
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    done = object()

    def emit(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue
        raise _ConsumerGone

    def run():
        try:
            produce(emit)
        except _ConsumerGone:
            return
        except BaseException as e:  # surface worker errors to consumer
            item = e
        else:
            item = done
        try:
            emit(item)
        except _ConsumerGone:
            pass

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _pad_batch_rows(rows: List[np.ndarray], pad_rows_to: int
                    ) -> Tuple[np.ndarray, int]:
    """Stack rows, padding the batch dim to ``pad_rows_to`` by repeating the
    last row (one batch shape; callers drop the tail's scores)."""
    n_real = len(rows)
    if n_real < pad_rows_to:
        rows = rows + [rows[-1]] * (pad_rows_to - n_real)
    # copy=False: FLAC rows are already float32
    return np.stack(rows).astype(np.float32, copy=False), n_real


class EvalBatcher:
    """Deterministic fixed-length batches for dev/eval scoring.

    Equivalent of the reference's ``Dataset_ASVspoof2019_deveval`` and its
    DataLoader: fixed 64,600-sample padding, one batch shape (the tail
    batch padded by repetition), threaded decode, ``prefetch`` batches
    made ahead on a producer thread.  Batches stay on the host.
    """

    def __init__(self, store: AudioStore, utt_ids: Sequence[str],
                 batch_size: int, num_threads: Optional[int] = None,
                 fixed_len: int = FIXED_EVAL_LEN, prefetch: int = 2):
        self.store = store
        self.utt_ids = list(utt_ids)
        self.batch_size = batch_size
        self.fixed_len = fixed_len
        self.num_threads = (num_threads if num_threads is not None
                            else min(8, os.cpu_count() or 1))
        self.prefetch = prefetch

    def __len__(self):
        return -(-len(self.utt_ids) // self.batch_size)

    def _load_one(self, utt_id: str) -> np.ndarray:
        return pad_to_fixed(self.store.read(utt_id), self.fixed_len)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, List[str], int]]:
        """Yields (host batch (B, L) float32, utt_ids, n_real)."""
        def produce(emit):
            with cf.ThreadPoolExecutor(self.num_threads) as pool:
                for i in range(0, len(self.utt_ids), self.batch_size):
                    ids = self.utt_ids[i:i + self.batch_size]
                    rows = list(pool.map(self._load_one, ids))
                    batch, n_real = _pad_batch_rows(rows, self.batch_size)
                    emit((batch, ids, n_real))

        return _iter_prefetched(produce, self.prefetch)
