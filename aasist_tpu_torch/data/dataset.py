"""Waveform loading, padding policies and the batchers (own copy of
``aasist_tpu/data/dataset.py``).

Audio is decoded on host threads (``data/audio_io.py``: the native FLAC
decoder, the NumPy WAV reader).  Eval: padded to the 64,600-sample window;
``EvalBatcher`` yields host batches from a producer thread, two ahead; the
host-to-device copy is the dispatch's (``train/loop.py:produce_scores``),
from pinned memory.  Training: ``TrainBatcher`` shuffles per epoch, crops
or tiles each row to the 96,000-sample window (``pad_random``) or to its
own dynamic chunk size (DCS: ``dynamic_chunk``, the batch zero-padded to a
bucket length), and yields CPU tensors (pinned on request) that the train
loop copies to the device without blocking; with the same seed and corpus
its arrays are the JAX batcher's, bit for bit.  Read errors raise: the
reference's silent zero tensor for an unreadable file, which scored it as
bonafide, is not reproduced.

In a data-parallel run (``rank`` of ``world``) both batchers plan the
global batches as one process does and decode only this rank's rows
(``parallel/mesh.py:local_rows``).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import threading
import time
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aasist_tpu_torch.data import audio_io
from aasist_tpu_torch.parallel.mesh import local_rows

FIXED_EVAL_LEN = 64600      # ~4.04 s at 16 kHz, the reference's eval window
FIXED_TRAIN_LEN = 96000     # 6 s at 16 kHz, the fork's train window


def pad_to_fixed(x: np.ndarray, max_len: int = FIXED_EVAL_LEN) -> np.ndarray:
    """Crop, or tile-repeat then crop, to exactly ``max_len`` samples."""
    n = x.shape[0]
    if n >= max_len:
        return x[:max_len]
    reps = max_len // n + 1
    return np.tile(x, reps)[:max_len]


def pad_random(x: np.ndarray, max_len: int,
               rng: np.random.Generator) -> np.ndarray:
    """Random crop when longer, tile-repeat then crop when shorter.  The
    crop start is drawn from [0, n - max_len): the reference's exclusive
    upper bound (``np.random.randint(n - max_len)``), so the last start is
    never drawn; n == max_len returns ``x`` (the reference crashes)."""
    n = x.shape[0]
    if n > max_len:
        start = rng.integers(0, n - max_len)
        return x[start:start + max_len]
    if n == max_len:
        return x
    reps = max_len // n + 1
    return np.tile(x, reps)[:max_len]


def bucket_lengths(min_samples: int, max_samples: int,
                   num_buckets: int) -> np.ndarray:
    """The DCS length buckets: ``num_buckets`` from min to max, each
    rounded up to a multiple of 4, so the top one covers ``max_samples``."""
    ls = np.linspace(min_samples, max_samples, num_buckets)
    return np.ceil(ls / 4).astype(np.int64) * 4


def dynamic_chunk(x: np.ndarray, rng: np.random.Generator,
                  target: int, pad_to: int) -> Tuple[np.ndarray, float]:
    """One DCS row: a random crop (start uniform over 0 .. n - target,
    inclusive) or a tiling of ``x`` to ``target`` samples, zero-padded to
    ``pad_to``; and its duration, target / 16000 s, which ALMFT's margin
    reads."""
    n = x.shape[0]
    if n >= target:
        start = rng.integers(0, n - target + 1)
        row = x[start:start + target]
    else:
        row = np.tile(x, target // n + 1)[:target]
    if target < pad_to:
        row = np.concatenate([row, np.zeros(pad_to - target,
                                            dtype=row.dtype)])
    return row, target / 16000.0


def draw_chunk_targets(rng: np.random.Generator, n: int, min_samples: int,
                       max_samples: int) -> np.ndarray:
    """Per-row DCS targets, uniform over min .. max inclusive (the
    reference's ``np.random.randint(min, max + 1)``)."""
    return rng.integers(min_samples, max_samples + 1, size=n)


def snap_up_to_bucket(value: int, buckets: np.ndarray) -> int:
    """The smallest bucket >= value (buckets ascending; the top one if
    none)."""
    idx = int(np.searchsorted(buckets, value, side="left"))
    return int(buckets[min(idx, len(buckets) - 1)])


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

    With ``world`` > 1 each batch of ``batch_size`` (a multiple of
    ``world``) yields this rank's ``batch_size // world`` rows, the padding
    of the last batch included: a rank whose rows are all padding decodes
    the batch's last utterance once.  ``seconds`` adds up the decode and
    padding of the last pass.
    """

    def __init__(self, store: AudioStore, utt_ids: Sequence[str],
                 batch_size: int, num_threads: Optional[int] = None,
                 fixed_len: int = FIXED_EVAL_LEN, prefetch: int = 2,
                 rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"eval batch {batch_size} is not a multiple of "
                             f"the {world} ranks")
        self.store = store
        self.utt_ids = list(utt_ids)
        self.batch_size = batch_size
        self.fixed_len = fixed_len
        self.num_threads = (num_threads if num_threads is not None
                            else min(8, os.cpu_count() or 1))
        self.prefetch = prefetch
        self.rank, self.world = rank, world
        self.seconds = 0.0

    def __len__(self):
        return -(-len(self.utt_ids) // self.batch_size)

    def _load_one(self, utt_id: str) -> np.ndarray:
        return pad_to_fixed(self.store.read(utt_id), self.fixed_len)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, List[str], int]]:
        """Yields (host batch (B, L) float32, utt_ids, n_real); with
        ``world`` > 1 the batch is this rank's rows and ``utt_ids`` and
        ``n_real`` are the whole batch's."""
        share = self.batch_size // self.world
        lo = self.rank * share
        self.seconds = 0.0

        def produce(emit):
            with cf.ThreadPoolExecutor(self.num_threads) as pool:
                for i in range(0, len(self.utt_ids), self.batch_size):
                    t0 = time.perf_counter()
                    ids = self.utt_ids[i:i + self.batch_size]
                    mine = ids[lo:lo + share] or ids[-1:]
                    rows = list(pool.map(self._load_one, mine))
                    batch, _ = _pad_batch_rows(rows, share)
                    self.seconds += time.perf_counter() - t0
                    emit((batch, ids, len(ids)))

        return _iter_prefetched(produce, self.prefetch)


class TrainBatcher:
    """Shuffled training batches, fixed-length or DCS windows.

    Equivalent of the reference's ``Dataset_ASVspoof2019_train`` and its
    DataLoader: a per-epoch shuffle from ``default_rng((seed, epoch))``,
    drop-last batches, labels from the protocol (bonafide 1), and each row
    its own generator ``default_rng((seed, epoch, b, j))``, so any epoch
    is reproduced from the seed alone.  Fixed mode crops or tiles every
    row to ``fixed_len``; DCS mode (``dcs_buckets``) draws each row's
    target length in [dcs_min, dcs_max], crops or tiles it to that and
    zero-pads the batch to the smallest bucket covering its longest row.
    Yields CPU tensors (x (B, L) float32, y (B,) int64, durations (B,)
    float32 seconds), pinned when ``pin_memory``.

    With ``world`` > 1 the shuffle, the DCS lengths and the row generators
    are the global batch's and the batcher decodes and yields only this
    rank's rows of it: its share of each of the ``groups`` microbatches
    (gradient accumulation), in order.

    ``counters`` holds running totals over every batch made, kept by the
    producer threads (a profiler records no spans of its threads):
    ``batches``, and the milliseconds of ``rows_ms`` (the pool's reads and
    crops), ``collate_ms`` (stacking and casting the rows, the label and
    duration tensors), ``pin_ms`` (the copies into pinned memory) and
    ``produce_ms`` (the whole batch, all of these and its plan; not the
    wait for room in the prefetch queue), each a sum of
    ``time.perf_counter`` differences.  Each batch publishes a new dict
    under a lock: one read of ``counters`` is one consistent set of
    totals, and a dropped iterator's producer still running beside a new
    one's loses no update.  A caller reads their change over an interval
    (``train/loop.py:run_training`` logs the producer's ms a batch of
    each epoch).
    """

    def __init__(self, store: AudioStore, utt_ids: Sequence[str],
                 labels: dict, batch_size: int, seed: int,
                 dcs_buckets: Optional[np.ndarray] = None,
                 dcs_min: int = 16000, dcs_max: int = 96000,
                 fixed_len: int = FIXED_TRAIN_LEN,
                 num_threads: Optional[int] = None, prefetch: int = 2,
                 pin_memory: bool = False, rank: int = 0, world: int = 1,
                 groups: int = 1):
        self.store = store
        self.utt_ids = list(utt_ids)
        self.labels = labels
        self.batch_size = batch_size
        self.seed = seed
        self.dcs_buckets = (np.sort(np.asarray(dcs_buckets))
                            if dcs_buckets is not None else None)
        if (self.dcs_buckets is not None
                and int(self.dcs_buckets[-1]) < dcs_max):
            raise ValueError(f"dcs_buckets top ({int(self.dcs_buckets[-1])})"
                             f" must cover dcs_max ({dcs_max})")
        self.dcs_min = dcs_min
        self.dcs_max = dcs_max
        self.fixed_len = fixed_len
        self.num_threads = (num_threads if num_threads is not None
                            else min(8, os.cpu_count() or 1))
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.rows = local_rows(batch_size, rank, world, groups)
        self.epoch = 0
        self.counters = {"batches": 0, "rows_ms": 0.0, "collate_ms": 0.0,
                         "pin_ms": 0.0, "produce_ms": 0.0}
        self._counting = threading.Lock()

    def __len__(self):
        return len(self.utt_ids) // self.batch_size  # drop_last

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _load_row(self, utt_id: str, target: int, pad_to: int,
                  row_rng: np.random.Generator) -> Tuple[np.ndarray, float]:
        x = self.store.read(utt_id)
        if self.dcs_buckets is not None:
            return dynamic_chunk(x, row_rng, target, pad_to)
        return pad_random(x, target, row_rng), target / 16000.0

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]]:
        order = np.random.default_rng((self.seed, self.epoch)).permutation(
            len(self.utt_ids))
        epoch = self.epoch

        def produce(emit):
            with cf.ThreadPoolExecutor(self.num_threads) as pool:
                for b in range(len(self)):
                    t0 = time.perf_counter()
                    idx = order[b * self.batch_size:
                                (b + 1) * self.batch_size]
                    ids = [self.utt_ids[i] for i in idx]
                    row_rngs = [np.random.default_rng(
                        (self.seed, epoch, b, j)) for j in range(len(ids))]
                    if self.dcs_buckets is not None:
                        targets = [int(draw_chunk_targets(
                            r, 1, self.dcs_min, self.dcs_max)[0])
                            for r in row_rngs]
                        pad_to = snap_up_to_bucket(max(targets),
                                                   self.dcs_buckets)
                    else:
                        targets = [self.fixed_len] * len(ids)
                        pad_to = self.fixed_len
                    ids = [ids[j] for j in self.rows]
                    t1 = time.perf_counter()
                    out = list(pool.map(
                        self._load_row, ids, [targets[j] for j in self.rows],
                        [pad_to] * len(ids),
                        [row_rngs[j] for j in self.rows]))
                    t2 = time.perf_counter()
                    batch = (
                        torch.from_numpy(np.stack([r for r, _ in out])
                                         .astype(np.float32, copy=False)),
                        torch.tensor([self.labels[u] for u in ids],
                                     dtype=torch.int64),
                        torch.tensor([d for _, d in out],
                                     dtype=torch.float32))
                    t3 = time.perf_counter()
                    if self.pin_memory:
                        batch = tuple(t.pin_memory() for t in batch)
                    t4 = time.perf_counter()
                    self._count(rows_ms=t2 - t1, collate_ms=t3 - t2,
                                pin_ms=t4 - t3, produce_ms=t4 - t0)
                    emit(batch)

        return _iter_prefetched(produce, self.prefetch)

    def _count(self, **seconds: float) -> None:
        """Add one batch and its stages' seconds to ``counters``."""
        with self._counting:
            totals = dict(self.counters)
            totals["batches"] += 1
            for key, s in seconds.items():
                totals[key] += 1e3 * s
            self.counters = totals
