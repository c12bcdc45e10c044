"""Score-file IO (own copy of ``aasist_tpu/evaluation/scorefile.py``).

Line format, the reference's ``produce_evaluation_file``:
``utt_id src key score``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union


def write_score_file(
    path: Union[str, Path],
    utt_ids: Sequence[str],
    scores: Sequence[float],
    trial_meta: Dict[str, Tuple[str, str]],
) -> None:
    """Write scores aligned against trial metadata.

    ``trial_meta`` maps utt_id -> (src, key) parsed from the CM protocol.
    Raises if any utt id is missing from the protocol — the reference instead
    asserted positional alignment of loader order with filtered trial lines
    (`main.py:382-386`); keying by utt id is order-independent and strictly
    safer.
    """
    if len(utt_ids) != len(scores):
        raise ValueError(
            f"got {len(utt_ids)} utt ids but {len(scores)} scores")
    with open(path, "w") as fh:
        for utt_id, score in zip(utt_ids, scores):
            try:
                src, key = trial_meta[utt_id]
            except KeyError:
                raise KeyError(
                    f"utterance {utt_id!r} not present in trial protocol")
            fh.write(f"{utt_id} {src} {key} {score}\n")


def read_score_file(
    path: Union[str, Path],
) -> List[Tuple[str, str, str, float]]:
    """Read ``utt_id src key score`` lines."""
    out = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            utt_id, src, key, score = parts
            out.append((utt_id, src, key, float(score)))
    return out
