"""The numbers that decide ``correct``, and their limits.

Only the numbers a cell's ``limits/<cell>.json`` names are judged; the
others are read for the record.

Scoring: every sampled score of the window against the plain reference's
score of the same utterance, as ``gap_mean`` (the mean absolute gap) and
``gap_max`` (the widest, read: set by a few utterances, it reads bf16
within 1.3x of fp8 and so cannot tell them apart).

Training: the first three steps against the reference's, as
``loss_gap`` (step 1's |loss - ref| / |ref|), ``grad_gap`` (the first
gradient as the optimizer took it, by the worst leaf) and ``update_gap``
(each parameter's change after the three steps, by the median leaf); a
leaf's gap is that between its norm and the reference's, over the larger
of the reference's norm of that leaf and of the median leaf.  The later
steps' losses and the worst leaf's change are read: from step 2 on,
round-off can tip graph pooling's discrete node selection on a few seeds,
in the reference against itself too.  Leaves whose
raw reference gradient is under a thousandth of the median leaf's (biases
that a train-mode BatchNorm cancels, the residual blocks' unused ``bn1``)
move by round-off alone under Adam, and are left out by that rule.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

NEGLIGIBLE = 1e-3


def score_readings(program: np.ndarray, reference: np.ndarray
                   ) -> Dict[str, float]:
    d = np.abs(np.asarray(program, np.float64)
               - np.asarray(reference, np.float64))
    return {"gap_max": float(d.max()), "gap_mean": float(d.mean())}


def _norms(tensors) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def compared_leaves(raw_ref_grad) -> List[str]:
    norms = _norms(raw_ref_grad)
    med = statistics.median(norms.values())
    return sorted(n for n, v in norms.items() if v >= NEGLIGIBLE * med)


def norm_gap(program, reference, leaves: Iterable[str],
             pick=max) -> float:
    """The worst leaf's gap of norms (``pick=statistics.median``: the
    median leaf's); a leaf the program does not hold (no optimizer state:
    it never took a step) has norm 0."""
    leaves = list(leaves)
    pn = {n: float(program[n].double().norm()) if n in program else 0.0
          for n in leaves}
    rn = _norms({n: reference[n] for n in leaves})
    med = statistics.median(rn.values())
    return pick([abs(pn[n] - rn[n]) / max(rn[n], med) for n in leaves])


def train_readings(program: Dict, reference: Dict) -> Dict[str, float]:
    """``program`` and ``reference`` each hold ``losses``, ``grad1`` and
    ``delta`` (leaf name -> tensor); ``reference`` also ``raw1``."""
    leaves = compared_leaves(reference["raw1"])
    steps = [abs(p - r) / abs(r) for p, r in zip(program["losses"],
                                                 reference["losses"])]
    return {"loss_gap": steps[0],
            "loss_gap.later": max(steps[1:], default=0.0),
            "grad_gap": norm_gap(program["grad1"], reference["grad1"],
                                 leaves),
            "update_gap": norm_gap(program["delta3"], reference["delta3"],
                                   leaves, statistics.median),
            "update_gap.worst2": norm_gap(program["delta"],
                                          reference["delta"], leaves),
            "update_gap.worst3": norm_gap(program["delta3"],
                                          reference["delta3"], leaves)}


def judge(readings: Dict[str, float], limits: Dict[str, Dict]
          ) -> Tuple[bool, Dict[str, Dict[str, Optional[float]]]]:
    """(every reading finite and within its limit, {name: {value,
    limit}}); a reading that is not finite is reported as null."""
    checks, ok = {}, True
    for name, spec in limits.items():
        value = readings.get(name)
        finite = value is not None and math.isfinite(value)
        ok = ok and finite and value <= spec["limit"]
        checks[name] = {"value": value if finite else None,
                        "limit": spec["limit"]}
    return ok, checks
