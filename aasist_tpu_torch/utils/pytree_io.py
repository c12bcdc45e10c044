"""Read the flat ``.npz`` parameter trees of ``checkpoints/``.

Own copy of ``aasist_tpu/utils/pytree_io.py``'s loader (that module imports
JAX).  Paths in the file are '/'-joined; list indices are plain integers in
the path, and every key starts with ``params/`` or ``state/``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    """Nested dicts from '/'-joined paths; all-digit keys become lists."""
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_tree_npz(path) -> Tuple[Any, Any]:
    """(params, state) nested trees of numpy arrays from an ``.npz``."""
    with np.load(path) as data:
        p_flat = {k[len("params/"):]: data[k] for k in data.files
                  if k.startswith("params/")}
        s_flat = {k[len("state/"):]: data[k] for k in data.files
                  if k.startswith("state/")}
    return unflatten_tree(p_flat), unflatten_tree(s_flat)
