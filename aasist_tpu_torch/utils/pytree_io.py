"""Read and write the flat ``.npz`` parameter trees of ``checkpoints/``.

Own copy of ``aasist_tpu/utils/pytree_io.py``'s saver and loader (that
module imports JAX).  Paths in the file are '/'-joined; list indices are
plain integers in the path, and every key starts with ``params/`` or
``state/``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """'/'-joined paths of a tree of dicts and lists -> numpy leaves."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    """Nested dicts from '/'-joined paths; a node whose keys are 0 .. n-1
    becomes a list (the reference's ``nn.Sequential`` indices with gaps,
    such as SE's ``fc/0`` and ``fc/2``, stay a dict)."""
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
        if node and set(node) == {str(i) for i in range(len(node))}:
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_tree_npz(path, params: Any, state: Any) -> None:
    """Write (params, state) trees as ``params/...`` and ``state/...``."""
    flat = {"params/" + k: v for k, v in flatten_tree(params).items()}
    flat.update({"state/" + k: v for k, v in flatten_tree(state).items()})
    np.savez(path, **flat)


def load_tree_npz(path) -> Tuple[Any, Any]:
    """(params, state) nested trees of numpy arrays from an ``.npz``."""
    with np.load(path) as data:
        p_flat = {k[len("params/"):]: data[k] for k in data.files
                  if k.startswith("params/")}
        s_flat = {k[len("state/"):]: data[k] for k in data.files
                  if k.startswith("state/")}
    return unflatten_tree(p_flat), unflatten_tree(s_flat)
