"""Flat-npz naming for nested state (the reference package's
``train/checkpoint.py``).

Only :func:`flatten_tree` is here for now: the engine snapshot
(``serving/snapshot.py``, DESIGN.md §17) names every array it stores
through it, with the reference's keys, so either package reads the
other's files.  The trainer's ``save`` and ``restore`` come with
training.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

Leaf = Union[np.ndarray, torch.Tensor]


def _key(k: Any) -> str:
    """One path element as the reference's ``jax.tree_util.keystr``
    writes it: ``['name']`` for a dict key, ``[3]`` for a list index."""
    return f"[{k!r}]"


def flatten_tree(tree: Any) -> Dict[str, Leaf]:
    """Flatten nested dicts, lists and tuples to ``{keystr: leaf}``, in the
    reference's order (dict keys sorted) and with its keys (``"['a']"``,
    ``"['a'][0]"``).  ``None`` is an empty subtree, as in JAX.  A torch
    tensor leaf stays a tensor (detached, on the CPU), because numpy has
    no bfloat16; every other leaf becomes a numpy array.

    >>> sorted(flatten_tree({"x": np.zeros(1), "y": [np.ones(2), None]}))
    ["['x']", "['y'][0]"]
    """
    out: Dict[str, Leaf] = {}

    def walk(node: Any, path: str) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + _key(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + _key(i))
        elif isinstance(node, torch.Tensor):
            out[path] = node.detach().cpu()
        else:
            out[path] = np.asarray(node)

    walk(tree, "")
    return out
