"""Flat-npz checkpointing for nested state (the reference package's
``train/checkpoint.py``).

:func:`flatten_tree` names every array on disk: the trainer's
:func:`save` and the engine snapshot (``serving/snapshot.py``, DESIGN.md
§17) both flatten through it, with the reference's keys, so either
package reads the other's files.  A bf16 tensor is written as its 16
bits under numpy's 2-byte void dtype (``|V2``), the bytes the
reference's ``np.savez`` writes for a bf16 array, and read back as
``torch.bfloat16`` by a view (numpy has no bfloat16; no ``ml_dtypes``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Tuple, Union

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
    return {path: leaf.detach().cpu() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for path, leaf in _walk(tree)}


def _walk(node: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) of every leaf of ``node``, in :func:`flatten_tree`'s
    order, the leaves as they are."""
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _walk(node[k], path + _key(k))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _walk(v, path + _key(i))
    else:
        yield path, node


class CheckpointMismatchError(ValueError):
    """A restored array disagrees with the ``like`` template: a missing
    or extra key, a wrong shape, or a wrong dtype."""


BF16_ON_DISK = np.dtype("V2")   # what np.savez makes of a bf16 array


def _to_numpy(leaf: Leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(BF16_ON_DISK)
        return leaf.numpy()
    return leaf


def _disk_dtype(leaf: Any) -> np.dtype:
    """The dtype ``leaf`` has in a file."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return BF16_ON_DISK
        return np.dtype(str(leaf.dtype).rsplit(".", 1)[-1])
    return np.asarray(leaf).dtype


def save(path: str, tree: Any, step: int = 0) -> None:
    """Write ``tree`` (nested dicts of tensors or arrays) and ``step`` to
    the npz at ``path``, with the reference's keys."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in flatten_tree(tree).items()}
    np.savez(path, __step__=np.int64(step), **arrays)


def _unflatten(like: Any, values: Dict[str, Any], path: str = "") -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, values, path + _key(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, values, path + _key(i))
                          for i, v in enumerate(like))
    return values[path]


def restore(path: str, like: Any, device=None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (nested dicts of tensors,
    or of arrays); returns (tree, step).  Every leaf is validated
    against the template: a key absent from the file or present only in
    the file, a shape mismatch or a dtype mismatch raises
    :class:`CheckpointMismatchError`.  Tensor leaves come back as
    tensors of the template's dtype on ``device`` (default: the
    template leaf's device), array leaves as arrays."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        step = int(data["__step__"])
        want = dict(_walk(like))
        extra = sorted(k for k in data.files
                       if k != "__step__" and k not in want)
        if extra:
            raise CheckpointMismatchError(
                f"{path}: file holds arrays the template does not: {extra}")
        values = {}
        for key, leaf in want.items():
            if key not in data:
                raise CheckpointMismatchError(
                    f"{path}: missing array {key!r}")
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise CheckpointMismatchError(
                    f"{path}: {key!r} has shape {arr.shape}, "
                    f"template wants {tuple(leaf.shape)}")
            if arr.dtype != _disk_dtype(leaf):
                raise CheckpointMismatchError(
                    f"{path}: {key!r} has dtype {arr.dtype}, "
                    f"template wants {_disk_dtype(leaf)}")
            if isinstance(leaf, torch.Tensor):
                t = torch.from_numpy(np.ascontiguousarray(arr).view(
                    np.int16)).view(torch.bfloat16) \
                    if leaf.dtype == torch.bfloat16 \
                    else torch.from_numpy(np.array(arr))
                values[key] = t.to(leaf.device if device is None else device)
            else:
                values[key] = np.array(arr)
    return _unflatten(like, values), step
