"""Logical-axis partitioning (the reference package's ``partitioning.py``,
MaxText-style rules).

Every parameter, activation and cache leaf is annotated with a tuple of
*logical* axis names; a rule table maps logical axes onto mesh axes per
workload mode.  :func:`resolve_spec` drops a mapping whenever the
dimension is not divisible by the mapped mesh extent (qwen's 40 heads on
a 16-way model axis): replication instead of padding.

A spec is a tuple of mesh-axis names (or tuples of them) and ``None``s,
one a dimension, trailing ``None``s trimmed, as ``jax.sharding.
PartitionSpec`` holds them.  A mesh is anything with ``axis_names`` and
``devices.shape`` (``launch/mesh.py``'s :class:`~repro_torch.launch.mesh.
Mesh`, a ``DeviceMesh``; or a stand-in holding those two).

Eager PyTorch has no compiler to hint, so :func:`constrain` is the
identity: outside the context-parallel decode attention
(``models/attention.py`` ``gqa_decode_attention_cp``) every rank
computes the replicated model.  A cache is placed with
:func:`shard_local`, which cuts this rank's block out of a tensor."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]


def sharding_rules(mode: str, *, multi_pod: bool = False,
                   fsdp: bool = False,
                   expert_2d: bool = False,
                   overrides: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Logical -> mesh mapping.

    mode: "train" | "prefill" | "decode".
    fsdp: also shard large weight matrices over the data axis.
    expert_2d: shard the expert axis over (data, model), for
    ``num_experts == data * model``."""
    batch_axes: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    fsdp_axes = (("pod", "data") if multi_pod else "data") if fsdp else None
    rules: Dict[str, Any] = {
        # weights
        "embed": fsdp_axes,
        "embed_out": None,
        "q_heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": ("data", "model") if expert_2d else "model",
        "expert_mlp": None,
        "lora": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "conv": None,
        "layers": None,
        # activations
        "act_batch": batch_axes,
        "act_seq": "model" if mode in ("train", "prefill") else None,
        "act_embed": None,
        "act_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        # caches (decode): context parallelism over the model axis
        "kv_seq": "model" if mode in ("decode", "prefill") else None,
        "cache_batch": batch_axes,
        "cache_heads": None,
        # MoE dispatch groups follow the token/batch sharding
        "expert_groups": batch_axes,
    }
    if overrides:
        rules.update(overrides)
    return rules


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: extent} of ``mesh``."""
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


def resolve_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                 rules: Dict[str, Any], mesh) -> Spec:
    """Map logical axes to a spec, dropping mappings that do not divide
    their dimension (a prefix of the mesh axes that divides is kept) and
    never using a mesh axis twice."""
    extents = mesh_shape(mesh)
    used: set = set()
    parts = []
    for dim, ax in zip(shape, axes):
        mapped = rules.get(ax) if ax is not None else None
        if mapped is None:
            parts.append(None)
            continue
        mesh_axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        mesh_axes = tuple(m for m in mesh_axes
                          if m in extents and m not in used)
        while mesh_axes and dim % math.prod(extents[m]
                                            for m in mesh_axes):
            mesh_axes = mesh_axes[:-1]
        if not mesh_axes:
            parts.append(None)
            continue
        used.update(mesh_axes)
        parts.append(mesh_axes[0] if len(mesh_axes) == 1 else mesh_axes)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(axes_tree: Any, shape_tree: Any, rules: Dict[str, Any],
                   mesh) -> Any:
    """A tree of specs from a tree of logical axes and a tree of the
    same structure whose leaves are shapes, tensors, or ``(shape,
    dtype)`` stand-ins."""
    if _is_axes(axes_tree):
        leaf = shape_tree
        if isinstance(leaf, tuple) and len(leaf) == 2 \
                and isinstance(leaf[1], torch.dtype):
            leaf = leaf[0]
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        return resolve_spec(axes_tree, shape, rules, mesh)
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(v, shape_tree[k], rules, mesh)
                for k, v in axes_tree.items()}
    return type(axes_tree)(tree_shardings(a, s, rules, mesh)
                           for a, s in zip(axes_tree, shape_tree))


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]],
              rules: Optional[Dict[str, Any]]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes: the
    identity here, as eager PyTorch has no compiler to hint and every
    rank computes the replicated model (``axes`` and ``rules`` are
    accepted so that the call sites read as the reference's)."""
    return x


def with_mesh_rules(rules: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``rules`` with the mesh under ``"_mesh"``, where the model's
    decode finds it (the context-parallel branch)."""
    out = dict(rules)
    out["_mesh"] = mesh
    return out


def shard_local(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: each dimension mapped
    to mesh axes is cut into their product's equal blocks, and the block
    at this rank's coordinate (row-major over the listed axes) is kept.
    A view (strided where a cut dimension is not the first): the
    decode kernel reads a contiguous copy.  ``mesh`` gives this rank's
    coordinate along an axis by ``get_local_rank(axis)``, as a
    ``DeviceMesh`` does."""
    extents = mesh_shape(mesh)
    out = x
    for dim, part in enumerate(spec):
        if part is None:
            continue
        names = (part,) if isinstance(part, str) else tuple(part)
        n, idx = 1, 0
        for name in names:
            idx = idx * extents[name] + mesh.get_local_rank(name)
            n *= extents[name]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"divide into {n} blocks ({names})")
        size = x.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out
