"""Parameters of the dense transformer as nested dicts of tensors, with
the reference package's keys and layouts (``embed [V, d]``,
``blocks/attn/wq [L, d, Hq, hd]``, ``blocks/attn/wo [L, Hq, hd, d]``,
``blocks/mlp/gate [L, d, d_ff]``, ...).

Two sources: :func:`params_from_numpy` carries the reference package's
weights across (the caller converts them to numpy), and
:func:`init_params` draws the port's own random weights with the same
distribution, for runs that cannot take weights from the reference.

Weights are stored in the compute dtype.  The reference stores f32
weights and casts them at each use (``cast_params``); storing them cast
once only moves where the rounding to that dtype happens, and with
bf16 it halves the memory the weights take on the card."""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

# name -> (shape, init, scale) for one leaf of the parameter tree
Spec = Tuple[Tuple[int, ...], str, float]


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Shapes and initialisers of the dense family's parameters (the
    reference package's ``transformer.model_spec``)."""
    if cfg.family != "dense" or cfg.moe is not None or cfg.uses_mla \
            or cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: the port covers the dense family only")
    d, v, L = cfg.d_model, cfg.padded_vocab, cfg.num_layers
    hq = max(cfg.num_heads, cfg.pad_heads_to)
    hkv, hd, ff = cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    attn = {"wq": ((L, d, hq, hd), "normal", 1.0),
            "wk": ((L, d, hkv, hd), "normal", 1.0),
            "wv": ((L, d, hkv, hd), "normal", 1.0),
            "wo": ((L, hq, hd, d), "normal", 1.0)}
    if cfg.qkv_bias:
        attn["bq"] = ((L, hq, hd), "zeros", 1.0)
        attn["bk"] = ((L, hkv, hd), "zeros", 1.0)
        attn["bv"] = ((L, hkv, hd), "zeros", 1.0)
    spec: Dict[str, Any] = {
        "embed": ((v, d), "normal", 1.0),
        "blocks": {
            "norm1": ((L, d), "ones", 1.0),
            "attn": attn,
            "norm2": ((L, d), "ones", 1.0),
            "mlp": {"gate": ((L, d, ff), "normal", 1.0),
                    "up": ((L, d, ff), "normal", 1.0),
                    "down": ((L, ff, d), "normal", 1.0)},
        },
        "final_norm": ((d,), "ones", 1.0),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, v), "normal", 1.0)
    return spec


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device, dtype=torch.float32) -> Dict[str, Any]:
    """Random weights with the reference's distribution: normal with std
    ``scale / sqrt(shape[0])`` (the leading axis, as the reference's
    ``materialize`` takes it), ones and zeros where the spec says so.
    Draws in f32 from ``generator``, which must live on ``device``, then
    casts to ``dtype``."""
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(s) for k, s in spec.items()}
        shape, init, scale = spec
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale / math.sqrt(fan_in)).to(dtype)

    return make(param_specs(cfg))


def params_from_numpy(tree, *, device, dtype=torch.float32):
    """Nested dicts (and tuples) of numpy arrays (the reference's
    parameter or dense-cache pytree after ``np.asarray``) -> the same
    tree of tensors on ``device``; floating arrays become ``dtype``.  The
    reference's dense cache ``{"kv": (k, v)}`` has the port's layout, so
    it crosses over as it is."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(params_from_numpy(v, device=device, dtype=dtype)
                     for v in tree)
    t = torch.tensor(np.asarray(tree))         # a copy: the tree stays
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
