"""Parameters of the dense, MoE, SSM (mamba2) and hybrid (hymba) models
as nested dicts
of tensors, with the reference package's keys and layouts (``embed [V,
d]``, ``blocks/attn/wq [L, d, Hq, hd]``, ``blocks/attn/wo [L, Hq, hd,
d]``, ``blocks/mlp/gate [L, d, d_ff]``, ``blocks/moe/router [L, d,
E]``, ``blocks/moe/gate [L, E, d, f]``, ``blocks/mamba/in_proj [L, d,
2 d_in + 2 N + H]``, ...).

Two sources: :func:`params_from_numpy` carries the reference package's
weights across (the caller converts them to numpy), and
:func:`init_params` draws the port's own random weights with the same
distribution, for runs that cannot take weights from the reference.

Weights are stored in the compute dtype, except the SSM decay
parameters and the MoE router, which stay f32
(``transformer.KEEP_F32``).  The reference stores f32 weights and casts
them at each use (``cast_params``); storing them cast once only moves
where the rounding to that dtype happens, and with bf16 it halves the
memory the weights take on the card."""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import KEEP_F32, d_inner

# name -> (shape, init, scale) for one leaf of the parameter tree
Spec = Tuple[Tuple[int, ...], str, float]


def _mamba_spec(cfg: ModelConfig, d_in: int) -> Dict[str, Spec]:
    """One stacked Mamba2 block of inner width ``d_in`` (the reference's
    ``ssm.mamba_spec``)."""
    s, d, L = cfg.ssm, cfg.d_model, cfg.num_layers
    n_h, n = d_in // s.head_dim, s.d_state
    conv_dim = d_in + 2 * n
    return {"in_proj": ((L, d, 2 * d_in + 2 * n + n_h), "normal", 1.0),
            "conv_w": ((L, conv_dim, s.conv_kernel), "normal", 1.0),
            "conv_b": ((L, conv_dim), "zeros", 1.0),
            "A_log": ((L, n_h), "ones", 1.0),
            "D": ((L, n_h), "ones", 1.0),
            "dt_bias": ((L, n_h), "zeros", 1.0),
            "norm_w": ((L, d_in), "ones", 1.0),
            "out_proj": ((L, d_in, d), "normal", 1.0)}


def _moe_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """One stacked MoE FFN (the reference's ``moe.moe_spec``): the router
    (kept f32), the routed experts and, when asked, the shared ones."""
    m, d, L = cfg.moe, cfg.d_model, cfg.num_layers
    e, f = m.num_experts, m.d_ff_expert
    spec: Dict[str, Any] = {"router": ((L, d, e), "normal", 1.0),
                            "gate": ((L, e, d, f), "normal", 1.0),
                            "up": ((L, e, d, f), "normal", 1.0),
                            "down": ((L, e, f, d), "normal", 1.0)}
    if m.num_shared:
        fs = f * m.num_shared
        spec["shared"] = {"gate": ((L, d, fs), "normal", 1.0),
                          "up": ((L, d, fs), "normal", 1.0),
                          "down": ((L, fs, d), "normal", 1.0)}
    return spec


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Shapes and initialisers of the dense, MoE, SSM and hybrid
    families' parameters (the reference package's
    ``transformer.model_spec``).  A hybrid block is the dense block with
    a Mamba2 sub-layer of half the SSM family's inner width beside its
    attention (``transformer.d_inner``)."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid") or cfg.uses_mla \
            or cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: the port covers the dense, MoE, SSM and hybrid "
            f"families only")
    d, v, L = cfg.d_model, cfg.padded_vocab, cfg.num_layers
    if cfg.family == "ssm":
        spec: Dict[str, Any] = {
            "embed": ((v, d), "normal", 1.0),
            "blocks": {"norm1": ((L, d), "ones", 1.0),
                       "mamba": _mamba_spec(cfg, d_inner(cfg))},
            "final_norm": ((d,), "ones", 1.0)}
        if not cfg.tie_embeddings:
            spec["lm_head"] = ((d, v), "normal", 1.0)
        return spec
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
        },
        "final_norm": ((d,), "ones", 1.0),
    }
    if cfg.family == "hybrid":
        spec["blocks"]["mamba"] = _mamba_spec(cfg, d_inner(cfg))
    spec["blocks"]["norm2"] = ((L, d), "ones", 1.0)
    if cfg.moe is not None:
        spec["blocks"]["moe"] = _moe_spec(cfg)
    else:
        spec["blocks"]["mlp"] = {"gate": ((L, d, ff), "normal", 1.0),
                                 "up": ((L, d, ff), "normal", 1.0),
                                 "down": ((L, ff, d), "normal", 1.0)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, v), "normal", 1.0)
    return spec


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device, dtype=torch.float32) -> Dict[str, Any]:
    """Random weights with the reference's distribution: normal with std
    ``scale / sqrt(shape[0])`` (the leading axis, as the reference's
    ``materialize`` takes it), ones and zeros where the spec says so.
    Draws in f32 from ``generator``, which must live on ``device``, then
    casts to ``dtype`` (the ``KEEP_F32`` leaves stay f32)."""
    def make(spec, dt):
        if isinstance(spec, dict):
            return {k: make(s, torch.float32 if k in KEEP_F32 else dt)
                    for k, s in spec.items()}
        shape, init, scale = spec
        if init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        if init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale / math.sqrt(fan_in)).to(dt)

    return make(param_specs(cfg), dtype)


def params_from_numpy(tree, *, device, dtype=torch.float32):
    """Nested dicts (and tuples) of numpy arrays (the reference's
    parameter or dense-cache pytree after ``np.asarray``) -> the same
    tree of tensors on ``device``; floating arrays become ``dtype``, the
    ``KEEP_F32`` leaves f32.  The reference's dense caches (``{"kv": (k,
    v)}``, ``{"ssm": (state, conv)}``, both for the hybrid family) have
    the port's layout, so they cross over as they are."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(
                    v, device=device,
                    dtype=torch.float32 if k in KEEP_F32 else dtype)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(params_from_numpy(v, device=device, dtype=dtype)
                     for v in tree)
    t = torch.tensor(np.asarray(tree))         # a copy: the tree stays
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
