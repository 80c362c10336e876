"""Parameters of every model family (the dense, MoE, MLA (deepseek-v3),
SSM (mamba2), hybrid (hymba), vlm (internvl2) and encoder-decoder
(whisper) families) as nested dicts of tensors, with the reference
package's keys and layouts (``embed [V, d]``, ``blocks/attn/wq [L, d,
Hq, hd]``, ``blocks/attn/wo [L, Hq, hd, d]``, ``blocks/mla/k_b [L, R,
H, Dn]``, ``blocks/mlp/gate [L, d, d_ff]``, ``blocks/moe/router [L, d,
E]``, ``blocks/moe/gate [L, E, d, f]``, ``blocks/mamba/in_proj [L, d, 2
d_in + 2 N + H]``, ``projector [d, d]``, ``mtp/block/...``,
``enc_blocks/attn/bq [L_enc, H, hd]``, ``dec_blocks/cross/wo [L, H, hd,
d]``, ``dec_blocks/mlp/up_b [L, d_ff]``, ...).

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
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import KEEP_F32, d_inner

class Spec(NamedTuple):
    """One leaf of the parameter tree: its shape, initialiser ("normal",
    "zeros" or "ones"), the normal's std multiplier and its logical axes
    (the reference's ``ParamSpec.axes``, one name or None a dimension,
    which ``partitioning.resolve_spec`` maps onto a mesh)."""
    shape: Tuple[int, ...]
    init: str
    scale: float
    axes: Tuple[Optional[str], ...]


def _w(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
       init: str = "normal") -> Spec:
    assert len(shape) == len(axes), (shape, axes)
    return Spec(tuple(shape), init, 1.0, tuple(axes))


def _mamba_spec(cfg: ModelConfig, d_in: int) -> Dict[str, Spec]:
    """One Mamba2 block of inner width ``d_in`` (the reference's
    ``ssm.mamba_spec``)."""
    s, d = cfg.ssm, cfg.d_model
    n_h, n = d_in // s.head_dim, s.d_state
    conv_dim = d_in + 2 * n
    return {"in_proj": _w((d, 2 * d_in + 2 * n + n_h),
                          ("embed", "ssm_inner")),
            "conv_w": _w((conv_dim, s.conv_kernel), ("ssm_inner", "conv")),
            "conv_b": _w((conv_dim,), ("ssm_inner",), "zeros"),
            "A_log": _w((n_h,), ("ssm_heads",), "ones"),
            "D": _w((n_h,), ("ssm_heads",), "ones"),
            "dt_bias": _w((n_h,), ("ssm_heads",), "zeros"),
            "norm_w": _w((d_in,), ("ssm_inner",), "ones"),
            "out_proj": _w((d_in, d), ("ssm_inner", "embed"))}


def _mlp_spec(d: int, d_ff: int) -> Dict[str, Spec]:
    """A SwiGLU MLP (the reference's ``layers.mlp_spec``)."""
    return {"gate": _w((d, d_ff), ("embed", "mlp")),
            "up": _w((d, d_ff), ("embed", "mlp")),
            "down": _w((d_ff, d), ("mlp", "embed"))}


def _moe_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """One MoE FFN (the reference's ``moe.moe_spec``): the router (kept
    f32), the routed experts and, when asked, the shared ones."""
    m, d = cfg.moe, cfg.d_model
    e, f = m.num_experts, m.d_ff_expert
    spec: Dict[str, Any] = {
        "router": _w((d, e), ("embed", "experts")),
        "gate": _w((e, d, f), ("experts", "embed", "expert_mlp")),
        "up": _w((e, d, f), ("experts", "embed", "expert_mlp")),
        "down": _w((e, f, d), ("experts", "expert_mlp", "embed"))}
    if m.num_shared:
        spec["shared"] = _mlp_spec(d, f * m.num_shared)
    return spec


def _mla_spec(cfg: ModelConfig) -> Dict[str, Spec]:
    """One MLA sub-layer (the reference's ``mla.mla_spec``): the query's
    low-rank pair with its norm, the KV latent's down-projection (with
    the shared rotary key) and norm, the latent's per-head key and value
    up-projections, and the output projection."""
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qh = m.qk_nope_dim + m.qk_rope_dim
    heads = ("lora", "q_heads", "head_dim")
    return {"q_a": _w((d, m.q_lora_rank), ("embed", "lora")),
            "q_a_norm": _w((m.q_lora_rank,), ("lora",), "ones"),
            "q_b": _w((m.q_lora_rank, h, qh), heads),
            "kv_a": _w((d, m.kv_lora_rank + m.qk_rope_dim),
                       ("embed", "lora")),
            "kv_a_norm": _w((m.kv_lora_rank,), ("lora",), "ones"),
            "k_b": _w((m.kv_lora_rank, h, m.qk_nope_dim), heads),
            "v_b": _w((m.kv_lora_rank, h, m.v_head_dim), heads),
            "out": _w((h, m.v_head_dim, d), ("q_heads", "head_dim", "embed"))}


def _attn_spec(cfg: ModelConfig) -> Dict[str, Spec]:
    """One GQA sub-layer, its query heads padded to ``pad_heads_to``."""
    d, hkv, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    hq = max(cfg.num_heads, cfg.pad_heads_to)
    attn = {"wq": _w((d, hq, hd), ("embed", "q_heads", "head_dim")),
            "wk": _w((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
            "wv": _w((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
            "wo": _w((hq, hd, d), ("q_heads", "head_dim", "embed"))}
    if cfg.qkv_bias:
        attn["bq"] = _w((hq, hd), ("q_heads", "head_dim"), "zeros")
        attn["bk"] = _w((hkv, hd), ("kv_heads", "head_dim"), "zeros")
        attn["bv"] = _w((hkv, hd), ("kv_heads", "head_dim"), "zeros")
    return attn


def _norm(d: int) -> Spec:
    return _w((d,), ("embed",), "ones")


def _block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """One layer (the reference's ``transformer._block_spec``): the
    SSM family's norm and Mamba2 block; the others' norm, attention (MLA
    or GQA), the hybrid family's Mamba2 sub-layer beside it at half the
    SSM family's inner width (``transformer.d_inner``), then the FFN's
    norm and the FFN (MoE or SwiGLU MLP)."""
    d = cfg.d_model
    spec: Dict[str, Any] = {"norm1": _norm(d)}
    if cfg.family == "ssm":
        spec["mamba"] = _mamba_spec(cfg, d_inner(cfg))
        return spec
    if cfg.uses_mla:
        spec["mla"] = _mla_spec(cfg)
    else:
        spec["attn"] = _attn_spec(cfg)
    if cfg.family == "hybrid":
        spec["mamba"] = _mamba_spec(cfg, d_inner(cfg))
    spec["norm2"] = _norm(d)
    if cfg.moe is not None:
        spec["moe"] = _moe_spec(cfg)
    else:
        spec["mlp"] = _mlp_spec(d, cfg.d_ff)
    return spec


def _mha_spec(cfg: ModelConfig) -> Dict[str, Spec]:
    """One whisper attention sub-layer (the reference's
    ``encdec._mha_spec``): Q, K, V and output projections, biases on Q,
    V and the output (zeros), none on K."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {"wq": _w((d, h, hd), ("embed", "q_heads", "head_dim")),
            "bq": _w((h, hd), ("q_heads", "head_dim"), "zeros"),
            "wk": _w((d, h, hd), ("embed", "kv_heads", "head_dim")),
            "wv": _w((d, h, hd), ("embed", "kv_heads", "head_dim")),
            "bv": _w((h, hd), ("kv_heads", "head_dim"), "zeros"),
            "wo": _w((h, hd, d), ("q_heads", "head_dim", "embed")),
            "bo": _w((d,), ("embed",), "zeros")}


def _ln_spec(d: int) -> Dict[str, Spec]:
    return {"w": _norm(d), "b": _w((d,), ("embed",), "zeros")}


def _encdec_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The encoder-decoder family's parameters (the reference's
    ``encdec.model_spec``): the embedding (also the LM head), the
    encoder blocks (``ln1``, ``attn``, ``ln2``, the GELU ``mlp``) and
    their final LayerNorm, the decoder blocks (``ln1``, ``self``,
    ``ln_x``, ``cross``, ``ln2``, ``mlp``) and theirs."""
    d = cfg.d_model
    mlp = {"up": _w((d, cfg.d_ff), ("embed", "mlp")),
           "up_b": _w((cfg.d_ff,), ("mlp",), "zeros"),
           "down": _w((cfg.d_ff, d), ("mlp", "embed")),
           "down_b": _w((d,), ("embed",), "zeros")}
    enc = {"ln1": _ln_spec(d), "attn": _mha_spec(cfg), "ln2": _ln_spec(d),
           "mlp": mlp}
    dec = {"ln1": _ln_spec(d), "self": _mha_spec(cfg), "ln_x": _ln_spec(d),
           "cross": _mha_spec(cfg), "ln2": _ln_spec(d), "mlp": mlp}
    return {"embed": _w((cfg.padded_vocab, d), ("vocab", "embed")),
            "enc_blocks": _stack(enc, cfg.encoder_layers),
            "enc_ln": _ln_spec(d),
            "dec_blocks": _stack(dec, cfg.num_layers),
            "dec_ln": _ln_spec(d)}


def _stack(spec, n: int):
    """Every leaf of ``spec`` with a leading layers axis of ``n``."""
    if isinstance(spec, dict):
        return {k: _stack(v, n) for k, v in spec.items()}
    return spec._replace(shape=(n,) + spec.shape,
                         axes=("layers",) + spec.axes)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Shapes, initialisers and logical axes of a config's parameters:
    for the encoder-decoder family :func:`_encdec_specs`; for the
    decoder-only families the reference package's
    ``transformer.model_spec``: the embedding, one block spec stacked
    over the layers, the final norm, the LM head unless it is tied, the
    vlm family's patch ``projector [d, d]`` and, with ``cfg.mtp_depth``,
    deepseek-v3's multi-token-prediction module ``"mtp"`` (``proj [2d,
    d]``, one unstacked block, ``norm_h`` and ``norm_e``), which only
    training reads."""
    if cfg.family == "audio":
        return _encdec_specs(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    spec: Dict[str, Any] = {
        "embed": _w((v, d), ("vocab", "embed")),
        "blocks": _stack(_block_spec(cfg), cfg.num_layers),
        "final_norm": _norm(d)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = _w((d, v), ("embed", "vocab"))
    if cfg.family == "vlm":
        spec["projector"] = _w((d, d), ("embed", "embed_out"))
    if cfg.mtp_depth:
        spec["mtp"] = {"proj": _w((2 * d, d), ("embed", "embed_out")),
                       "block": _block_spec(cfg),
                       "norm_h": _norm(d),
                       "norm_e": _norm(d)}
    return spec


# a normal leaf of more than DRAW_WHOLE elements is drawn DRAW_SLICE
# elements (1 GiB of f32) at a time: the whole-leaf f32 draw of
# deepseek-v3's expert weights would take 28 GiB beside their cast copy.
# No leaf of chatglm-6b, mamba2-780m, olmoe-1b-7b (whose experts are
# exactly 2 ** 31) or hymba-1.5b is larger, so their weights do not
# depend on the slicing
DRAW_WHOLE = 1 << 31
DRAW_SLICE = 1 << 28


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device, dtype=torch.float32) -> Dict[str, Any]:
    """Random weights with the reference's distribution: normal with std
    ``scale / sqrt(shape[0])`` (the leading axis, as the reference's
    ``materialize`` takes it), ones and zeros where the spec says so.
    Draws in f32 from ``generator``, which must live on ``device``, then
    casts to ``dtype`` (the ``KEEP_F32`` leaves stay f32); a leaf of
    more than ``DRAW_WHOLE`` elements is drawn and cast ``DRAW_SLICE``
    elements at a time, so its f32 copy never exists whole."""
    def make(spec, dt):
        if isinstance(spec, dict):
            return {k: make(s, torch.float32 if k in KEEP_F32 else dt)
                    for k, s in spec.items()}
        shape, init, scale, _ = spec
        if init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        if init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
        std = scale / math.sqrt(fan_in)
        if math.prod(shape) <= DRAW_WHOLE:
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
            return w.mul_(std).to(dt)
        out = torch.empty(shape, dtype=dt, device=device)
        flat = out.view(-1)
        for i in range(0, flat.numel(), DRAW_SLICE):
            w = torch.randn(min(DRAW_SLICE, flat.numel() - i),
                            generator=generator, dtype=torch.float32,
                            device=device)
            flat[i:i + w.numel()] = w.mul_(std)
        return out

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
