"""The decoder-only model's serving entry points (the reference
package's ``models/transformer.py``), in two halves:

- dense cache (the padded-batch engines, paper §II-D): ``prefill`` over
  right-padded prompts builds the decode cache and ``decode_step`` runs
  one token against it.  For the dense family the cache is a
  ``[L, B, S, Hkv, D]`` K and V cache (padded, or ring-packed for
  sliding-window models), or with ``cfg.cache_int8`` int8 K and V with
  bf16 scales per (token, head); for the SSM family (mamba2) it is the
  per-layer recurrent state, ``[L, B, H, P, N]`` and ``[L, B, C, K-1]``
  in f32;
- paged (DESIGN.md §8-§12): KV lives in one K and one V pool per layer,
  ``[L, num_blocks, bt, Hkv, D]``, shared by every request and addressed
  through per-request block tables.

Attention and the SSD scan go through the kernels' ops: the hand-written
CUDA kernels on the card, their plain versions on the CPU.  The dense and
SSM families are ported; the others raise ``NotImplementedError`` with
the reason.

Where the reference is functional (``.at[].set`` on donated buffers),
this port writes into the caches, the pools and the engine's state
tensors in place and returns them; a caller that needs the old cache
clones it first.  Layers are a Python loop over the stacked ``blocks``
weights, the reference's ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_int8, paged_decode_attention,
    paged_prefix_prefill_attention)
from repro_torch.models.attention import (gqa_decode_attention,
                                         gqa_prefill_attention)
from repro_torch.models.layers import apply_rope, rms_norm, swiglu
from repro_torch.models.ssm import (mamba_decode, mamba_forward,
                                    mamba_state_spec)

# SSM decay parameters stay f32 whatever the compute dtype, as in the
# reference (its ``_KEEP_F32``)
KEEP_F32 = frozenset({"A_log", "D", "dt_bias"})


# ---------------------------------------------------------------------------
# Helpers shared by the entry points
# ---------------------------------------------------------------------------

def cast_params(tree, dtype: torch.dtype):
    """Cast floating weights to the compute dtype, except the SSM decay
    parameters (``KEEP_F32``).  A tensor already of that dtype is
    returned as it is, so weights stored in the compute dtype (the engine
    casts once, at construction) cost nothing here."""
    if isinstance(tree, dict):
        return {k: v if k in KEEP_F32 else cast_params(v, dtype)
                for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _layer(blocks: Dict, i: int) -> Dict:
    """Layer ``i``'s weights: views into the stacked ``blocks`` tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    b, s, h, k = o.shape
    return o.reshape(b, s, h * k) @ wo.reshape(h * k, -1)


def _qkv(ap: Dict, x: torch.Tensor, cfg: ModelConfig):
    q, k, v = _proj(x, ap["wq"]), _proj(x, ap["wk"]), _proj(x, ap["wv"])
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    return q, k, v


def _ffn(bp: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.moe is not None:
        raise NotImplementedError("the MoE FFN is not ported yet")
    h = rms_norm(x, bp["norm2"], cfg.norm_eps)
    return x + swiglu(h, bp["mlp"]["gate"], bp["mlp"]["up"],
                      bp["mlp"]["down"])


def _embed_in(params: Dict, tokens: torch.Tensor,
              act_dtype: torch.dtype) -> torch.Tensor:
    return params["embed"][tokens.long()].to(act_dtype)


def _logits(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense cache
# ---------------------------------------------------------------------------

def supports_dense(cfg: ModelConfig) -> Tuple[bool, str]:
    """The dense-cache half covers the plain-GQA dense family and the
    attention-free SSM family; the others need parts of the model the
    port does not have yet."""
    if cfg.family == "moe":
        return False, "family moe: the MoE FFN is not ported yet"
    if cfg.family not in ("dense", "ssm"):
        return False, (f"family {cfg.family}: its layers (hybrid "
                       f"attention and SSM heads, vision or audio front "
                       f"ends) are not ported yet")
    if cfg.uses_mla:
        return False, "MLA latent caches are not ported yet"
    return True, ""


def _require_dense(cfg: ModelConfig) -> None:
    ok, why = supports_dense(cfg)
    if not ok:
        raise NotImplementedError(f"{cfg.name}: {why}")


def _attention(ap: Dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, *, window: Optional[int]):
    """Full-sequence GQA attention; returns (out, (k, v))."""
    q, k, v = _qkv(ap, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = gqa_prefill_attention(q, k, v, causal=True, window=window)
    return _out_proj(out.to(x.dtype), ap["wo"]), (k, v)


def _quant_i8(t: torch.Tensor):
    """Symmetric int8 quantisation over the head_dim axis: t [B, 1, H, D]
    -> (int8 values, bf16 scales [B, 1, H]).  Divides by the f32 scale,
    then casts the scale to bf16, as the reference does; ``torch.round``
    rounds half to even, like ``jnp.round``."""
    tf = t.float()
    sc = torch.clamp(tf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.round(tf / sc[..., None])
    return q.to(torch.int8), sc.to(torch.bfloat16)


def _attention_decode(ap: Dict, x: torch.Tensor, cfg: ModelConfig,
                      kv: Tuple[torch.Tensor, ...],
                      positions: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention against one layer's cache: ``kv`` is (k,
    v), each [B, S, Hkv, D], or with ``cfg.cache_int8`` (k int8, v int8,
    k scales, v scales [B, S, Hkv] bf16).  The new K/V (quantised, for
    int8) is written in place at slot ``positions % S`` (a ring when the
    cache is shorter than the sequence), then attention reads the first
    ``min(positions + 1, S)`` slots.  The int8 kernel dequantises in f32;
    the reference model dequantises into a bf16 copy of the cache and
    runs the float attention on it (ROADMAP §3)."""
    if cfg.decode_cp:
        raise NotImplementedError(
            f"{cfg.name}: context-parallel decode (gqa_decode_attention_cp)"
            f" needs a device mesh and is not ported yet")
    s_cache = kv[0].shape[1]
    q, k, v = _qkv(ap, x, cfg)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)
    rows = torch.arange(x.shape[0], device=x.device)
    slot = (positions % s_cache).long()
    valid = torch.clamp(positions + 1, max=s_cache)
    if cfg.cache_int8:
        k_cache, v_cache, k_sc, v_sc = kv
        for cache, scales, new in ((k_cache, k_sc, k), (v_cache, v_sc, v)):
            values, scale = _quant_i8(new)
            cache[rows, slot] = values[:, 0]
            scales[rows, slot] = scale[:, 0]
        out = decode_attention_int8(q[:, 0], k_cache, v_cache, k_sc, v_sc,
                                    valid)[:, None]
    else:
        k_cache, v_cache = kv
        k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
        out = gqa_decode_attention(q, k_cache, v_cache, valid)
    return _out_proj(out.to(x.dtype), ap["wo"])


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.d_inner(cfg.d_model)


def block_forward(bp: Dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, *, window: Optional[int] = None):
    """Full-sequence block.  Returns (x, the layer's cache entry): (k, v)
    for the dense family, (SSD state, conv state) for the SSM family."""
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    if cfg.family == "ssm":
        y, state = mamba_forward(bp["mamba"], h, cfg.ssm, _d_inner(cfg),
                                 return_state=True)
        return x + y, state
    y, kv = _attention(bp["attn"], h, cfg, positions, window=window)
    return _ffn(bp, x + y, cfg), kv


def block_decode(bp: Dict, x: torch.Tensor, cfg: ModelConfig,
                 layer_cache: Tuple[torch.Tensor, ...],
                 positions: torch.Tensor) -> torch.Tensor:
    """One-token block; writes this layer's cache entry (the leaves of
    ``cache["kv"]`` or ``cache["ssm"]`` at this layer) in place."""
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    if cfg.family == "ssm":
        y, new = mamba_decode(bp["mamba"], h, cfg.ssm, _d_inner(cfg),
                              layer_cache)
        for leaf, value in zip(layer_cache, new):
            leaf.copy_(value)
        return x + y
    y = _attention_decode(bp["attn"], h, cfg, layer_cache, positions)
    return _ffn(bp, x + y, cfg)


def _fit_cache(leaf: torch.Tensor, s: int, cache_len: int) -> torch.Tensor:
    """Grow (zero-pad) or ring-pack (the last ``cache_len`` positions,
    rolled so position p lives at slot p % cache_len) one layer's cache
    [B, S, ...].  The reference fits the stacked [L, B, S, ...] leaves
    at once; per layer, the padded copy of all L layers never exists."""
    if cache_len == s:
        return leaf
    if cache_len > s:
        out = leaf.new_zeros((leaf.shape[0], cache_len, *leaf.shape[2:]))
        out[:, :s] = leaf
        return out
    return torch.roll(leaf[:, s - cache_len:], s % cache_len, dims=1)


def prefill(params: Dict, cfg: ModelConfig, tokens, lengths, *,
            act_dtype: torch.dtype = torch.bfloat16,
            cache_len: Optional[int] = None):
    """Build the decode cache.  tokens: [B, S] right-padded to S (the
    prompts attend causally over their pads, and an SSM row's state
    takes in its pads, as in the reference); lengths: [B] valid counts.
    ``cache_len`` sets the KV cache capacity (>= S pads, < S ring-packs,
    for sliding-window models).  Returns (next-token logits [B, V],
    cache): {"kv": (k, v)}, each [L, B, cache_len, Hkv, D] in
    ``act_dtype`` (a float cache with ``cfg.cache_int8`` too, as in the
    reference), or for the SSM family {"ssm": (state [L, B, H, P, N],
    conv [L, B, C, K-1])} in f32, whatever ``act_dtype``.

    The logits are computed for each row's last valid position only
    (the reference computes all S rows and picks one; the rows are
    independent, so only the size of the product differs: at full width
    the S-row product would be B * S * padded_vocab values)."""
    _require_dense(cfg)
    params = cast_params(params, act_dtype)
    x = _embed_in(params, tokens, act_dtype)
    b, s = tokens.shape
    cl = s if cache_len is None else cache_len
    positions = torch.arange(s, device=x.device)
    if cfg.family == "ssm":
        cache = init_cache(cfg, b, cl, device=x.device)
        for i in range(cfg.num_layers):
            x, new = block_forward(_layer(params["blocks"], i), x, cfg,
                                   positions)
            for leaf, value in zip(cache["ssm"], new):
                leaf[i] = value
    else:
        shape = (cfg.num_layers, b, cl, cfg.num_kv_heads, cfg.head_dim)
        ck = torch.zeros(shape, dtype=act_dtype, device=x.device)
        cv = torch.zeros(shape, dtype=act_dtype, device=x.device)
        for i in range(cfg.num_layers):
            bp = _layer(params["blocks"], i)
            x, (k, v) = block_forward(bp, x, cfg, positions,
                                      window=cfg.sliding_window)
            for leaf, new in ((ck, k), (cv, v)):
                if cl >= s:          # pad: the zero tail is already there
                    leaf[i, :, :s] = new
                else:
                    leaf[i] = _fit_cache(new, s, cl)
        cache = {"kv": (ck, cv)}
    rows = torch.arange(b, device=x.device)
    last = x[rows, lengths.long() - 1]
    logits = _logits(params, cfg, last[:, None])[:, 0]
    return logits, cache


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict, tokens,
                positions, *, act_dtype: torch.dtype = torch.bfloat16):
    """tokens: [B] new ids; positions: [B] tokens already cached (the new
    token's absolute position; an SSM step does not read it).  Returns
    (logits [B, V], cache updated in place)."""
    _require_dense(cfg)
    params = cast_params(params, act_dtype)
    x = _embed_in(params, tokens[:, None], act_dtype)
    leaves = cache["ssm" if cfg.family == "ssm" else "kv"]
    for i in range(cfg.num_layers):
        x = block_decode(_layer(params["blocks"], i), x, cfg,
                         tuple(leaf[i] for leaf in leaves), positions)
    return _logits(params, cfg, x)[:, 0], cache


def cache_struct(cfg: ModelConfig, batch: int, seq: int,
                 dtype: torch.dtype = torch.bfloat16):
    """Returns ({key: ((shape, dtype), ...)}, logical axes) of the decode
    cache: {"kv": (k, v)} in ``dtype``, {"kv": (k int8, v int8, k scales
    bf16, v scales bf16)} with ``cfg.cache_int8``, or {"ssm": (state,
    conv)} in f32 for the SSM family.  ``seq`` is the KV capacity (the
    window for sliding-window models); the SSM state does not depend on
    it."""
    _require_dense(cfg)
    n_layers = cfg.num_layers
    if cfg.family == "ssm":
        shapes, axes = mamba_state_spec(cfg, batch, _d_inner(cfg))
        return ({"ssm": tuple(((n_layers,) + sh, torch.float32)
                              for sh in shapes)},
                {"ssm": tuple(("layers",) + a for a in axes)})
    shape = (n_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim)
    ax = ("layers", "cache_batch", "kv_seq", "cache_heads", None)
    if cfg.cache_int8:
        sc = shape[:-1]
        return ({"kv": ((shape, torch.int8), (shape, torch.int8),
                        (sc, torch.bfloat16), (sc, torch.bfloat16))},
                {"kv": (ax, ax, ax[:-1], ax[:-1])})
    return {"kv": ((shape, dtype), (shape, dtype))}, {"kv": (ax, ax)}


def init_cache(cfg: ModelConfig, batch: int, seq: int, *,
               dtype: torch.dtype = torch.bfloat16, device) -> Dict:
    """A zero decode cache (the layout of :func:`cache_struct`) on
    ``device``."""
    shapes, _ = cache_struct(cfg, batch, seq, dtype)
    return {key: tuple(torch.zeros(shape, dtype=dt, device=device)
                       for shape, dt in leaves)
            for key, leaves in shapes.items()}


# ---------------------------------------------------------------------------
# Paged cache
# ---------------------------------------------------------------------------

def supports_paged(cfg: ModelConfig) -> Tuple[bool, str]:
    """Paged decode covers the plain-GQA KV families; the exotic cache
    layouts (MLA latents, SSM states, int8 pairs, SWA rings) keep the
    dense path."""
    if cfg.family not in ("dense", "moe"):
        return False, f"family {cfg.family} has no paged cache layout"
    if cfg.uses_mla:
        return False, "MLA latent caches are not paged"
    if cfg.cache_int8:
        return False, "int8 (value, scale) caches are not paged"
    if cfg.sliding_window is not None:
        return False, "sliding-window ring caches are not paged"
    hq = max(cfg.num_heads, cfg.pad_heads_to)
    if hq % cfg.num_kv_heads:
        return False, "padded q-heads not a multiple of kv-heads"
    return True, ""


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_tokens: int,
                     *, dtype: torch.dtype = torch.bfloat16,
                     device) -> Dict[str, torch.Tensor]:
    """One K and one V pool per layer: [L, num_blocks, block_tokens,
    Hkv, D].  Every request addresses the same physical block id across
    all layers (one table, L pools)."""
    ok, why = supports_paged(cfg)
    if not ok:
        raise NotImplementedError(why)
    shape = (cfg.num_layers, num_blocks, block_tokens, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attention_decode_paged(ap: Dict, x: torch.Tensor, cfg: ModelConfig,
                            k_pages: torch.Tensor, v_pages: torch.Tensor,
                            block_tables: torch.Tensor,
                            positions: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention against the shared pool.  The new K/V is
    written to (table[pos // bt], pos % bt) first, then attention reads
    the pool up to ``positions + 1``: the in-place write and the kernel
    run in that order on one stream."""
    bt = k_pages.shape[1]
    q, k, v = _qkv(ap, x, cfg)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)
    pos = positions.long()
    phys = torch.gather(block_tables.long(), 1, (pos // bt)[:, None])[:, 0]
    slot = pos % bt
    k_pages[phys, slot] = k[:, 0].to(k_pages.dtype)
    v_pages[phys, slot] = v[:, 0].to(v_pages.dtype)
    out = paged_decode_attention(q[:, 0], k_pages, v_pages, block_tables,
                                 positions + 1)
    return _out_proj(out[:, None].to(x.dtype), ap["wo"])


def _attention_prefill_suffix(ap: Dict, x: torch.Tensor, cfg: ModelConfig,
                              k_pages: torch.Tensor, v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              prefix_lens: torch.Tensor,
                              suffix_lens: torch.Tensor):
    """Suffix-token GQA attention against cached prefix pages plus the
    new suffix K/V (DESIGN.md §10).  Queries sit at absolute positions
    ``prefix_lens[b] + i``.  Returns (out, (k_suf, v_suf)): the suffix
    K/V is the request's private cache slice, written by the caller."""
    s = x.shape[1]
    q, k, v = _qkv(ap, x, cfg)
    positions = (prefix_lens[:, None].long()
                 + torch.arange(s, device=x.device)[None, :])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = paged_prefix_prefill_attention(q, k, v, k_pages, v_pages,
                                         block_tables, prefix_lens,
                                         suffix_lens)
    return _out_proj(out.to(x.dtype), ap["wo"]), (k, v)


def prefill_suffix(params: Dict, cfg: ModelConfig, pages: Dict, tokens,
                   lengths, prefix_lens, block_tables, *,
                   act_dtype: torch.dtype = torch.bfloat16):
    """Suffix-only prefill against cached prefix pages.

    tokens: [B, S] suffix ids (the prompt past its cached prefix,
    right-padded); lengths: [B] valid suffix counts; prefix_lens: [B]
    cached prefix tokens (any offset; a partial final block is masked
    past ``prefix_lens``); block_tables: [B, M], shared prefix pages
    first.  Returns (next-token logits [B, V], suffix KV (k, v) each
    [L, B, S, Hkv, D]).

    The logits are computed for each row's last valid position only
    (the reference computes all S and then picks one; the rows are
    independent, so only the size of the product differs)."""
    params = cast_params(params, act_dtype)
    x = _embed_in(params, tokens, act_dtype)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for i in range(cfg.num_layers):
        bp = _layer(params["blocks"], i)
        h = rms_norm(x, bp["norm1"], cfg.norm_eps)
        y, (k, v) = _attention_prefill_suffix(
            bp["attn"], h, cfg, pages["k"][i], pages["v"][i], block_tables,
            prefix_lens, lengths)
        x = _ffn(bp, x + y, cfg)
        ks.append(k)
        vs.append(v)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, lengths.long() - 1]
    logits = _logits(params, cfg, last[:, None])[:, 0]
    return logits, (torch.stack(ks), torch.stack(vs))


def prefill_wave(params: Dict, cfg: ModelConfig, pages: Dict, state: Dict,
                 *, tokens, lengths, prefix_lens, attn_tables, tables,
                 write_lens, cow_src, cow_dst, slots, row_sel, positions,
                 null_block: int, act_dtype: torch.dtype = torch.bfloat16):
    """Single-dispatch variable-prefix admission wave (DESIGN.md §12):

    1. copy-on-write clones ``pages[:, cow_dst] = pages[:, cow_src]``
       (``(null, null)`` pads are the null block rewriting itself);
    2. :func:`prefill_suffix` over the wave's suffix tokens with per-row
       ``prefix_lens`` (a miss is 0); ``attn_tables`` is width-1 all-null
       for a pure-miss wave;
    3. the token-granular suffix-KV write
       (:func:`write_suffix_pages_batched`); rows with ``write_lens == 0``
       (batch pads) write nothing into live pages, only into
       ``null_block``;
    4. the slot-state update, one indexed write per engine tensor
       (``state``: tables, positions, active, logits).  Pad rows repeat
       row 0's slot and values, so duplicate writes carry equal values.

    Pools and state are updated in place; returns ``(pages, state)``."""
    copy_pages(pages, cow_src, cow_dst)
    logits, kv = prefill_suffix(params, cfg, pages, tokens, lengths,
                                prefix_lens, attn_tables,
                                act_dtype=act_dtype)
    write_suffix_pages_batched(pages, kv, tables, prefix_lens, write_lens,
                               null_block=null_block)
    sl = slots.long()
    state["tables"][sl] = tables.to(state["tables"].dtype)
    state["positions"][sl] = positions.to(state["positions"].dtype)
    state["active"][sl] = True
    state["logits"][sl] = logits[row_sel.long()].to(state["logits"].dtype)
    return pages, state


def decode_step_paged(params: Dict, cfg: ModelConfig, pages: Dict, tokens,
                      positions, block_tables, *,
                      act_dtype: torch.dtype = torch.bfloat16):
    """tokens: [B] new ids; positions: [B] tokens already cached;
    block_tables: [B, max_blocks] physical page ids (pad entries must be
    valid ids).  Returns (logits [B, V], pages updated in place)."""
    params = cast_params(params, act_dtype)
    x = _embed_in(params, tokens[:, None], act_dtype)
    for i in range(cfg.num_layers):
        bp = _layer(params["blocks"], i)
        h = rms_norm(x, bp["norm1"], cfg.norm_eps)
        y = _attention_decode_paged(bp["attn"], h, cfg, pages["k"][i],
                                    pages["v"][i], block_tables, positions)
        x = _ffn(bp, x + y, cfg)
    return _logits(params, cfg, x)[:, 0], pages


def decode_multi_paged(params: Dict, cfg: ModelConfig, pages: Dict, logits,
                       positions, block_tables, active, *, num_steps: int,
                       act_dtype: torch.dtype = torch.bfloat16):
    """Fused ``num_steps``-step paged greedy decode (DESIGN.md §9): each
    step argmaxes the carried logits on the device, runs
    :func:`decode_step_paged` and advances ``positions`` where ``active``
    (idle slots decode into the null block at a frozen position).
    Nothing is read back inside the loop; the emitted tokens stack into
    one ``[B, num_steps]`` tensor, the window's only readback.

    Caller-guaranteed invariant: every active slot has >= ``num_steps``
    tokens left and >= ``num_steps`` free positions in its table.
    Returns ``(logits, pages, positions, tokens [B, num_steps])``, equal
    to ``num_steps`` sequential :func:`decode_step_paged` calls."""
    inc = active.to(positions.dtype)
    toks = []
    for _ in range(num_steps):
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)
        logits, pages = decode_step_paged(params, cfg, pages, tok, positions,
                                          block_tables, act_dtype=act_dtype)
        positions = positions + inc
        toks.append(tok)
    return logits, pages, positions, torch.stack(toks, dim=1)


def write_suffix_pages_batched(pages: Dict, kv, block_tables, starts,
                               lengths, *, null_block: int) -> Dict:
    """Write batched suffix KV (k, v each [L, B, S, Hkv, D]) into the
    pool at arbitrary token offsets, one indexed write per pool.

    Row ``b``'s position ``j`` lands at page ``block_tables[b, (starts[b]
    + j) // bt]``, slot ``(starts[b] + j) % bt``; slots before
    ``starts[b]`` (a copy-on-write clone's copied prefix) are never
    touched.  Positions at or past ``lengths[b]`` (bucket pad, pad rows)
    must not reach a live page.  The reference drops them with an
    out-of-range index (``mode="drop"``); PyTorch has no drop mode and
    selecting the valid ones would read a count back to the host, so
    they are redirected into ``null_block``, the pool's write sink, whose
    contents no valid position ever reads (idle decode slots write there
    too)."""
    bt = pages["k"].shape[2]
    k, v = kv
    n_layers, b, s, h, dh = k.shape
    j = torch.arange(s, device=k.device)[None, :]
    abspos = starts[:, None].long() + j                            # [B, S]
    blk = (abspos // bt).clamp(0, block_tables.shape[1] - 1)
    phys = torch.gather(block_tables.long(), 1, blk)
    phys = torch.where(j < lengths[:, None], phys,
                       torch.full_like(phys, null_block))
    fp, fs = phys.reshape(-1), (abspos % bt).reshape(-1)
    for key, c in (("k", k), ("v", v)):
        pool = pages[key]
        pool[:, fp, fs] = c.reshape(n_layers, b * s, h, dh).to(pool.dtype)
    return pages


def copy_pages(pages: Dict, src, dst) -> Dict:
    """Copy-on-write block clone, in place: ``pages[:, dst[i]] =
    pages[:, src[i]]``.  Callers pad with (null, null) pairs, so a
    duplicate destination is only ever the null block rewriting
    itself."""
    src, dst = src.long(), dst.long()
    for key in ("k", "v"):
        pool = pages[key]
        pool[:, dst] = pool[:, src]
    return pages


def gather_pages(pages: Dict, blocks) -> torch.Tensor:
    """Stack the pools' pages at ``blocks`` for a host swap-out
    (DESIGN.md §15): one ``[P, L, N, bt, Hkv, D]`` tensor with the pool
    axis in sorted key order ("k", "v"), so a single device-to-host copy
    of the result is the whole swap transfer.  ``blocks`` is int
    ``[N]``."""
    blocks = blocks.long()
    return torch.stack([pages[key].index_select(1, blocks)
                        for key in sorted(pages)])


def scatter_pages(pages: Dict, blocks, values) -> Dict:
    """Write swapped-in host pages back into the pools, in place — the
    inverse of :func:`gather_pages`, one indexed copy per pool, so the
    pools keep their addresses (a captured decode graph reads them).
    ``values`` is ``[P, L, N, bt, Hkv, D]`` aligned with ``blocks``, on
    the pools' device; an entry that targets the null block writes junk
    where junk is by design."""
    blocks = blocks.long()
    for i, key in enumerate(sorted(pages)):
        pool = pages[key]
        pool.index_copy_(1, blocks, values[i].to(pool.dtype))
    return pages
