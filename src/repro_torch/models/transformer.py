"""The decoder-only model's serving entry points (the reference
package's ``models/transformer.py``), in two halves:

- dense cache (the padded-batch engines, paper §II-D): ``prefill`` over
  right-padded prompts builds the decode cache and ``decode_step`` runs
  one token against it.  For the dense family the cache is a
  ``[L, B, S, Hkv, D]`` K and V cache (padded, or ring-packed for
  sliding-window models), or with ``cfg.cache_int8`` int8 K and V with
  bf16 scales per (token, head); for the SSM family (mamba2) it is the
  per-layer recurrent state, ``[L, B, H, P, N]`` and ``[L, B, C, K-1]``
  in f32; the hybrid family (hymba: attention and SSM heads side by
  side in every layer) keeps both; the MLA family (deepseek-v3:
  ``models/mla.py``) keeps each token's compressed latent and shared
  rotary key, ``[L, B, S, R]`` and ``[L, B, S, Dr]``; the vlm family
  (internvl2) is the dense model with a patch prefix (``patches @
  projector``) in front of the prompt in its cache;
- paged (DESIGN.md §8-§12): KV lives in one K and one V pool per layer,
  ``[L, num_blocks, bt, Hkv, D]``, shared by every request and addressed
  through per-request block tables; speculative decoding (§16) drafts
  with ``draft_window`` (fused paged decode of a draft model) and checks
  the draft with ``verify_window`` (one prefix-prefill pass of the
  target over the whole window).

Inside :func:`batch_invariant` the paged half's arithmetic of a token
does not depend on the batch, wave or window that computes it (at the
cost of speed), so that greedy streams can be compared bit for bit
across serves that batch the same requests differently.

Attention and the SSD scan go through the kernels' ops: the hand-written
CUDA kernels on the card, their plain versions on the CPU.  MLA runs in
plain PyTorch, as the reference runs it in plain ``jnp``.  The dense,
MoE (``models/moe.py``: the FFN of every row and position of the
``[B, S]`` batch, pads and idle slots included, as the reference groups
them), MLA, SSM, hybrid and vlm families are ported here; the
encoder-decoder family (whisper) has its own entry points in
``models/encdec.py``, to which ``models/model.py`` dispatches.

Training: :func:`forward_train` (full-sequence logits, the MoE aux loss
and the last hidden state), :func:`cross_entropy` and :func:`lm_loss`
(next-token CE, plus the aux loss and deepseek-v3's multi-token
prediction over ``params["mtp"]``, which only training reads).  Each
block is recomputed in the backward pass (``torch.utils.checkpoint``,
the reference's ``nothing_saveable`` remat) unless ``cfg.remat_mode`` is
``"none"``; it changes memory, not values.  On the card the attention's
gradient is the flash kernel's backward kernel and the SSD scan's is the
scan's backward kernel (``kernels/ssd_scan/ops.py`` ``SsdScanFn``), so
every family trains there.

Where the reference is functional (``.at[].set`` on donated buffers),
this port writes into the caches, the pools and the engine's state
tensors in place and returns them; a caller that needs the old cache
clones it first.  Layers are a Python loop over the stacked ``blocks``
weights, the reference's ``lax.scan``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_int8, paged_decode_attention,
    paged_prefix_prefill_attention)
from repro_torch.models.attention import (batch_block, batch_spec,
                                         gqa_decode_attention,
                                         gqa_decode_attention_cp,
                                         gqa_prefill_attention)
from repro_torch.models.layers import apply_rope, rms_norm, swiglu, upcast
from repro_torch.models.mla import mla_decode, mla_prefill
from repro_torch.models.moe import moe_forward, moe_forward_ragged
from repro_torch.models.ssm import (mamba_decode, mamba_forward,
                                    mamba_state_spec)
from repro_torch.partitioning import mesh_shape, shard_local

# SSM decay parameters and the MoE router stay f32 whatever the compute
# dtype, as in the reference (its ``_KEEP_F32``)
KEEP_F32 = frozenset({"A_log", "D", "dt_bias", "router"})


# ---------------------------------------------------------------------------
# Helpers shared by the entry points
# ---------------------------------------------------------------------------

def cast_params(tree, dtype: torch.dtype):
    """Cast floating weights to the compute dtype, except the SSM decay
    parameters and the MoE router (``KEEP_F32``).  A tensor already of
    that dtype is returned as it is, so weights stored in the compute
    dtype (the engine casts once, at construction) cost nothing here."""
    if isinstance(tree, dict):
        return {k: v if k in KEEP_F32 else cast_params(v, dtype)
                for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _layer(blocks: Dict, i: int) -> Dict:
    """Layer ``i``'s weights: views into the stacked ``blocks`` tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Batch-invariant arithmetic
# ---------------------------------------------------------------------------

INVARIANT_ROWS = 32     # rows of every product, norm and MLP in the mode
_INVARIANT = [False]


@contextlib.contextmanager
def batch_invariant() -> Iterator[None]:
    """Inside the block, the paged path computes each token with the
    same arithmetic whatever batch, admission wave or speculative window
    it is in, so equal inputs give equal bits:

    - every matrix product, RMS norm and MLP runs on chunks of exactly
      ``INVARIANT_ROWS`` rows, the last one zero-padded.  cuBLAS picks
      its algorithm by shape, and rows of an f32 product with 32 rows and
      of one with 160 differ in their last bits (on an H100;
      ``scripts/f32_invariance.py``), while a 32-row product gives a row
      the same bits whatever the other rows hold;
    - the attention of an admission wave or a verify window runs through
      the paged decode kernel, one split: each query row at its own
      length, after the rows' K/V is written into the pool.  A token's
      attention then has the decode step's arithmetic, and the same
      arithmetic whatever cached prefix its wave started from.

    So a speculative serve's greedy streams equal the plain serve's bit
    for bit, which the default arithmetic does not give on the card even
    in f32 (``chip_smoke.py`` phase 16 (c)).  It is slower: each chunk
    reads the weights again, and a wave's attention reads each row's
    history once per query.  A CUDA graph keeps the arithmetic it was
    captured with, so an engine is built and warmed inside the block.

    A MoE config raises inside the block: its capacity dispatch couples
    the tokens of a group (``models/moe.py``), so no chunking of rows
    can make a token's FFN independent of its batch-mates."""
    prev = _INVARIANT[0]
    _INVARIANT[0] = True
    try:
        yield
    finally:
        _INVARIANT[0] = prev


def _by_rows(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over the rows of ``x`` [..., K]: one call, or inside
    :func:`batch_invariant` one call per ``INVARIANT_ROWS`` rows."""
    if not _INVARIANT[0]:
        return fn(x)
    lead, c = x.shape[:-1], INVARIANT_ROWS
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    if m % c:
        x2 = torch.cat([x2, x2.new_zeros(c - m % c, x2.shape[1])])
    y = torch.cat([fn(x2[i:i + c]) for i in range(0, x2.shape[0], c)])
    return y[:m].reshape(*lead, y.shape[-1])


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _by_rows(lambda r: r @ w, x)


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return _by_rows(lambda r: rms_norm(r, w, eps), x)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    b, s, d = x.shape
    return _mm(x, w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    b, s, h, k = o.shape
    return _mm(o.reshape(b, s, h * k), wo.reshape(h * k, -1))


def _qkv(ap: Dict, x: torch.Tensor, cfg: ModelConfig):
    q, k, v = _proj(x, ap["wq"]), _proj(x, ap["wk"]), _proj(x, ap["wv"])
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    return q, k, v


def _ffn_aux(bp: Dict, x: torch.Tensor, cfg: ModelConfig):
    """The FFN sub-layer with its residual, and its aux loss (the MoE
    load-balance loss, an f32 scalar; None for an MLP, so that serving
    makes no zero tensor).  A MoE FFN runs on the whole ``[B, S, d]`` at
    once."""
    if cfg.moe is not None:
        if _INVARIANT[0]:
            raise NotImplementedError(
                f"{cfg.name}: batch_invariant() cannot hold for a MoE "
                f"FFN: the capacity dispatch couples the tokens of a group, "
                f"so a token's output depends on its batch-mates")
        h = rms_norm(x, bp["norm2"], cfg.norm_eps)
        if cfg.moe_ragged:
            y, aux = moe_forward_ragged(bp["moe"], h, cfg.moe)
        else:
            y, aux = moe_forward(bp["moe"], h, cfg.moe,
                                 group_size=cfg.moe_group_size)
        return x + y, aux
    h = _norm(x, bp["norm2"], cfg.norm_eps)
    mlp = bp["mlp"]
    y = _by_rows(lambda r: swiglu(r, mlp["gate"], mlp["up"], mlp["down"]), h)
    return x + y, None


def _ffn(bp: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`_ffn_aux` without the aux loss, which serving discards."""
    return _ffn_aux(bp, x, cfg)[0]


def _embed_in(params: Dict, tokens: torch.Tensor, act_dtype: torch.dtype,
              patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings [B, S, d]; with ``patches`` [B, P, d] (the vlm
    family) ``patches @ projector`` in front of them: [B, P + S, d]."""
    x = params["embed"][tokens.long()].to(act_dtype)
    if patches is not None:
        proj = patches.to(act_dtype) @ params["projector"].to(act_dtype)
        x = torch.cat([proj, x], dim=1)
    return x


def _logits(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = _norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _mm(x, head.to(x.dtype))


# ---------------------------------------------------------------------------
# Dense cache
# ---------------------------------------------------------------------------

def _require_dense(cfg: ModelConfig) -> None:
    """This module's dense entry points take the decoder-only families;
    the encoder-decoder family's are ``models/encdec.py``'s."""
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: the encoder-decoder family's entry "
                         f"points are models/encdec.py's (models/model.py "
                         f"dispatches to them)")


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


def context_parallel(cfg: ModelConfig, mesh, s_cache: int) -> bool:
    """Whether a ``cfg`` decode against a cache of ``s_cache`` slots
    (the whole cache's, on every rank) takes the context-parallel
    branch on ``mesh``: the reference's condition, ``decode_cp`` and a
    mesh with a ``model`` axis that divides the cache
    (``src/repro/models/transformer.py:174-183``)."""
    return bool(cfg.decode_cp and mesh is not None
                and "model" in mesh.axis_names
                and s_cache % mesh_shape(mesh)["model"] == 0)


def _attention_decode(ap: Dict, x: torch.Tensor, cfg: ModelConfig,
                      kv: Tuple[torch.Tensor, ...],
                      positions: torch.Tensor, rules=None) -> torch.Tensor:
    """One-token GQA attention against one layer's cache: ``kv`` is (k,
    v), each [B, S, Hkv, D], or with ``cfg.cache_int8`` (k int8, v int8,
    k scales, v scales [B, S, Hkv] bf16).  The new K/V (quantised, for
    int8) is written in place at slot ``positions % S`` (a ring when the
    cache is shorter than the sequence), then attention reads the first
    ``min(positions + 1, S)`` slots.  The int8 kernel dequantises in f32;
    the reference model dequantises into a bf16 copy of the cache and
    runs the float attention on it (ROADMAP §3).

    With a mesh in ``rules`` (``partitioning.with_mesh_rules``), under
    :func:`context_parallel`, ``gqa_decode_attention_cp`` merges the
    ranks' partials of their blocks of the cache: global slots
    ``[r * S/n, (r + 1) * S/n)`` of the ``n`` ranks of the model axis,
    and this rank's rows (``attention.batch_block``).  A cache that
    ``model.shard_cache`` placed is that block (the rules it returns
    record the whole cache's S under ``"_kv_len"``); only the rank whose
    block holds slot ``positions % S`` writes the new K/V (GSPMD's write
    of the reference, by hand).  A whole cache (no record) is written
    on every rank, and each rank copies its block out of it for the
    kernel.  The int8 cache takes the same route, its shard dequantised
    inside the partial kernel.  Otherwise a ``decode_cp`` config
    decodes exactly as with the flag off, as the reference's does."""
    rules = rules or {}
    mesh = rules.get("_mesh")
    local_s = kv[0].shape[1]
    placed = rules.get("_kv_len")
    s_cache = local_s if placed is None else placed
    cp = context_parallel(cfg, mesh, s_cache)
    q, k, v = _qkv(ap, x, cfg)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)
    slot, mine = positions, None
    if cp:
        batch_axes = rules.get("cache_batch", ("data",))
        b0, bl = batch_block(mesh, x.shape[0], batch_axes)
    if placed is not None:
        if not cp or local_s * mesh_shape(mesh)["model"] != placed \
                or kv[0].shape[0] != bl:
            raise ValueError(
                f"a cache block of {tuple(kv[0].shape[:2])} (rows, slots) "
                f"is not this rank's block of a {placed}-slot cache: "
                f"place the cache with model.shard_cache")
        slot = positions[b0:b0 + bl] % s_cache
        mine = (slot // local_s) == mesh.get_local_rank("model")
        k, v = k[b0:b0 + bl], v[b0:b0 + bl]
    slot = (slot % local_s).long()
    rows = torch.arange(slot.shape[0], device=x.device)
    valid = torch.clamp(positions + 1, max=s_cache)

    def write(leaf, new):
        new = new[:, 0].to(leaf.dtype)
        if mine is not None:     # other ranks' slots keep what they hold
            keep = mine.view(-1, *([1] * (new.dim() - 1)))
            new = torch.where(keep, new, leaf[rows, slot])
        leaf[rows, slot] = new

    if cfg.cache_int8:
        for cache, scales, new in ((kv[0], kv[2], k), (kv[1], kv[3], v)):
            values, scale = _quant_i8(new)
            write(cache, values)
            write(scales, scale)
    else:
        write(kv[0], k)
        write(kv[1], v)
    if cp:
        blocks = kv
        if placed is None:
            spec = (batch_spec(mesh, x.shape[0], batch_axes), "model")
            blocks = tuple(shard_local(t, spec, mesh).contiguous()
                           for t in kv)
        scales = ({"k_scale": blocks[2], "v_scale": blocks[3]}
                  if cfg.cache_int8 else {})
        out = gqa_decode_attention_cp(q, blocks[0], blocks[1], valid,
                                      mesh=mesh, batch_axes=batch_axes,
                                      **scales)
    elif cfg.cache_int8:
        out = decode_attention_int8(q[:, 0], *kv, valid)[:, None]
    else:
        out = gqa_decode_attention(q, kv[0], kv[1], valid)
    return _out_proj(out.to(x.dtype), ap["wo"])


def d_inner(cfg: ModelConfig) -> int:
    """Inner width of a layer's Mamba2 sub-layer: the SSM config's for
    the SSM family, half of it for the hybrid family, whose SSM heads
    sit beside the attention heads (the reference's ``expand * d_model
    // 2``)."""
    if cfg.family == "hybrid":
        return cfg.ssm.expand * cfg.d_model // 2
    return cfg.ssm.d_inner(cfg.d_model)


def block_forward(bp: Dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, *, window: Optional[int] = None):
    """Full-sequence block.  Returns (x, aux loss (an f32 scalar, or None
    without a MoE FFN), the layer's cache entry): {"kv": (k, v)},
    {"kv": (c_kv, k_rope)} for MLA (which ignores ``window``, as the
    reference's does), {"ssm": (SSD state, conv state)}, or both "kv"
    and "ssm" for the hybrid family, whose attention and SSM sub-layers
    read the same normed input and are averaged: ``x + (attn(h) +
    mamba(h)) / 2``."""
    h = _norm(x, bp["norm1"], cfg.norm_eps)
    if cfg.family == "ssm":
        y, state = mamba_forward(bp["mamba"], h, cfg.ssm, d_inner(cfg),
                                 return_state=True)
        return x + y, None, {"ssm": state}
    if cfg.uses_mla:
        y, kv = mla_prefill(bp["mla"], h, cfg.mla, cfg.num_heads, positions,
                            cfg.rope_theta)
    else:
        y, kv = _attention(bp["attn"], h, cfg, positions, window=window)
    entry = {"kv": kv}
    if cfg.family == "hybrid":
        ym, entry["ssm"] = mamba_forward(bp["mamba"], h, cfg.ssm,
                                         d_inner(cfg), return_state=True)
        y = (y + ym) * 0.5
    x, aux = _ffn_aux(bp, x + y, cfg)
    return x, aux, entry


def block_decode(bp: Dict, x: torch.Tensor, cfg: ModelConfig,
                 layer_cache: Dict[str, Tuple[torch.Tensor, ...]],
                 positions: torch.Tensor, rules=None) -> torch.Tensor:
    """One-token block; writes this layer's cache entry (``layer_cache``:
    the leaves of ``cache["kv"]`` and/or ``cache["ssm"]`` at this layer)
    in place.  ``rules`` reach the GQA attention's context-parallel
    branch (:func:`_attention_decode`)."""
    h = _norm(x, bp["norm1"], cfg.norm_eps)
    y = None
    if cfg.uses_mla:
        y = mla_decode(bp["mla"], h, cfg.mla, cfg.num_heads,
                       layer_cache["kv"], positions, cfg.rope_theta)
    elif "kv" in layer_cache:
        y = _attention_decode(bp["attn"], h, cfg, layer_cache["kv"],
                              positions, rules)
    if "ssm" in layer_cache:
        state = layer_cache["ssm"]
        ym, new = mamba_decode(bp["mamba"], h, cfg.ssm, d_inner(cfg),
                               state)
        for leaf, value in zip(state, new):
            leaf.copy_(value)
        if y is None:                  # the SSM family: no FFN sub-layer
            return x + ym
        y = (y + ym) * 0.5
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
            patches=None, rules=None, act_dtype: torch.dtype = torch.bfloat16,
            cache_len: Optional[int] = None):
    """Build the decode cache.  tokens: [B, S] right-padded to S (the
    prompts attend causally over their pads, and an SSM row's state
    takes in its pads, as in the reference); lengths: [B] valid counts.
    ``cache_len`` sets the KV cache capacity (>= S pads, < S ring-packs,
    for sliding-window models).  Returns (next-token logits [B, V],
    cache): {"kv": (k, v)}, each [L, B, cache_len, Hkv, D] in
    ``act_dtype`` (a float cache with ``cfg.cache_int8`` too, as in the
    reference); {"kv": (c_kv [L, B, cache_len, R], k_rope [L, B,
    cache_len, Dr])} for MLA; for the SSM family {"ssm": (state [L, B,
    H, P, N], conv [L, B, C, K-1])} in f32, whatever ``act_dtype``; the
    hybrid family's holds both.  A sliding window masks the prefill's
    keys (``cfg.sliding_window``); only the KV is ring-packed.

    The vlm family takes ``patches`` [B, P, d] (P = ``cfg.num_patches``)
    and runs over P + S positions, the projected patches first, so its
    cache holds the patch prefix at positions 0..P-1 (sized by
    ``cache_len`` like any other); a row's logits are those at
    ``P + lengths - 1``.

    The logits are computed for each row's last valid position only
    (the reference computes all rows and picks one; the rows are
    independent, so only the size of the product differs: at full width
    the S-row product would be B * S * padded_vocab values).  ``rules``
    is accepted as :func:`lm_loss`'s is."""
    _require_dense(cfg)
    vlm = cfg.family == "vlm"
    if vlm and patches is None:
        raise ValueError(f"{cfg.name}: the vlm family's prefill takes "
                         f"patches [B, {cfg.num_patches}, d]")
    params = cast_params(params, act_dtype)
    x = _embed_in(params, tokens, act_dtype, patches if vlm else None)
    b, s = x.shape[:2]
    cl = s if cache_len is None else cache_len
    positions = torch.arange(s, device=x.device)
    # the KV leaves in act_dtype (float even for an int8 config), the
    # SSM state in f32
    shapes, _ = cache_struct(dataclasses.replace(cfg, cache_int8=False), b,
                             cl, act_dtype)
    cache = {key: tuple(torch.zeros(shape, dtype=dt, device=x.device)
                        for shape, dt in leaves)
             for key, leaves in shapes.items()}
    for i in range(cfg.num_layers):
        x, _, entry = block_forward(_layer(params["blocks"], i), x, cfg,
                                    positions, window=cfg.sliding_window)
        for leaf, new in zip(cache.get("kv", ()), entry.get("kv", ())):
            if cl >= s:              # pad: the zero tail is already there
                leaf[i, :, :s] = new
            else:
                leaf[i] = _fit_cache(new, s, cl)
        for leaf, new in zip(cache.get("ssm", ()), entry.get("ssm", ())):
            leaf[i] = new
    rows = torch.arange(b, device=x.device)
    offs = cfg.num_patches if vlm else 0
    last = x[rows, offs + lengths.long() - 1]
    logits = _logits(params, cfg, last[:, None])[:, 0]
    return logits, cache


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _run(layer, remat: bool, *args):
    """``layer(*args)``, recomputed in the backward pass with ``remat``
    (``torch.utils.checkpoint``, the reference's ``nothing_saveable``
    policy: nothing of the layer is kept but its inputs)."""
    if remat:
        return torch.utils.checkpoint.checkpoint(layer, *args,
                                                 use_reentrant=False)
    return layer(*args)


def _train_block(bp: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """One block of :func:`forward_train`: (x, aux); the cache entry the
    block computes on the way is dropped."""
    x, aux, _ = block_forward(bp, x, cfg, positions,
                              window=cfg.sliding_window)
    return x, aux


def forward_train(params: Dict, cfg: ModelConfig, tokens, *, patches=None,
                  act_dtype: torch.dtype = torch.bfloat16,
                  remat: bool = True):
    """tokens: [B, S] -> (logits [B, S', V], aux loss (f32 scalar, the
    layers' sum), hidden [B, S', d]), S' = S, or P + S for the vlm
    family's ``patches`` [B, P, d].  With ``remat`` and
    ``cfg.remat_mode != "none"`` each block is recomputed in the
    backward pass instead of keeping its activations."""
    _require_dense(cfg)
    params = cast_params(params, act_dtype)
    x = _embed_in(params, tokens, act_dtype,
                  patches if cfg.family == "vlm" else None)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and cfg.remat_mode != "none"
    for i in range(cfg.num_layers):
        x, a = _run(_train_block, remat, _layer(params["blocks"], i), x,
                    cfg, positions)
        if a is not None:
            aux = aux + a
    return _logits(params, cfg, x), aux, x


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE, ``logsumexp(logits) - logits[target]`` in f32
    (:func:`layers.upcast`).  With ``mask`` [1, S] (or [B, S]) the
    reference's masked mean: ``sum(ce * mask) / max(sum(mask) * B /
    mask.shape[0], 1)``."""
    lse = torch.logsumexp(upcast(logits), dim=-1)
    correct = upcast(logits.gather(-1, targets.long()[..., None])[..., 0])
    ce = lse - correct
    if mask is not None:
        return (ce * mask).sum() / torch.clamp(
            mask.sum() * ce.shape[0] / mask.shape[0], min=1.0)
    return ce.mean()


def lm_loss(params: Dict, cfg: ModelConfig, tokens, *, patches=None,
            rules=None, act_dtype: torch.dtype = torch.bfloat16,
            mtp_coef: float = 0.3):
    """Next-token CE over ``tokens`` [B, S] (labels shifted by one), plus
    the MoE aux loss, plus with ``cfg.mtp_depth`` ``mtp_coef`` times the
    multi-token-prediction CE (position t predicts t + 2 from the last
    hidden state and token t + 1's embedding, through ``params["mtp"]``;
    the last two positions masked).  The vlm family's patch positions
    are dropped first.  Returns (loss, {"ce", "aux"}).  ``rules`` is
    accepted as the reference's is; nothing here places by it
    (``partitioning.constrain`` is the identity)."""
    logits, aux, hidden = forward_train(params, cfg, tokens, patches=patches,
                                        act_dtype=act_dtype)
    s = tokens.shape[1]
    if cfg.family == "vlm":
        logits, hidden = logits[:, -s:], hidden[:, -s:]
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
    loss = ce + aux
    if cfg.mtp_depth:
        mp = params["mtp"]
        h = rms_norm(hidden, mp["norm_h"], cfg.norm_eps)
        shifted = torch.roll(tokens, -1, dims=1)          # t + 1 (tail junk)
        e = rms_norm(params["embed"][shifted.long()].to(h.dtype),
                     mp["norm_e"], cfg.norm_eps)
        hm = torch.cat([h, e], dim=-1) @ mp["proj"].to(h.dtype)
        pos = torch.arange(hm.shape[1], device=hm.device)
        hm, _, _ = block_forward(cast_params(mp["block"], h.dtype), hm, cfg,
                                 pos, window=cfg.sliding_window)
        mtp_logits = _logits(params, cfg, hm)
        mask = (torch.arange(s, device=hm.device) < s - 2).float()[None]
        loss = loss + mtp_coef * cross_entropy(
            mtp_logits, torch.roll(tokens, -2, dims=1), mask=mask)
    return loss, {"ce": ce, "aux": aux}


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict, tokens,
                positions, *, rules=None,
                act_dtype: torch.dtype = torch.bfloat16):
    """tokens: [B] new ids; positions: [B] tokens already cached (the new
    token's absolute position; an SSM step does not read it).  For the
    vlm family the positions are text-relative: the cache holds the
    patch prefix, so ``cfg.num_patches`` is added here, as in the
    reference.  Returns (logits [B, V], cache updated in place).
    With a mesh in ``rules``, a :func:`context_parallel` decode's cache
    is the whole cache or this rank's block of it (``model.shard_cache``
    and the rules it returns), and every rank computes the rest of the
    model for every row."""
    _require_dense(cfg)
    params = cast_params(params, act_dtype)
    if cfg.family == "vlm":
        positions = positions + cfg.num_patches
    x = _embed_in(params, tokens[:, None], act_dtype)
    for i in range(cfg.num_layers):
        x = block_decode(_layer(params["blocks"], i), x, cfg,
                         {key: tuple(leaf[i] for leaf in leaves)
                          for key, leaves in cache.items()}, positions,
                         rules)
    return _logits(params, cfg, x)[:, 0], cache


def cache_struct(cfg: ModelConfig, batch: int, seq: int,
                 dtype: torch.dtype = torch.bfloat16):
    """Returns ({key: ((shape, dtype), ...)}, logical axes) of the decode
    cache: {"kv": (k, v)} in ``dtype``, {"kv": (c_kv [L, B, S, R],
    k_rope [L, B, S, Dr])} in ``dtype`` for MLA, {"kv": (k int8, v int8,
    k scales bf16, v scales bf16)} with ``cfg.cache_int8``, {"ssm":
    (state, conv)} in f32 for the SSM family, and both "kv" and "ssm"
    for the hybrid family.  ``seq`` is the KV capacity (the window for
    sliding-window models); the SSM state does not depend on it."""
    _require_dense(cfg)
    n_layers = cfg.num_layers
    shapes: Dict[str, Tuple] = {}
    axes: Dict[str, Tuple] = {}
    if cfg.family != "ssm":
        shape = (n_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim)
        ax = ("layers", "cache_batch", "kv_seq", "cache_heads", None)
        if cfg.uses_mla:
            m, lat = cfg.mla, ("layers", "cache_batch", "kv_seq", None)
            shapes["kv"] = (((n_layers, batch, seq, m.kv_lora_rank), dtype),
                            ((n_layers, batch, seq, m.qk_rope_dim), dtype))
            axes["kv"] = (lat, lat)
        elif cfg.cache_int8:
            sc = shape[:-1]
            shapes["kv"] = ((shape, torch.int8), (shape, torch.int8),
                            (sc, torch.bfloat16), (sc, torch.bfloat16))
            axes["kv"] = (ax, ax, ax[:-1], ax[:-1])
        else:
            shapes["kv"] = ((shape, dtype), (shape, dtype))
            axes["kv"] = (ax, ax)
    if cfg.family in ("ssm", "hybrid"):
        sh, ax = mamba_state_spec(cfg, batch, d_inner(cfg))
        shapes["ssm"] = tuple(((n_layers,) + s, torch.float32) for s in sh)
        axes["ssm"] = tuple(("layers",) + a for a in ax)
    return shapes, axes


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
    one_split = {"splits": 1} if _INVARIANT[0] else {}
    out = paged_decode_attention(q[:, 0], k_pages, v_pages, block_tables,
                                 positions + 1, **one_split)
    return _out_proj(out[:, None].to(x.dtype), ap["wo"])


def _attention_by_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_pages: torch.Tensor, v_pages: torch.Tensor,
                       starts: torch.Tensor, lens: torch.Tensor,
                       write) -> torch.Tensor:
    """Suffix attention with the decode step's arithmetic, for
    :func:`batch_invariant`: the suffix K/V of the first ``write_lens[b]``
    positions is written into the pool first (the rest into
    ``null_block``), then each query row of q [B, S, Hq, D], at position
    ``starts[b] + j``, is one row of the paged decode kernel over the
    pool, one split.  A position at or past ``lens[b]`` attends as the
    last valid one does, and every length stays within the table.
    ``write`` = (tables [B, M] naming the prefix and suffix pages,
    write_lens [B], null_block)."""
    tables, write_lens, null_block = write
    b, s, hq, d = q.shape
    write_suffix_pages_batched({"k": k_pages[None], "v": v_pages[None]},
                               (k[None], v[None]), tables, starts,
                               write_lens, null_block=null_block)
    j = torch.arange(s, device=q.device)[None, :]
    last = torch.minimum(j, (lens[:, None].long() - 1).clamp(min=0))
    length = (starts[:, None].long() + last + 1).clamp(
        1, tables.shape[1] * k_pages.shape[1])
    out = paged_decode_attention(
        q.reshape(b * s, hq, d), k_pages, v_pages,
        tables.repeat_interleave(s, dim=0),
        length.reshape(-1).to(torch.int32), splits=1)
    return out.view(b, s, hq, d)


def _attention_prefill_suffix(ap: Dict, x: torch.Tensor, cfg: ModelConfig,
                              k_pages: torch.Tensor, v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              prefix_lens: torch.Tensor,
                              suffix_lens: torch.Tensor, *, write=None):
    """Suffix-token GQA attention against cached prefix pages plus the
    new suffix K/V (DESIGN.md §10).  Queries sit at absolute positions
    ``prefix_lens[b] + i``.  Returns (out, (k_suf, v_suf)): the suffix
    K/V is the request's private cache slice, written by the caller.
    Inside :func:`batch_invariant` it is written here, before the
    attention (:func:`_attention_by_rows`), which needs ``write`` =
    (tables, write_lens, null_block)."""
    s = x.shape[1]
    q, k, v = _qkv(ap, x, cfg)
    positions = (prefix_lens[:, None].long()
                 + torch.arange(s, device=x.device)[None, :])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if _INVARIANT[0]:
        if write is None:
            raise ValueError("batch-invariant suffix attention writes the "
                             "suffix K/V first: pass write=(tables, "
                             "write_lens, null_block)")
        out = _attention_by_rows(q, k, v, k_pages, v_pages, prefix_lens,
                                 suffix_lens, write)
    else:
        out = paged_prefix_prefill_attention(q, k, v, k_pages, v_pages,
                                             block_tables, prefix_lens,
                                             suffix_lens)
    return _out_proj(out.to(x.dtype), ap["wo"]), (k, v)


def prefill_suffix(params: Dict, cfg: ModelConfig, pages: Dict, tokens,
                   lengths, prefix_lens, block_tables, *,
                   act_dtype: torch.dtype = torch.bfloat16, write=None):
    """Suffix-only prefill against cached prefix pages.

    tokens: [B, S] suffix ids (the prompt past its cached prefix,
    right-padded); lengths: [B] valid suffix counts; prefix_lens: [B]
    cached prefix tokens (any offset; a partial final block is masked
    past ``prefix_lens``); block_tables: [B, M], shared prefix pages
    first.  Returns (next-token logits [B, V], suffix KV (k, v) each
    [L, B, S, Hkv, D]).

    The logits are computed for each row's last valid position only
    (the reference computes all S and then picks one; the rows are
    independent, so only the size of the product differs).  ``write``:
    as for :func:`_attention_prefill_suffix`, needed inside
    :func:`batch_invariant` only."""
    params = cast_params(params, act_dtype)
    x = _embed_in(params, tokens, act_dtype)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for i in range(cfg.num_layers):
        bp = _layer(params["blocks"], i)
        h = _norm(x, bp["norm1"], cfg.norm_eps)
        y, (k, v) = _attention_prefill_suffix(
            bp["attn"], h, cfg, pages["k"][i], pages["v"][i], block_tables,
            prefix_lens, lengths, write=write)
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
                                act_dtype=act_dtype,
                                write=(tables, write_lens, null_block))
    write_suffix_pages_batched(pages, kv, tables, prefix_lens, write_lens,
                               null_block=null_block)
    sl = slots.long()
    state["tables"][sl] = tables.to(state["tables"].dtype)
    state["positions"][sl] = positions.to(state["positions"].dtype)
    # index_fill_, not ``[sl] = True``: an index write of a Python value
    # copies it from the host and waits for the device
    state["active"].index_fill_(0, sl, True)
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
        h = _norm(x, bp["norm1"], cfg.norm_eps)
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


def draft_window(params: Dict, cfg: ModelConfig, pages: Dict, target_logits,
                 logits, positions, block_tables, active, *, num_steps: int,
                 target_vocab: int, act_dtype: torch.dtype = torch.bfloat16):
    """Draft ``num_steps`` speculative tokens per slot (DESIGN.md §16):
    the *draft* model's fused paged decode over its own pools.  The first
    token consumed is the target's greedy pick (argmax of
    ``target_logits[:, :target_vocab]``, already verified: it is the
    target's own next token); the other ``num_steps - 1`` come from the
    draft's carried logits.  Inactive slots keep their positions and
    decode into the null block, as in :func:`decode_multi_paged`.

    Returns ``(draft_logits, pages, proposed [B, num_steps])``; the
    draft's advance of ``positions`` is not returned (the verify's
    emitted count moves both pools' shared positions)."""
    inc = active.to(positions.dtype)
    tok = torch.argmax(target_logits[:, :target_vocab],
                       dim=-1).to(torch.int32)
    toks = []
    for i in range(num_steps):
        if i:
            tok = torch.argmax(logits[:, :cfg.vocab_size],
                               dim=-1).to(torch.int32)
        logits, pages = decode_step_paged(params, cfg, pages, tok, positions,
                                          block_tables, act_dtype=act_dtype)
        positions = positions + inc
        toks.append(tok)
    return logits, pages, torch.stack(toks, dim=1)


def verify_window(params: Dict, cfg: ModelConfig, pages: Dict, proposed,
                  logits, positions, block_tables, active, max_emit, *,
                  null_block: int, act_dtype: torch.dtype = torch.bfloat16):
    """Verify a drafted window in ONE batched target pass (DESIGN.md
    §16).  ``proposed`` [B, W] is the verified target token followed by
    the draft's ``W - 1`` guesses; the whole window runs through the
    prefix-prefill path (the pages up to ``positions`` ‖ the window's
    own causal K/V), so the logits at row ``i`` are those sequential
    decode would give after consuming ``proposed[:, i]``.  Guess ``i``
    is accepted iff it equals the target's greedy pick at row ``i - 1``;
    a slot emits ``1 +`` its longest agreeing prefix, clamped to
    ``max_emit`` [B] (the host's budget: tokens to finish, max_steps),
    and an inactive slot emits 0.  No correction token is emitted on a
    rejection: the carried logits at the last accepted row give it as
    the next window's first token, so the stream equals greedy decode.

    The K/V of all W positions is written (a rejected tail is reclaimed
    by the host's table truncation and the position rewind here; stale
    slots inside kept blocks are overwritten before they are read);
    inactive rows write into ``null_block`` only.  Unlike
    :func:`prefill_suffix`, the logits of all W rows are computed.

    Returns ``(logits, pages, positions, packed [B, W + 1])`` with
    ``packed = [proposed | emitted]``, the window's one readback."""
    params = cast_params(params, act_dtype)
    b, w = proposed.shape
    x = _embed_in(params, proposed, act_dtype)
    suffix_lens = torch.full((b,), w, dtype=torch.int32,
                             device=proposed.device)
    write_lens = torch.where(active, suffix_lens,
                             torch.zeros_like(suffix_lens))
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for i in range(cfg.num_layers):
        bp = _layer(params["blocks"], i)
        h = _norm(x, bp["norm1"], cfg.norm_eps)
        y, (k, v) = _attention_prefill_suffix(
            bp["attn"], h, cfg, pages["k"][i], pages["v"][i], block_tables,
            positions, suffix_lens,
            write=(block_tables, write_lens, null_block))
        x = _ffn(bp, x + y, cfg)
        ks.append(k)
        vs.append(v)
    all_logits = _logits(params, cfg, x)                     # [B, W, Vp]
    write_suffix_pages_batched(
        pages, (torch.stack(ks), torch.stack(vs)), block_tables, positions,
        write_lens, null_block=null_block)
    greedy = torch.argmax(all_logits[:, :, :cfg.vocab_size],
                          dim=-1).to(torch.int32)
    match = (proposed[:, 1:] == greedy[:, :-1]).to(torch.int32)
    agree = torch.cumprod(match, dim=1).sum(dim=1)          # longest prefix
    emitted = torch.minimum(agree + 1, max_emit.to(agree.dtype))
    emitted = torch.where(active, emitted,
                          torch.zeros_like(emitted)).to(positions.dtype)
    idx = torch.clamp(emitted - 1, min=0).long()
    rows = torch.arange(b, device=proposed.device)
    carry = all_logits[rows, idx].to(logits.dtype)
    new_logits = torch.where(active[:, None], carry, logits)
    packed = torch.cat([proposed.to(torch.int32),
                        emitted[:, None].to(torch.int32)], dim=1)
    return new_logits, pages, positions + emitted, packed


def write_prefill_pages_batched(pages: Dict, kv, tables, *,
                                null_block: int = 0, pad_to: int = 0
                                ) -> Dict:
    """Write a batched dense prefill cache (k, v each [L, B, S, Hkv, D])
    into every request's blocks, in place, one indexed write per pool.

    ``tables`` is a list of host-side block-id lists, one per batch row;
    short or empty rows pad with ``null_block`` (rows past
    ``len(tables)``, a bucket's pad rows, are all null).  Each row's S is
    cut or zero-padded to the common table capacity; positions past a
    request's prompt land in its own reserved blocks or in the null
    block, never in another request's pages.  ``pad_to`` fixes the
    blocks a row (an engine's ``max_blocks``).  All-empty tables with
    ``pad_to=0`` write nothing (block 0 is a live block).  The reference
    package's ``write_prefill_pages_batched``, which no engine calls
    since its wave admission (DESIGN.md §12); kept for parity."""
    bt = pages["k"].shape[2]
    b = kv[0].shape[1]
    max_nb = max([len(t) for t in tables] + [pad_to])
    if max_nb == 0:
        return pages
    rows = torch.full((b, max_nb), null_block, dtype=torch.long)
    for i, t in enumerate(tables):
        rows[i, :len(t)] = torch.tensor(list(t), dtype=torch.long)
    idx = rows.reshape(-1).to(pages["k"].device)
    cap = max_nb * bt
    for key, c in zip(("k", "v"), kv):
        pool = pages[key]
        n_layers, bb, s, h, dh = c.shape
        c = c[:, :, :min(s, cap)]
        if c.shape[2] < cap:
            c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, cap - c.shape[2]))
        pool[:, idx] = c.reshape(n_layers, bb * max_nb, bt, h, dh).to(
            pool.dtype)
    return pages


def write_prefill_pages(pages: Dict, kv, table) -> Dict:
    """One request's :func:`write_prefill_pages_batched` (k, v each [L,
    1, S, Hkv, D])."""
    return write_prefill_pages_batched(pages, kv, [list(table)])


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
