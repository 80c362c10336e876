"""Model facade for the dense-cache and paged serving paths (the
reference package's ``models/model.py``).  Batches are dicts of tensors:

  loss_fn (training) : {"tokens": [B, S]}, with "patches" or "frames"
                       as prefill's
  prefill            : {"tokens": [B, S], "lengths": [B]}, and for the
                       vlm family "patches": [B, num_patches, d_model],
                       for the encoder-decoder family "frames": [B,
                       encoder_seq, d_model]
  decode_step        : {"tokens": [B], "positions": [B]} against a dense
                       cache: {"kv": (k, v)}, each [L, B, S, Hkv, D];
                       {"kv": (c_kv [L, B, S, R], k_rope [L, B, S, Dr])}
                       (the MLA family's latents); {"kv": (k, v,
                       k_scale, v_scale)} int8 with bf16 scales [L, B,
                       S, Hkv] (``cfg.cache_int8``); {"ssm": (state,
                       conv)} (the SSM family); {"kv": (k, v), "ssm":
                       (state, conv)} (the hybrid family: both, written
                       in place by each step); or {"kv": (k, v),
                       "cross": (ck, cv)} (the encoder-decoder family:
                       the self K/V, written in place, and the encoder's
                       cross K/V, read).  The vlm family's positions are
                       text-relative (the patch prefix is added inside)
  decode_multi       : {"logits": [B, padded_vocab], "positions": [B]}
                       (``decode_step_into``: one of its steps in place,
                       ``greedy_token_into`` then ``decode_step_fed_into``)
  prefill_wave       : {"tokens": [B, S], "lengths": [B], "prefix_lens",
                        "attn_tables", "tables", "write_lens", "cow_src",
                        "cow_dst", "slots", "row_sel", "positions"}
  decode_step_paged  : {"tokens": [B], "positions": [B], "block_tables"}
  decode_multi_paged : {"logits": [B, padded_vocab], "positions": [B],
                        "block_tables": [B, M], "active": [B] bool}
                       (``decode_step_paged_into``: one step in place)
  draft_window       : {"target_logits", "logits": [B, padded_vocab] draft
                        carry, "positions", "block_tables", "active"}
  verify_window      : {"proposed": [B, W], "logits", "positions",
                        "block_tables", "active", "max_emit": [B]}
                       (``draft_window_into``, ``verify_window_into``: in
                       place, the speculative window of §16)

The functions run where their tensors live; the constructors
(:func:`init_params`, :func:`init_cache`, :func:`init_paged_cache`)
take a ``device`` that defaults to the CUDA card and raise without one.
Every family has a dense cache: dense, MoE (GQA, or MLA for
deepseek-v3), SSM (mamba2), hybrid (hymba) and vlm (internvl2) through
``models/transformer.py``, and the encoder-decoder family (whisper)
through ``models/encdec.py`` (:func:`_is_encdec` dispatches, as in the
reference).  The paged entry points serve the dense and MoE families
without MLA (:func:`supports_paged`, the reference's rule).  :func:`batch_invariant` makes their
arithmetic of a token independent of its batch, wave or window.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import params as params_lib
from repro_torch import partitioning
from repro_torch.analysis.sanitizer import hot_path
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.attention import batch_spec

batch_invariant = transformer.batch_invariant


def _is_encdec(cfg: ModelConfig) -> bool:
    return cfg.family == "audio"


class ParamStruct(NamedTuple):
    """A parameter leaf's stand-in: shape, dtype and logical axes (the
    reference's ``ParamSpec`` without its initialiser)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: Tuple[Optional[str], ...]


def model_spec(cfg: ModelConfig, dtype: torch.dtype = torch.float32):
    """The parameter tree of ``cfg`` as :class:`ParamStruct` leaves, no
    allocation: ``dtype``, except the SSM decay parameters and the MoE
    router, which are f32 (``transformer.KEEP_F32``), as the reference's
    ``model_spec`` declares them."""
    def make(tree, f32: bool):
        if isinstance(tree, dict):
            return {k: make(v, k in transformer.KEEP_F32)
                    for k, v in tree.items()}
        return ParamStruct(tree.shape, torch.float32 if f32 else dtype,
                           tree.axes)
    return make(params_lib.param_specs(cfg), False)


def param_axes(cfg: ModelConfig, dtype: torch.dtype = torch.float32):
    """The logical axes of every parameter leaf (the reference's
    ``param_axes``), as ``partitioning.tree_shardings`` reads them."""
    def axes(tree):
        if isinstance(tree, dict):
            return {k: axes(v) for k, v in tree.items()}
        return tree.axes
    return axes(model_spec(cfg, dtype))


def cache_struct(cfg: ModelConfig, batch: int, seq: int,
                 dtype: torch.dtype = torch.bfloat16):
    """({key: ((shape, dtype), ...)}, logical axes) of the decode cache
    (``transformer.cache_struct``, ``encdec.cache_struct``)."""
    mod = encdec if _is_encdec(cfg) else transformer
    return mod.cache_struct(cfg, batch, seq, dtype)


def shard_cache(cfg: ModelConfig, cache, rules: Dict[str, Any]):
    """Place a whole decode ``cache`` on the mesh of ``rules``
    (``partitioning.with_mesh_rules``): returns (this rank's cache, the
    rules to decode it with).

    A GQA config that decodes context-parallel on the mesh
    (``transformer.context_parallel``: ``decode_cp`` and a model axis
    that divides the cache) keeps this rank's block of each ``"kv"``
    leaf: the sequence over the model axis, the rows as
    ``attention.batch_spec`` shards them (a contiguous copy of
    ``partitioning.shard_local``'s view, as the decode kernel reads
    whole rows).  The returned rules record the whole cache's slot
    count under ``"_kv_len"``, which tells the decode that the cache
    is a block.  Every other leaf stays whole, as every rank computes
    the rest of the model.  Any other config or cache is returned whole
    with ``rules`` unchanged, and decodes as on one device: the
    reference's fallback to plain decode attention."""
    mesh = rules["_mesh"]
    if "kv" not in cache or cfg.uses_mla or _is_encdec(cfg):
        return cache, rules
    _, b, s = cache["kv"][0].shape[:3]
    if not transformer.context_parallel(cfg, mesh, s):
        return cache, rules
    spec = (None, batch_spec(mesh, b, rules.get("cache_batch", ("data",))),
            "model")
    local = dict(cache)
    local["kv"] = tuple(partitioning.shard_local(t, spec, mesh).contiguous()
                        for t in cache["kv"])
    return local, dict(rules, _kv_len=s)


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None):
    """A zero dense decode cache: {"kv": (k, v)}, each [L, batch, seq,
    Hkv, D] in ``dtype``; the latents (c_kv, k_rope) in ``dtype`` for
    MLA; int8 values and bf16 scales with ``cfg.cache_int8``; {"ssm":
    (state, conv)} in f32 for the SSM family; both keys for the hybrid
    family; {"kv", "cross"} for the encoder-decoder family, the cross
    K/V of ``encoder_seq`` rows."""
    mod = encdec if _is_encdec(cfg) else transformer
    return mod.init_cache(cfg, batch, seq, dtype=dtype,
                          device=resolve_device(device))


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            rules=None, act_dtype: torch.dtype = torch.bfloat16):
    """The training loss of a batch {"tokens": [B, S], and "patches" or
    "frames" for the vlm and encoder-decoder families}: (loss, {"ce",
    "aux"}), as the reference's ``loss_fn``.  ``rules`` are passed on as
    the reference's are; the port places nothing by them
    (``partitioning.constrain`` is the identity)."""
    if _is_encdec(cfg):
        return encdec.lm_loss(params, cfg, batch["tokens"], batch["frames"],
                              rules=rules, act_dtype=act_dtype)
    return transformer.lm_loss(params, cfg, batch["tokens"],
                               patches=batch.get("patches"), rules=rules,
                               act_dtype=act_dtype)


@hot_path
def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            rules=None, act_dtype: torch.dtype = torch.bfloat16,
            cache_len: Optional[int] = None):
    """Prefill right-padded prompts.  Returns (next-token logits [B, V],
    dense cache of capacity ``cache_len``: a float KV cache, also for an
    int8 config, as in the reference; the latents for MLA; the recurrent
    state for the SSM family; both for the hybrid family, whose prefill
    masks keys outside ``cfg.sliding_window`` and whose ``cache_len``
    below S ring-packs the KV only).  The vlm family's cache holds the
    ``batch["patches"]`` prefix in front of the prompt, so it needs
    ``cache_len`` >= num_patches + S to keep all of it (the reference's
    ``ContinuousEngine`` sizes it without the patches and ring-packs).
    The encoder-decoder family encodes ``batch["frames"]`` first; its
    self K/V is zero-padded or cut (not ring-packed) to ``cache_len``,
    and its cross K/V has the encoder's padded rows.  ``rules`` are
    passed on as the reference's are (see :func:`loss_fn`)."""
    if _is_encdec(cfg):
        return encdec.prefill(params, cfg, batch["tokens"], batch["lengths"],
                              batch["frames"], rules=rules,
                              act_dtype=act_dtype, cache_len=cache_len)
    return transformer.prefill(params, cfg, batch["tokens"],
                               batch["lengths"],
                               patches=batch.get("patches"), rules=rules,
                               act_dtype=act_dtype, cache_len=cache_len)


@hot_path
def decode_step(params, cfg: ModelConfig, cache, batch: Dict[str, Any], *,
                rules=None, act_dtype: torch.dtype = torch.bfloat16):
    """One token per row against the dense cache (updated in place).
    Returns (logits [B, V], cache).  ``rules`` (``partitioning.
    with_mesh_rules``) carry a mesh to a ``cfg.decode_cp`` config's
    context-parallel attention; the cache is then the whole cache, or
    this rank's block of it with the rules :func:`shard_cache`
    returned, and the logits are every row's, on every rank."""
    mod = encdec if _is_encdec(cfg) else transformer
    return mod.decode_step(params, cfg, cache, batch["tokens"],
                           batch["positions"], rules=rules,
                           act_dtype=act_dtype)


@hot_path
def decode_multi(params, cfg: ModelConfig, cache, batch: Dict[str, Any], *,
                 num_steps: int, rules=None,
                 act_dtype: torch.dtype = torch.bfloat16):
    """Fused ``num_steps``-step greedy decode against a dense cache.

    batch: {"logits": [B, padded_vocab] seed logits (from prefill or the
    previous window), "positions": [B]}.  Each step argmaxes the carried
    logits on the device and feeds the token straight into the next
    :func:`decode_step`; nothing is read back inside the loop.  Returns
    ``(logits, cache, positions, tokens [B, num_steps])``, equal to
    ``num_steps`` sequential decode_step calls with the argmax between
    them."""
    logits, positions = batch["logits"], batch["positions"]
    toks = []
    for _ in range(num_steps):
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)
        logits, cache = decode_step(params, cfg, cache,
                                    {"tokens": tok, "positions": positions},
                                    rules=rules, act_dtype=act_dtype)
        positions = positions + 1
        toks.append(tok)
    return logits, cache, positions, torch.stack(toks, dim=1)


@hot_path
def greedy_token_into(cfg: ModelConfig, logits: torch.Tensor,
                      tok_out: torch.Tensor) -> None:
    """Each row's greedy token of the carried ``logits`` [B, padded
    vocab], written into ``tok_out`` [B] (int32)."""
    tok_out.copy_(torch.argmax(logits[:, :cfg.vocab_size], dim=-1))


@hot_path
def decode_step_fed_into(params, cfg: ModelConfig, cache,
                         state: Dict[str, torch.Tensor], *,
                         act_dtype: torch.dtype = torch.bfloat16) -> None:
    """:func:`decode_step_into` after its argmax: run :func:`decode_step`
    on ``state["tokens"]`` at ``state["positions"]`` (the cache written in
    place), copy the new logits into ``state["logits"]`` and advance every
    row's position.  ``ContinuousEngine`` takes each step's token apart,
    so that the host can read it back while this part runs."""
    new_logits, _ = decode_step(params, cfg, cache,
                                {"tokens": state["tokens"],
                                 "positions": state["positions"]},
                                act_dtype=act_dtype)
    state["logits"].copy_(new_logits)
    state["positions"].add_(1)


@hot_path
def decode_step_into(params, cfg: ModelConfig, cache,
                     state: Dict[str, torch.Tensor], tok_out: torch.Tensor,
                     *, act_dtype: torch.dtype = torch.bfloat16) -> None:
    """One step of :func:`decode_multi` written in place, so that a CUDA
    graph can replay it: argmax the carried ``state["logits"]`` into
    ``tok_out`` [B] (:func:`greedy_token_into`), then run
    :func:`decode_step_fed_into` on that token: :func:`decode_step` at
    ``state["positions"]`` (the dense cache, the MLA latents, the SSM
    state, both for the hybrid family, or the self K/V of the
    encoder-decoder family, written in place), the new logits copied
    into ``state["logits"]``, every row's position advanced (the padded
    batch has no idle row).  ``k`` calls equal
    ``decode_multi(num_steps=k)``."""
    greedy_token_into(cfg, state["logits"], tok_out)
    decode_step_fed_into(params, cfg, cache, {**state, "tokens": tok_out},
                         act_dtype=act_dtype)


def supports_paged(cfg: ModelConfig) -> Tuple[bool, str]:
    if _is_encdec(cfg):
        return False, "enc-dec cross-KV caches are not paged"
    return transformer.supports_paged(cfg)


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random weights from ``seed`` (see :func:`repro_torch.params.
    init_params`), drawn by a generator on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return params_lib.init_params(cfg, generator=gen, device=dev,
                                  dtype=dtype)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_tokens: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None):
    return transformer.init_paged_cache(cfg, num_blocks, block_tokens,
                                        dtype=dtype,
                                        device=resolve_device(device))


@hot_path
def prefill_suffix(params, cfg: ModelConfig, pages, batch: Dict[str, Any],
                   *, act_dtype: torch.dtype = torch.bfloat16):
    """Suffix-only prefill against cached prefix pages.  batch:
    {"tokens": [B, S], "lengths": [B], "prefix_lens": [B],
    "block_tables": [B, M]}.  Returns (logits [B, V], suffix kv)."""
    return transformer.prefill_suffix(
        params, cfg, pages, batch["tokens"], batch["lengths"],
        batch["prefix_lens"], batch["block_tables"], act_dtype=act_dtype)


@hot_path
def prefill_wave(params, cfg: ModelConfig, pages, state,
                 batch: Dict[str, Any], *, null_block: int,
                 act_dtype: torch.dtype = torch.bfloat16):
    """Single-dispatch variable-prefix admission wave (DESIGN.md §12):
    copy-on-write clones + suffix prefill with per-row ``prefix_lens``
    (0 = miss) + token-granular suffix-KV write + per-slot engine-state
    update.  ``state``: {"tables", "positions", "active", "logits"},
    updated in place; writes that the reference drops land in
    ``null_block``.  Returns (pages, state)."""
    return transformer.prefill_wave(
        params, cfg, pages, state, tokens=batch["tokens"],
        lengths=batch["lengths"], prefix_lens=batch["prefix_lens"],
        attn_tables=batch["attn_tables"], tables=batch["tables"],
        write_lens=batch["write_lens"], cow_src=batch["cow_src"],
        cow_dst=batch["cow_dst"], slots=batch["slots"],
        row_sel=batch["row_sel"], positions=batch["positions"],
        null_block=null_block, act_dtype=act_dtype)


@hot_path
def decode_step_paged(params, cfg: ModelConfig, pages, batch: Dict[str, Any],
                      *, act_dtype: torch.dtype = torch.bfloat16):
    """batch: {"tokens": [B], "positions": [B], "block_tables": [B, M]}."""
    return transformer.decode_step_paged(
        params, cfg, pages, batch["tokens"], batch["positions"],
        batch["block_tables"], act_dtype=act_dtype)


@hot_path
def decode_multi_paged(params, cfg: ModelConfig, pages,
                       batch: Dict[str, Any], *, num_steps: int,
                       act_dtype: torch.dtype = torch.bfloat16):
    """Fused multi-step paged decode.  Returns (logits, pages, positions,
    tokens [B, num_steps])."""
    return transformer.decode_multi_paged(
        params, cfg, pages, batch["logits"], batch["positions"],
        batch["block_tables"], batch["active"], num_steps=num_steps,
        act_dtype=act_dtype)


@hot_path
def decode_step_paged_into(params, cfg: ModelConfig, pages,
                           state: Dict[str, torch.Tensor],
                           tok_out: torch.Tensor, *,
                           act_dtype: torch.dtype = torch.bfloat16) -> None:
    """One step of :func:`decode_multi_paged` written in place: argmax
    the carried ``state["logits"]``, run :func:`decode_step_paged` on
    ``state["positions"]`` and ``state["tables"]``, write the new logits
    into ``state["logits"]``, advance ``state["positions"]`` where
    ``state["active"]``, and write the step's token into ``tok_out``."""
    logits, positions = state["logits"], state["positions"]
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)
    new_logits, _ = decode_step_paged(
        params, cfg, pages, {"tokens": tok, "positions": positions,
                             "block_tables": state["tables"]},
        act_dtype=act_dtype)
    logits.copy_(new_logits)
    positions.add_(state["active"].to(positions.dtype))
    tok_out.copy_(tok)


@hot_path
def draft_window(params, cfg: ModelConfig, pages, batch: Dict[str, Any], *,
                 num_steps: int, target_vocab: int,
                 act_dtype: torch.dtype = torch.bfloat16):
    """Draft ``num_steps`` speculative tokens with the draft model
    (``params``, ``cfg`` and ``pages`` are the DRAFT's; DESIGN.md §16).
    batch: {"target_logits": [B, target padded_vocab], "logits": [B,
    padded_vocab] draft carry, "positions": [B], "block_tables": [B, M]
    draft tables, "active": [B] bool}.  Returns (draft logits, pages,
    proposed [B, num_steps])."""
    return transformer.draft_window(
        params, cfg, pages, batch["target_logits"], batch["logits"],
        batch["positions"], batch["block_tables"], batch["active"],
        num_steps=num_steps, target_vocab=target_vocab, act_dtype=act_dtype)


@hot_path
def verify_window(params, cfg: ModelConfig, pages, batch: Dict[str, Any], *,
                  null_block: int, act_dtype: torch.dtype = torch.bfloat16):
    """Verify a drafted window in one batched target pass (DESIGN.md
    §16).  batch: {"proposed": [B, W], "logits": [B, padded_vocab] target
    carry, "positions": [B], "block_tables": [B, M] target tables,
    "active": [B] bool, "max_emit": [B] per-slot emit budget}.  Returns
    (logits, pages, positions, packed [B, W+1])."""
    return transformer.verify_window(
        params, cfg, pages, batch["proposed"], batch["logits"],
        batch["positions"], batch["block_tables"], batch["active"],
        batch["max_emit"], null_block=null_block, act_dtype=act_dtype)


@hot_path
def draft_window_into(params, cfg: ModelConfig, pages,
                      state: Dict[str, torch.Tensor],
                      proposed_out: torch.Tensor, *, target_vocab: int,
                      act_dtype: torch.dtype = torch.bfloat16) -> None:
    """:func:`draft_window` written in place, so that a CUDA graph can
    replay it: ``state`` = {"target_logits", "logits" (the draft carry,
    overwritten), "positions" (read, not advanced), "tables" (the draft
    tables), "active"}; the proposals go into ``proposed_out`` [B, W],
    whose width is the window's."""
    logits, _, proposed = transformer.draft_window(
        params, cfg, pages, state["target_logits"], state["logits"],
        state["positions"], state["tables"], state["active"],
        num_steps=proposed_out.shape[1], target_vocab=target_vocab,
        act_dtype=act_dtype)
    state["logits"].copy_(logits)
    proposed_out.copy_(proposed)


@hot_path
def verify_window_into(params, cfg: ModelConfig, pages,
                       state: Dict[str, torch.Tensor],
                       proposed: torch.Tensor, packed_out: torch.Tensor, *,
                       null_block: int,
                       act_dtype: torch.dtype = torch.bfloat16) -> None:
    """:func:`verify_window` written in place: ``state`` = {"logits",
    "positions" (both overwritten), "tables", "active", "max_emit"};
    ``packed_out`` [B, W+1] receives the packed tokens and counts."""
    logits, _, positions, packed = transformer.verify_window(
        params, cfg, pages, proposed, state["logits"], state["positions"],
        state["tables"], state["active"], state["max_emit"],
        null_block=null_block, act_dtype=act_dtype)
    state["logits"].copy_(logits)
    state["positions"].copy_(positions)
    packed_out.copy_(packed)


def write_prefill_pages(pages, kv, table):
    """One request's dense prefill cache into its blocks, in place."""
    return transformer.write_prefill_pages(pages, kv, table)


def write_prefill_pages_batched(pages, kv, tables, *, null_block: int = 0,
                                pad_to: int = 0):
    """Block-granular write of a batched dense prefill cache into each
    row's blocks, in place (``transformer.write_prefill_pages_batched``)."""
    return transformer.write_prefill_pages_batched(
        pages, kv, tables, null_block=null_block, pad_to=pad_to)


def write_suffix_pages_batched(pages, kv, block_tables, starts, lengths, *,
                               null_block: int):
    """Token-granular suffix-KV write at arbitrary offsets (DESIGN.md
    §11)."""
    return transformer.write_suffix_pages_batched(
        pages, kv, block_tables, starts, lengths, null_block=null_block)


@hot_path
def copy_pages(pages, src, dst):
    """Copy-on-write block clone: pages[:, dst[i]] = pages[:, src[i]]."""
    return transformer.copy_pages(pages, src, dst)


@hot_path
def gather_pages(pages, blocks):
    """Stack pool pages at ``blocks`` for a host swap-out (§15)."""
    return transformer.gather_pages(pages, blocks)


@hot_path
def scatter_pages(pages, blocks, values):
    """Scatter swapped-in host pages back into the pools, in place (§15)."""
    return transformer.scatter_pages(pages, blocks, values)


# ---------------------------------------------------------------------------
# Shapes for dry-runs: (shape, dtype) stand-ins, no allocation
# ---------------------------------------------------------------------------

def decode_cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    """Cache capacity for a decode shape: the full seq_len, or the
    sliding window for SWA and long-context runs."""
    if cfg.family == "ssm":
        return 1  # unused; SSM caches are constant-size states
    if shape.name == "long_500k":
        return cfg.sliding_window or 8192
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, shape.seq_len)
    return shape.seq_len


def supports_shape(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family == "audio":
        return False, ("enc-dec speech model: 448-token decoder context and "
                       "a fixed 30s audio window make a 524288-token decode "
                       "architecturally meaningless (see DESIGN.md)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """``(shape, dtype)`` stand-ins and logical axes of every model input
    of the workload shape: {"specs": {...}, "axes": {...}}.  (The
    reference's ``cache_dtype`` argument is not taken: it reads it
    nowhere, as no input here is a cache.)"""
    b, s = shape.global_batch, shape.seq_len
    tok = lambda *sh: (tuple(sh), torch.int32)
    emb = lambda *sh: (tuple(sh), torch.bfloat16)
    specs: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        s_text = s - cfg.num_patches if cfg.family == "vlm" else s
        specs["tokens"] = tok(b, s_text)
        axes["tokens"] = ("act_batch", "act_seq")
        if cfg.family == "vlm":
            specs["patches"] = emb(b, cfg.num_patches, cfg.d_model)
            axes["patches"] = ("act_batch", None, "act_embed")
        if cfg.family == "audio":
            specs["frames"] = emb(b, cfg.encoder_seq, cfg.d_model)
            axes["frames"] = ("act_batch", None, "act_embed")
        if shape.kind == "prefill":
            specs["lengths"] = tok(b)
            axes["lengths"] = ("act_batch",)
    else:  # decode: one new token against a seq_len cache
        specs["tokens"] = tok(b)
        specs["positions"] = tok(b)
        axes["tokens"] = ("act_batch",)
        axes["positions"] = ("act_batch",)
    return {"specs": specs, "axes": axes}
