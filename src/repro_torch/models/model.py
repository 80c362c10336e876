"""Model facade for the dense-cache and paged serving paths (the
reference package's ``models/model.py``).  Batches are dicts of tensors:

  prefill            : {"tokens": [B, S], "lengths": [B]}
  decode_step        : {"tokens": [B], "positions": [B]} against a dense
                       cache: {"kv": (k, v)}, each [L, B, S, Hkv, D];
                       {"kv": (k, v, k_scale, v_scale)} int8 with bf16
                       scales [L, B, S, Hkv] (``cfg.cache_int8``); or
                       {"ssm": (state, conv)} (the SSM family)
  decode_multi       : {"logits": [B, padded_vocab], "positions": [B]}
                       (``decode_step_into``: one of its steps in place)
  prefill_wave       : {"tokens": [B, S], "lengths": [B], "prefix_lens",
                        "attn_tables", "tables", "write_lens", "cow_src",
                        "cow_dst", "slots", "row_sel", "positions"}
  decode_step_paged  : {"tokens": [B], "positions": [B], "block_tables"}
  decode_multi_paged : {"logits": [B, padded_vocab], "positions": [B],
                        "block_tables": [B, M], "active": [B] bool}
                       (``decode_step_paged_into``: one step in place)

The functions run where their tensors live; the constructors
(:func:`init_params`, :func:`init_cache`, :func:`init_paged_cache`)
take a ``device`` that defaults to the CUDA card and raise without one.
The dense and SSM families have a dense cache in the port; the others
raise ``NotImplementedError`` (``transformer.supports_dense`` says why).
The paged entry points serve the dense family only
(:func:`supports_paged`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import params as params_lib
from repro_torch.analysis.sanitizer import hot_path
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None):
    """A zero dense decode cache: {"kv": (k, v)}, each [L, batch, seq,
    Hkv, D] in ``dtype``; int8 values and bf16 scales with
    ``cfg.cache_int8``; {"ssm": (state, conv)} in f32 for the SSM
    family."""
    return transformer.init_cache(cfg, batch, seq, dtype=dtype,
                                  device=resolve_device(device))


@hot_path
def prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            act_dtype: torch.dtype = torch.bfloat16,
            cache_len: Optional[int] = None):
    """Prefill right-padded prompts.  Returns (next-token logits [B, V],
    dense cache of capacity ``cache_len``: a float KV cache, also for an
    int8 config, as in the reference; the recurrent state for the SSM
    family)."""
    return transformer.prefill(params, cfg, batch["tokens"],
                               batch["lengths"], act_dtype=act_dtype,
                               cache_len=cache_len)


@hot_path
def decode_step(params, cfg: ModelConfig, cache, batch: Dict[str, Any], *,
                act_dtype: torch.dtype = torch.bfloat16):
    """One token per row against the dense cache (updated in place).
    Returns (logits [B, V], cache)."""
    return transformer.decode_step(params, cfg, cache, batch["tokens"],
                                   batch["positions"], act_dtype=act_dtype)


@hot_path
def decode_multi(params, cfg: ModelConfig, cache, batch: Dict[str, Any], *,
                 num_steps: int, act_dtype: torch.dtype = torch.bfloat16):
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
                                    act_dtype=act_dtype)
        positions = positions + 1
        toks.append(tok)
    return logits, cache, positions, torch.stack(toks, dim=1)


@hot_path
def decode_step_into(params, cfg: ModelConfig, cache,
                     state: Dict[str, torch.Tensor], tok_out: torch.Tensor,
                     *, act_dtype: torch.dtype = torch.bfloat16) -> None:
    """One step of :func:`decode_multi` written in place, so that a CUDA
    graph can replay it: argmax the carried ``state["logits"]``, run
    :func:`decode_step` at ``state["positions"]`` (the dense cache or the
    SSM state is written in place), copy the new logits into
    ``state["logits"]``, advance every row's position (the padded batch
    has no idle row) and write the step's token into ``tok_out`` [B].
    ``k`` calls equal ``decode_multi(num_steps=k)``."""
    logits, positions = state["logits"], state["positions"]
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)
    new_logits, _ = decode_step(params, cfg, cache,
                                {"tokens": tok, "positions": positions},
                                act_dtype=act_dtype)
    logits.copy_(new_logits)
    positions.add_(1)
    tok_out.copy_(tok)


def supports_paged(cfg: ModelConfig) -> Tuple[bool, str]:
    if cfg.family == "audio":
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
