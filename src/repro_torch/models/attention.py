"""GQA attention of the dense serving path (the reference package's
``models/attention.py``): prefill over a right-padded prompt batch and
one-token decode against a dense, possibly ring-buffered, KV cache.

The reference computes both contractions in jnp and keeps its Pallas
kernels beside them; here both route to the hand-written kernels through
their ops (the CUDA kernel on the card, the plain version on the CPU).
The context-parallel ``gqa_decode_attention_cp`` is not ported yet (it
needs a device mesh)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention


def gqa_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D], with
    query i at position i.  Keys at or past ``kv_len`` are masked (the
    encoder's pad frames, the cross attention's pad rows).  A causal or
    window mask needs Sq == Sk; full mode (cross attention) takes any
    Sk, as the reference's signature does (without its ``q_offset``,
    which no caller passes)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           kv_len=kv_len)


def gqa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, 1, Hq, D]; caches: [B, S, Hkv, D]; lengths: [B] valid cache
    entries per request (the padded batch's waiting slots beyond it are
    masked, and never read by the kernel) -> [B, 1, Hq, D].  A wrapped
    ring buffer is valid in full (``lengths == S``)."""
    return decode_attention(q[:, 0], k_cache, v_cache, lengths)[:, None]
