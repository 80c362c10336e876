"""Wasted-memory-access (WMA) metric and the KV-memory model — Eqs. (1)-(5)
of the paper, generalized per architecture family (DESIGN.md §5).

WMA_gen(p)  = G(p) * (L(B) - L(p))                      -- pad-token reads
WMA_wait(p) = sum_{g=G(p)}^{G(B)} (g + L(B))            -- invalid decode reads
WMA(B)      = max_p WMA_gen(p) + WMA_wait(p)
MEM(B)      = beta * (L(B) + G(B)) * delta              -- KV bytes (Eq. 5)
beta_vanilla = floor(Theta / ((L_max + G_max) * delta))  -- Eq. (1)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import Batch, Request


def wma_gen(req_len: int, gen_len: int, batch_len: int) -> int:
    return gen_len * (batch_len - req_len)


def wma_wait(gen_len: int, batch_len: int, batch_gen_len: int) -> int:
    """sum_{g=G(p)}^{G(B)} (g + L(B)); zero when the request is the longest."""
    n = batch_gen_len - gen_len + 1
    if n <= 1:
        return 0
    # inclusive arithmetic series g = gen_len..batch_gen_len
    return (batch_gen_len + gen_len) * n // 2 + batch_len * n


def batch_wma(lengths: Sequence[int], gen_lengths: Sequence[int]) -> int:
    """WMA(B) over (L(p), G(p)) pairs — Eq. (4)."""
    if not lengths:
        return 0
    bl = max(lengths)
    bg = max(gen_lengths)
    return max(wma_gen(l, g, bl) + wma_wait(g, bl, bg)
               for l, g in zip(lengths, gen_lengths))


def batch_wma_of(batch: Batch, extra: Optional[Request] = None,
                 predicted: bool = True) -> int:
    reqs = batch.requests + ([extra] if extra is not None else [])
    gl = [(r.predicted_gen_length if predicted and
           r.predicted_gen_length is not None else r.gen_length)
          for r in reqs]
    return batch_wma([r.length for r in reqs], gl)


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Per-instance accelerator memory model (Eq. 1 / Eq. 5), generalized:

    dense/moe/vlm : MEM = beta * (L+G) * delta_kv
    ssm           : MEM = beta * delta_state           (constant per request)
    hybrid        : beta * (min(L+G, W) * delta_kv + delta_state)
    audio         : decoder self-KV grows with G; cross-KV is fixed
    """
    cfg: ModelConfig
    hbm_bytes: int = 16 * 2 ** 30          # v5e HBM per chip
    reserve_frac: float = 0.7              # paper: 70% of free memory
    max_len: int = 1024                    # L_max
    max_gen: int = 1024                    # G_max
    dtype_bytes: int = 2
    param_dtype_bytes: float = 2           # 0.5 for VSQ int4

    @property
    def delta(self) -> int:
        """KV-cache bytes per token (Δ)."""
        return max(self.cfg.kv_bytes_per_token(self.dtype_bytes), 1)

    @property
    def theta(self) -> int:
        """Θ: bytes available for the cache = reserve_frac * (HBM - params).
        The 1-reserve_frac headroom absorbs generation-length prediction
        error (paper §IV-A sets 70% 'to mitigate OOM errors')."""
        params = self.cfg.param_count() * self.param_dtype_bytes
        return max(int(self.reserve_frac * (self.hbm_bytes - params)), 0)

    @property
    def physical_limit(self) -> int:
        """Hard OOM line: all memory beyond params (small workspace slack).
        Planning happens at Θ; *real* OOM only past this."""
        params = self.cfg.param_count() * self.param_dtype_bytes
        return max(int(0.95 * (self.hbm_bytes - params)), 0)

    def request_bytes(self, total_tokens: int) -> int:
        c = self.cfg
        if c.family == "ssm":
            return c.state_bytes(self.dtype_bytes)
        kv = self.delta * total_tokens
        if c.family == "hybrid":
            w = c.sliding_window or total_tokens
            kv = self.delta * min(total_tokens, w) + c.state_bytes(self.dtype_bytes)
        if c.family == "audio":
            kv += (2 * c.num_heads * c.head_dim * c.num_layers
                   * self.dtype_bytes * c.encoder_seq)
        return kv

    def batch_bytes(self, batch_size: int, batch_len: int,
                    batch_gen: int) -> int:
        """MEM(B) — Eq. (5) generalized."""
        return batch_size * self.request_bytes(batch_len + batch_gen)

    def mem_of(self, batch: Batch, extra: Optional[Request] = None,
               predicted: bool = True) -> int:
        reqs = batch.requests + ([extra] if extra is not None else [])
        if not reqs:
            return 0
        bl = max(r.length for r in reqs)
        gl = max((r.predicted_gen_length if predicted and
                  r.predicted_gen_length is not None else r.gen_length)
                 for r in reqs)
        return self.batch_bytes(len(reqs), bl, gl)

    def vanilla_batch_size(self) -> int:
        """Eq. (1): fixed β assuming every request is (L_max, G_max)."""
        per_req = self.request_bytes(self.max_len + self.max_gen)
        return max(1, self.theta // per_req)
