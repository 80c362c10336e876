"""Analytic (roofline) serving-time model.

The paper measures wall-clock on V100s; the cluster simulator
(``repro_torch.sim``) prices LLM batch serving with a two-term roofline
per iteration — compute = FLOPs/peak, memory = bytes/bw — taking the max
(decode is memory-bound: params + KV reread every iteration, which is why
the paper's WMA metric is defined over *memory accesses*).

The same model doubles as the Eq.-(1)/Eq.-(5) memory oracle for batch-size
decisions and is calibrated against the compiled dry-run cost_analysis in
benchmarks (EXPERIMENTS.md §Roofline).

The hardware specs below are the simulator's priced hardware (the
paper's V100 testbed and a TPU v5e), copied from the reference package;
none is a measurement of this port.  There is no H100 spec: its
``efficiency`` would be a calibration that has not been measured.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # bf16 FLOP/s per chip
    hbm_bw: float              # bytes/s per chip
    hbm_bytes: int
    link_bw: float = 50e9      # ICI per link
    host_bw: float = 16e9      # device<->host (PCIe) per chip
    chips: int = 1             # chips per LLM instance
    efficiency: float = 0.55   # sustained fraction of roofline


TPU_V5E = HardwareSpec("tpu-v5e", 197e12, 819e9, 16 * 2 ** 30)
# the paper's testbed GPU (fp16): for paper-faithful replays
V100_32G = HardwareSpec("v100-32g", 112e12, 900e9, 32 * 2 ** 30,
                        efficiency=0.45)


@dataclasses.dataclass(frozen=True)
class CostModel:
    cfg: ModelConfig
    hw: HardwareSpec = TPU_V5E
    dtype_bytes: int = 2           # parameter bytes
    kv_dtype_bytes: int = 2        # cache bytes (paper testbed: fp32 => 4)
    quantized: bool = False        # VSQ: int4 weights
    quant_overhead: float = 2.5    # VSQ dequant penalty: the paper observes
                                   # int4 *slows* V100 inference (§IV-B)

    @property
    def param_bytes(self) -> float:
        b = self.cfg.param_count() * self.dtype_bytes
        return b / 4 if self.quantized else b

    @property
    def active_flops_per_token(self) -> float:
        return 2.0 * self.cfg.active_param_count()

    def _iter_time(self, flops: float, bytes_moved: float) -> float:
        chips = self.hw.chips
        t = max(flops / (chips * self.hw.peak_flops),
                bytes_moved / (chips * self.hw.hbm_bw))
        t /= self.hw.efficiency
        if self.quantized:
            t *= self.quant_overhead
        return t

    # -- phases --------------------------------------------------------------
    def prefill_time(self, batch_size: int, batch_len: int) -> float:
        tokens = batch_size * batch_len
        flops = self.active_flops_per_token * tokens
        # quadratic attention term (full attention archs)
        if self.cfg.family not in ("ssm",):
            w = self.cfg.sliding_window or batch_len
            flops += (2.0 * 2 * batch_size * self.cfg.num_heads
                      * self.cfg.head_dim * batch_len * min(batch_len, w) / 2)
        bytes_moved = self.param_bytes + tokens * self.cfg.d_model * 2 * self.dtype_bytes
        return self._iter_time(flops, bytes_moved)

    def decode_iter_time(self, batch_size: int, ctx: int) -> float:
        """One generation iteration with per-request context ``ctx``."""
        flops = self.active_flops_per_token * batch_size
        kv = self.cfg.kv_bytes_per_token(self.kv_dtype_bytes)
        if self.cfg.sliding_window:
            ctx_eff = min(ctx, self.cfg.sliding_window)
        else:
            ctx_eff = ctx
        bytes_moved = (self.param_bytes
                       + batch_size * (kv * ctx_eff
                                       + self.cfg.state_bytes(self.kv_dtype_bytes)))
        return self._iter_time(flops, bytes_moved)

    def batch_serving_time(self, batch_size: int, batch_len: int,
                           batch_gen: int) -> float:
        """Full padded-batch serving: prefill + G(B) decode iterations.
        Decode integrated in closed form (KV grows linearly)."""
        if batch_gen <= 0:
            return self.prefill_time(batch_size, batch_len)
        t0 = self.decode_iter_time(batch_size, batch_len)
        t1 = self.decode_iter_time(batch_size, batch_len + batch_gen)
        return (self.prefill_time(batch_size, batch_len)
                + batch_gen * (t0 + t1) / 2)
