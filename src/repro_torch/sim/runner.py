"""Run a (strategy x workload) simulation — the paper's experiment runner.

Strategies: vs | vsq | ccb | glp | abp | magnus   (Figs 10-13),
plus the beyond-paper paged variants ccb-paged | magnus-paged
(block-granular admission accounting; DESIGN.md §8).  With
``prefix_sharing`` the paged variants' Algorithm-1 footprints charge
shared instruction heads once at longest-common-prefix granularity —
the LCP trie in ``PagedMemoryModel.mem_of`` mirrors the runtime's
radix tree (DESIGN.md §11), so batches concentrated on one template
family plan with the same pool headroom the engine actually has.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.estimator import ServingTimeEstimator
from repro_torch.core.magnus import MagnusConfig, MagnusService
from repro_torch.core.predictor import GenerationLengthPredictor
from repro_torch.core.types import Request
from repro_torch.core.wma import MemoryModel
from repro_torch.serving.cost_model import CostModel, HardwareSpec, TPU_V5E
from repro_torch.sim.events import CCBSimulator, ClusterSimulator, Metrics, SimConfig
from repro_torch.workload.apps import make_dataset


class HostSyncCost:
    """CostModel wrapper pricing the engine's per-iteration host round-trip
    (DESIGN.md §9).  ``dispatch="per-token"`` pays one sync per
    decode iteration — the pre-fusion engine; ``dispatch="fused"`` pays one
    per power-of-two window (``popcount(bg)`` windows for a ``bg``-step
    batch, mirroring ``PagedContinuousEngine.step_window``'s chunking);
    ``dispatch="spec"`` prices §16 speculative decoding — each window runs
    ``draft_k`` draft iterations (a ``draft_cost_ratio`` fraction of a
    target iteration each) plus ONE batched verify dispatch covering
    ``draft_k + 1`` positions, and emits ``accepted_per_dispatch()``
    tokens per packed-readback sync, so the cost per emitted token scales
    with 1/accepted-per-dispatch (the §16 headline metric).

    ``admission_dispatches`` prices the batch's *prefill* dispatches the
    same way (DESIGN.md §12): the single-dispatch variable-prefix wave
    pays 1 per admission wave; the pre-§12 per-class split (full-prompt
    misses + suffix hits) paid 2.  With ``host_sync_s=0`` (the default
    everywhere) this wrapper is never constructed and all sim numbers
    are unchanged."""

    # continuous-batching iterations can't see the batch end, so fused
    # windows amortize over a nominal window instead of popcount(bg)
    NOMINAL_WINDOW = 8

    def __init__(self, base: CostModel, host_sync_s: float,
                 dispatch: str = "fused", admission_dispatches: int = 1,
                 draft_k: int = 4, acceptance: float = 0.8,
                 draft_cost_ratio: float = 0.2):
        if dispatch not in ("fused", "per-token", "spec"):
            raise ValueError(f"unknown dispatch {dispatch!r}")
        if not 0.0 <= acceptance <= 1.0:
            raise ValueError(f"acceptance {acceptance} not in [0, 1]")
        self._base = base
        self.host_sync_s = host_sync_s
        self.dispatch = dispatch
        self.admission_dispatches = admission_dispatches
        self.draft_k = draft_k
        self.acceptance = acceptance
        self.draft_cost_ratio = draft_cost_ratio

    def __getattr__(self, name):
        return getattr(self._base, name)

    # -- speculative decoding (DESIGN.md §16) --------------------------------

    def accepted_per_dispatch(self) -> float:
        """Expected tokens emitted per verify dispatch: the accepted
        prefix is geometric in ``acceptance`` over ``draft_k`` proposals,
        plus the target's own token every window — so the floor is 1.0
        (an always-rejecting draft) and the ceiling ``draft_k + 1``
        (self-draft)."""
        a, k = self.acceptance, self.draft_k
        if a >= 1.0:
            return k + 1.0
        return (1.0 - a ** (k + 1)) / (1.0 - a)

    def spec_window_time(self, n_active: int, ctx: float) -> float:
        """Price one speculative window for the whole batch: ``draft_k``
        draft iterations at ``draft_cost_ratio`` of a target iteration,
        one batched verify dispatch — ``draft_k + 1`` positions' worth of
        token FLOPs but the parameter/KV reread paid ONCE (decode is
        memory-bound, which is why verification is nearly free) — and the
        single packed-readback host sync."""
        w = self.draft_k + 1
        base = self._base
        flops = base.active_flops_per_token * n_active * w
        kv = base.cfg.kv_bytes_per_token(base.kv_dtype_bytes)
        ctx_eff = min(ctx, base.cfg.sliding_window) \
            if base.cfg.sliding_window else ctx
        bytes_moved = (base.param_bytes
                       + n_active * (kv * ctx_eff
                                     + base.cfg.state_bytes(
                                         base.kv_dtype_bytes)))
        verify = base._iter_time(flops, bytes_moved)
        draft = (self.draft_k * self.draft_cost_ratio
                 * base.decode_iter_time(n_active, ctx))
        return draft + verify + self.host_sync_s

    def _syncs(self, iters: int) -> int:
        if self.dispatch == "fused":
            return bin(max(int(iters), 0)).count("1")
        if self.dispatch == "spec":
            return -(-max(int(iters), 0) // max(
                int(self.accepted_per_dispatch()), 1))
        return max(int(iters), 0)

    def batch_serving_time(self, beta: int, bl: int, bg: int) -> float:
        return (self._base.batch_serving_time(beta, bl, bg)
                + (self._syncs(bg) + self.admission_dispatches)
                * self.host_sync_s)

    def decode_iter_time(self, n_active: int, ctx: float) -> float:
        if self.dispatch == "spec":
            # amortized per EMITTED token: window cost over the expected
            # accepted prefix — 1/accepted_per_dispatch is the knob the
            # §16 engine counters measure
            return (self.spec_window_time(n_active, ctx)
                    / self.accepted_per_dispatch())
        per_iter = (self.host_sync_s / self.NOMINAL_WINDOW
                    if self.dispatch == "fused" else self.host_sync_s)
        return self._base.decode_iter_time(n_active, ctx) + per_iter

    # -- host KV swap tier (DESIGN.md §15) ----------------------------------
    def swap_transfer_time(self, blocks: int, block_tokens: int) -> float:
        """Price one device<->host page transfer for a ``blocks``-block
        suspension image: a single sync latency (the engine's swap-out does
        exactly one readback) plus the KV pages over the host link."""
        page_bytes = (blocks * block_tokens
                      * self._base.cfg.kv_bytes_per_token(
                          self._base.kv_dtype_bytes))
        return (self.host_sync_s
                + page_bytes / (self._base.hw.chips * self._base.hw.host_bw))

    def resume_cheaper(self, blocks: int, block_tokens: int,
                       prompt_len: int) -> bool:
        """True when swapping a victim back in beats re-prefilling it —
        the §15 invariant the swap tier exists to buy.  Compares one
        host->device scatter against a fresh single-row prefill."""
        return (self.swap_transfer_time(blocks, block_tokens)
                < self._base.prefill_time(1, max(prompt_len, 1)))

    # -- crash recovery (DESIGN.md §17) --------------------------------------

    def recovery_time(self, blocks: int, block_tokens: int,
                      journal_records: int = 0,
                      record_s: float = 10e-6) -> float:
        """Price a §17 restore: scattering a ``blocks``-block pool image
        back to the device costs exactly one host-link transfer (the
        restore path is the swap-in path writ large — one jitted
        scatter, nothing read back), plus a deterministic replay term
        for parsing ``journal_records`` WAL records.  Replayed DECODE
        work is deliberately excluded — it is serving, not recovery
        overhead — and re-prefill is excluded because the snapshot
        covers it (the ``replayed_reprefill_tokens == 0`` invariant)."""
        return (self.swap_transfer_time(blocks, block_tokens)
                + journal_records * record_s)


def _estimator_bootstrap(cost: CostModel, memory: MemoryModel,
                         seed: int = 0) -> ServingTimeEstimator:
    """Train the serving-time KNN on synthetic profiled batches (the paper
    trains on 2,500 held-out requests' serving logs)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(400):
        beta = int(rng.integers(1, 64))
        bl = int(rng.integers(8, memory.max_len))
        bg = int(rng.integers(1, memory.max_gen))
        rows.append((beta, bl, bg, cost.batch_serving_time(beta, bl, bg)))
    return ServingTimeEstimator().fit(rows)


def run_strategy(strategy: str, workload: List[Request], cfg: ModelConfig, *,
                 hw: HardwareSpec = TPU_V5E, n_instances: int = 7,
                 wma_threshold: float = 50_000.0,
                 fixed_batch_size: Optional[int] = None,
                 predictor: Optional[GenerationLengthPredictor] = None,
                 train_requests: Optional[List[Request]] = None,
                 kv_dtype_bytes: int = 2,
                 host_sync_s: float = 0.0, dispatch: str = "fused",
                 admission_dispatches: int = 1,
                 spec_draft_k: int = 4, spec_acceptance: float = 0.8,
                 spec_draft_cost_ratio: float = 0.2,
                 prefix_sharing: bool = False,
                 seed: int = 0) -> Metrics:
    workload = copy.deepcopy(workload)   # sims mutate finish times
    paged = strategy.endswith("-paged")
    base_strategy = strategy[:-len("-paged")] if paged else strategy
    quant = base_strategy == "vsq"
    # int4 weights free memory => larger Eq.-(1) beta (paper: 7 -> 10)
    memory = MemoryModel(cfg, hbm_bytes=hw.hbm_bytes * hw.chips,
                         dtype_bytes=kv_dtype_bytes,
                         param_dtype_bytes=0.5 if quant else 2)
    if memory.theta <= 0:
        raise ValueError(
            f"{cfg.name} params do not fit a {hw.chips}-chip {hw.name} "
            f"instance; raise HardwareSpec.chips")
    cost = CostModel(cfg, hw, quantized=quant, kv_dtype_bytes=kv_dtype_bytes)
    if host_sync_s > 0.0:
        cost = HostSyncCost(cost, host_sync_s, dispatch,
                            admission_dispatches=admission_dispatches,
                            draft_k=spec_draft_k,
                            acceptance=spec_acceptance,
                            draft_cost_ratio=spec_draft_cost_ratio)
    if strategy == "ccb":
        limit = fixed_batch_size or MemoryModel(
            cfg, hbm_bytes=hw.hbm_bytes * hw.chips,
            dtype_bytes=kv_dtype_bytes).vanilla_batch_size()
        return CCBSimulator(cost, n_instances=n_instances,
                            parallel_limit=limit).run(workload)
    svc_cfg = MagnusConfig(strategy=strategy, wma_threshold=wma_threshold,
                           fixed_batch_size=fixed_batch_size,
                           prefix_sharing=prefix_sharing and paged)
    if predictor is None and (paged
                              or base_strategy in ("glp", "abp", "magnus")):
        predictor = GenerationLengthPredictor(seed=seed).fit(
            train_requests or make_dataset(150, seed=seed + 1))
    svc = MagnusService(memory, svc_cfg, predictor=predictor,
                        estimator=_estimator_bootstrap(cost, memory, seed))
    sim_cfg = SimConfig(n_instances=n_instances,
                        gen_scale=1.15 if quant else 1.0)
    sim = ClusterSimulator(svc, cost, sim_cfg)
    return sim.run(workload)


def run_all(workload: List[Request], cfg: ModelConfig,
            strategies=("vs", "vsq", "ccb", "glp", "abp", "magnus"),
            **kw) -> Dict[str, Metrics]:
    return {s: run_strategy(s, workload, cfg, **kw) for s in strategies}
