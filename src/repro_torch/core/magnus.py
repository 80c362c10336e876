"""The Magnus service: glue for predictor -> batcher -> estimator -> HRRN
(paper Fig. 7), shared by the discrete-event simulator and the real
engine driver.  Ablation strategies come from the same class:

  VS / VSQ : no prediction, FCFS request batches of fixed beta
  GLP      : + predictor & WMA batching, fixed beta cap
  ABP      : + adaptive batch size (no cap)
  MAGNUS   : + serving-time estimation & HRRN scheduling

Paged variants (beyond-paper; DESIGN.md §8): ``ccb-paged`` and
``magnus-paged`` swap the Eq.-(5) padded reservation for block-granular
accounting (`serving.paged_cache.PagedMemoryModel`) and bind one shared
`BlockAllocator` to both Algorithm-1's memory check and the runtime
(`serving.engine.PagedContinuousEngine`), so planning Θ and the physical
pool are the same object.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.batcher import AdaptiveBatcher, BatcherConfig
from repro_torch.core.estimator import EstimatorConfig, ServingTimeEstimator
from repro_torch.core.predictor import GenerationLengthPredictor, PredictorConfig
from repro_torch.core.scheduler import FCFSScheduler, HRRNScheduler
from repro_torch.core.types import Batch, Request
from repro_torch.core.wma import MemoryModel
from repro_torch.serving.paged_cache import (BlockAllocator,
                                             PagedMemoryModel,
                                             RadixPrefixCache)

STRATEGIES = ("vs", "vsq", "ccb", "glp", "abp", "magnus",
              "ccb-paged", "magnus-paged")


@dataclasses.dataclass
class MagnusConfig:
    strategy: str = "magnus"  # vs | vsq | ccb | glp | abp | magnus | *-paged
    wma_threshold: float = 50_000.0     # Φ
    fixed_batch_size: Optional[int] = None  # None => Eq. (1) for vs/vsq/glp
    continuous_learning: bool = True
    block_tokens: int = 16              # paged strategies: tokens per block
    # paged strategies: instruction prefixes share ref-counted pages via
    # the runtime's token-id radix tree (DESIGN.md §11); Algorithm-1
    # footprints charge shared heads once at longest-common-prefix
    # granularity, mirroring the runtime's RadixPrefixCache
    prefix_sharing: bool = False


class MagnusService:
    def __init__(self, memory: MemoryModel, cfg: Optional[MagnusConfig] = None,
                 predictor: Optional[GenerationLengthPredictor] = None,
                 estimator: Optional[ServingTimeEstimator] = None,
                 seed: int = 0,
                 allocator: Optional[BlockAllocator] = None):
        self.cfg = cfg or MagnusConfig()
        s = self.cfg.strategy
        if s not in STRATEGIES:
            raise ValueError(f"unknown strategy {s!r}; one of {STRATEGIES}")
        self.paged = s.endswith("-paged")
        base = s[:-len("-paged")] if self.paged else s
        self.base_strategy = base
        self.allocator = allocator
        if self.paged:
            # block-size precedence: a caller-supplied allocator dictates
            # it; else a caller-supplied PagedMemoryModel; else the config.
            # Accounting and pool must round at one granularity.
            if self.allocator is not None:
                bt = self.allocator.block_tokens
            elif isinstance(memory, PagedMemoryModel):
                bt = memory.block_tokens
            else:
                bt = self.cfg.block_tokens
            if not isinstance(memory, PagedMemoryModel):
                memory = PagedMemoryModel(memory, block_tokens=bt)
            if self.allocator is None:
                nb = max(1, memory.theta
                         // (memory.block_tokens * memory.base.delta))
                self.allocator = BlockAllocator(nb, memory.block_tokens)
            # planning Θ = the pool the runtime allocates from; with
            # prefix sharing the batcher charges each distinct
            # instruction template's pages once (hit-aware footprints)
            memory = dataclasses.replace(
                memory, block_tokens=bt, allocator=self.allocator,
                prefix_sharing=self.cfg.prefix_sharing)
        self.memory = memory
        # the runtime engine binds to this same radix index so planning
        # and serving agree on which prefixes are resident
        self.prefix_cache = (RadixPrefixCache(self.allocator)
                             if self.paged and self.cfg.prefix_sharing
                             else None)
        # paged admission reserves per-request *predicted* blocks, so every
        # paged strategy needs the predictor (ccb-paged included)
        self.uses_prediction = base in ("glp", "abp", "magnus") or self.paged
        self.uses_hrrn = base == "magnus"
        beta_cap = None
        if base in ("vs", "vsq", "ccb", "glp") and not self.paged:
            beta_cap = (self.cfg.fixed_batch_size
                        or memory.vanilla_batch_size())
        self.beta_cap = beta_cap
        self.predictor = predictor or GenerationLengthPredictor(seed=seed)
        self.estimator = estimator or ServingTimeEstimator()
        self.batcher = AdaptiveBatcher(
            memory, BatcherConfig(wma_threshold=self.cfg.wma_threshold,
                                  max_batch_size=beta_cap))
        self.scheduler = (HRRNScheduler(self._safe_estimate)
                          if self.uses_hrrn else FCFSScheduler())

    def _safe_estimate(self, batch: Batch) -> float:
        try:
            return self.estimator.estimate(batch)
        except RuntimeError:     # estimator not yet fit (cold start)
            return 1.0

    # -- ingress -------------------------------------------------------------
    def on_request(self, req: Request, now: float) -> Batch:
        if self.uses_prediction:
            req.predicted_gen_length = self.predictor.predict(req)
            return self.batcher.insert(req, now)
        # vanilla: FCFS fill of the newest batch up to the fixed beta
        req.predicted_gen_length = self.memory.max_gen
        q = self.batcher.queue
        if q and q[-1].insertable and q[-1].size < (self.beta_cap or 1):
            q[-1].requests.append(req)
            return q[-1]
        nb = Batch(requests=[req], created_time=now)
        q.append(nb)
        return nb

    # -- dispatch ------------------------------------------------------------
    def next_batch(self, now: float) -> Optional[Batch]:
        b = self.scheduler.select(self.batcher.queue, now)
        if b is not None:
            self.batcher.pop(b)
        return b

    def estimate_time(self, batch: Batch) -> float:
        try:
            return self.estimator.estimate(batch)
        except RuntimeError:
            return 1.0

    # -- feedback ------------------------------------------------------------
    def on_batch_done(self, batch: Batch, predicted_time: float,
                      actual_time: float, now: float) -> None:
        if not self.cfg.continuous_learning:
            return
        if self.uses_prediction:
            for r in batch.requests:
                self.predictor.observe(r, now)
        if self.uses_hrrn:
            self.estimator.observe(batch.size, batch.length,
                                   batch.gen_length, predicted_time,
                                   actual_time, now)

    def on_oom(self, batch: Batch, now: float):
        return self.batcher.handle_oom(batch, now)
