"""Batch schedulers: HRRN (paper §III-E) and FCFS (baselines).

HRRN response ratio of a batch: T_q(B) / T_s(B), with T_s replaced by the
estimated serving time; the idle instance gets the highest-ratio batch."""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.core.types import Batch


class HRRNScheduler:
    def __init__(self, estimate: Callable[[Batch], float]):
        self.estimate = estimate

    def select(self, queue: List[Batch], now: float) -> Optional[Batch]:
        if not queue:
            return None
        def ratio(b: Batch) -> float:
            ts = max(self.estimate(b), 1e-6)
            return b.queuing_time(now) / ts
        return max(queue, key=ratio)


class FCFSScheduler:
    """First-come-first-served over batches (vanilla baselines; also the
    ABP ablation = adaptive batching without HRRN)."""

    def select(self, queue: List[Batch], now: float) -> Optional[Batch]:
        if not queue:
            return None
        return min(queue, key=lambda b: b.created_time)
