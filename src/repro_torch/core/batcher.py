"""WMA-directed adaptive batcher — paper Algorithm 1 + OOM-split recovery.

On request arrival: scan the waiting queue, compute WMA(B ∪ {p}) with the
*predicted* generation length, track the minimum-WMA batch whose estimated
memory MEM(B ∪ {p}) fits Θ; insert there if the minimum is below the
threshold Φ, else open a new batch.  On an OOM report: split the batch
evenly in two, mark both uninsertable, requeue.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.types import Batch, Request
from repro_torch.core.wma import MemoryModel, batch_wma_of


@dataclasses.dataclass
class BatcherConfig:
    wma_threshold: float = 50_000.0   # Φ (paper §IV-B)
    max_batch_size: Optional[int] = None  # GLP ablation: cap β (e.g. 7)
    radix_aware: bool = False         # order dispatched batches for §12 waves
    block_tokens: int = 16            # engine block size for suffix buckets


def order_admission_queue(requests: List[Request],
                          block_tokens: int = 16) -> List[Request]:
    """Order a dispatch batch so radix-aware waves admit cheaply
    (DESIGN.md §12).

    Same-template requests (identical ``(app, task, instruction)``) are
    grouped adjacently in first-seen template order, so each radix chain
    lands in ONE admission wave — the wave's publisher prefills the full
    prompt once and every follower shares its just-claimed chain instead
    of re-prefilling the template in a later wave.  Within a template
    group, requests are sub-ordered by the power-of-two block bucket of
    their prompt length: the engine pads each wave's suffixes to one
    bucket per dispatch, so same-bucket suffixes coalesce into a single
    prefill call.  The sort is stable — arrival order breaks all ties —
    and never adds or drops a request.
    """
    first_seen: dict = {}
    for r in requests:
        first_seen.setdefault((r.app, r.task, r.instruction),
                              len(first_seen))

    def key(r: Request):
        blocks = -(-max(int(r.length), 1) // max(block_tokens, 1))
        return (first_seen[(r.app, r.task, r.instruction)],
                (blocks - 1).bit_length())

    return sorted(requests, key=key)


class AdaptiveBatcher:
    def __init__(self, memory: MemoryModel,
                 config: Optional[BatcherConfig] = None):
        self.memory = memory
        self.cfg = config or BatcherConfig()
        self.queue: List[Batch] = []

    def insert(self, req: Request, now: float) -> Batch:
        """Algorithm 1. Returns the batch the request landed in."""
        phi = float("inf")
        target: Optional[Batch] = None
        for b in self.queue:
            if not b.insertable:
                continue
            if (self.cfg.max_batch_size is not None
                    and b.size >= self.cfg.max_batch_size):
                continue
            if self.memory.mem_of(b, extra=req) > self.memory.theta:
                continue                       # would OOM: skip B
            w = batch_wma_of(b, extra=req)
            if w < phi:
                phi, target = w, b
        if target is not None and phi < self.cfg.wma_threshold:
            target.requests.append(req)
            return target
        nb = Batch(requests=[req], created_time=now)
        self.queue.append(nb)
        return nb

    def pop(self, batch: Batch) -> None:
        """Remove a batch at dispatch time.  With ``radix_aware`` the
        batch's requests are reordered in place (:func:`
        order_admission_queue`) so the engine's ``join_many`` sees each
        radix chain as one publisher-plus-followers wave with coalesced
        suffix buckets — fewer prefill dispatches for the same tokens."""
        self.queue.remove(batch)
        if self.cfg.radix_aware:
            batch.requests[:] = order_admission_queue(
                batch.requests, self.cfg.block_tokens)

    def handle_oom(self, batch: Batch, now: float) -> Tuple[Batch, Batch]:
        """Even split, both halves uninsertable, back to the queue."""
        half = max(1, batch.size // 2)
        b1 = Batch(requests=batch.requests[:half], created_time=now,
                   insertable=False)
        b2 = Batch(requests=batch.requests[half:], created_time=now,
                   insertable=False)
        self.queue.extend([b for b in (b1, b2) if b.requests])
        return b1, b2

    def __len__(self) -> int:
        return len(self.queue)
