"""Shared request/batch datatypes for the serving stack."""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional

_ids = itertools.count()


class ShedReason(str, enum.Enum):
    """Typed load-shed reasons — the single source of truth shared by
    ``serving.faults.Shed``, ``drive_paged`` and the sim metrics, so a
    new reason cannot silently diverge between layers (DESIGN.md §14).

    ``str``-valued so members compare equal to the plain strings the
    drivers and stats dicts already use (``"oom" in SHED_REASONS``).
    """
    DEADLINE = "deadline"            # ttl_steps expired on the clock
    RETRY_BUDGET = "retry_budget"    # eviction-retry budget exhausted
    QUEUE_FULL = "queue_full"        # bounded admission queue overflow
    ADMISSION_STALLED = "admission_stalled"  # no progress for stall_limit
    OOM = "oom"                      # PoolExhausted culprit
    SWAPPED_TIMEOUT = "swapped_timeout"  # suspended to host, never resumed
    JOURNAL_EXPIRED = "journal_expired"  # journaled, but TTL elapsed across
    #                                      crash downtime before replay (§17)


#: validated reason strings, in declaration order (``Shed.reason``)
SHED_REASONS = tuple(r.value for r in ShedReason)


@dataclasses.dataclass
class Request:
    app: str                      # application id (e.g. "mt")
    task: str                     # task id (e.g. "mt:en-de")
    instruction: str              # instruction text prefix
    user_input: str               # raw user input text
    arrival_time: float = 0.0
    # token-level quantities
    length: int = 0               # request length L(p): instruction + input
    user_input_length: int = 0    # UIL
    gen_length: int = 0           # ground-truth G(p) (scripted replay)
    predicted_gen_length: Optional[int] = None
    # lifecycle
    finish_time: Optional[float] = None
    # per-request deadline in engine scheduler-clock ticks (decode
    # iterations + stall ticks), counted from admission; None defers to
    # the engine's default_ttl (DESIGN.md §14)
    ttl_steps: Optional[int] = None
    req_id: int = dataclasses.field(default_factory=lambda: next(_ids))

    @property
    def response_time(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time


@dataclasses.dataclass
class Batch:
    requests: List[Request] = dataclasses.field(default_factory=list)
    created_time: float = 0.0
    insertable: bool = True       # OOM-split batches become uninsertable
    batch_id: int = dataclasses.field(default_factory=lambda: next(_ids))

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def length(self) -> int:
        """L(B) = max request length (padding target)."""
        return max((r.length for r in self.requests), default=0)

    @property
    def gen_length(self) -> int:
        """G(B) from ground truth (engine/metrics use)."""
        return max((r.gen_length for r in self.requests), default=0)

    @property
    def predicted_gen_length(self) -> int:
        """G'(B) = max predicted generation length."""
        return max((r.predicted_gen_length or 0 for r in self.requests),
                   default=0)

    def queuing_time(self, now: float) -> float:
        """T_q(B): longest queuing time among requests (paper §III-E)."""
        return max((now - r.arrival_time for r in self.requests), default=0.0)
