"""Discrete-event cluster simulator (paper §IV testbed: N LLM instances
served from one queue).

Two engine models:

- *padded batch* (VS / VSQ / GLP / ABP / Magnus): a batch is served start-
  to-finish; serving time priced by the roofline CostModel on the TRUE
  generation lengths; OOM happens when the true KV footprint crosses Θ
  mid-flight (prediction error), costing the time served so far plus a
  model reload, with Magnus's split-in-two recovery.
- *continuous batching* (CCB): per-instance active set with a parallelism
  cap; joining requests pause decoding for their (conservative) prefill —
  the paper's CCB baseline.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.magnus import MagnusService
from repro_torch.core.types import SHED_REASONS, Batch, Request
from repro_torch.serving.cost_model import CostModel


@dataclasses.dataclass
class Metrics:
    completed: int = 0
    response_times: List[float] = dataclasses.field(default_factory=list)
    total_tokens: int = 0          # includes invalid tokens (request waiting)
    valid_tokens: int = 0
    wma_total: int = 0
    oom_events: int = 0
    duration: float = 0.0
    batch_sizes: List[int] = dataclasses.field(default_factory=list)
    # robustness counters (DESIGN.md §14) — zero in fault-free runs, so
    # fault-free summaries stay comparable across commits
    shed: int = 0
    deadline_misses: int = 0
    quarantined: int = 0
    retries: int = 0
    #: per-reason shed breakdown, keyed by ``ShedReason`` values (§14/§15)
    shed_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)

    def record_shed(self, reason) -> None:
        """Tally one shed request under its typed reason.

        ``reason`` is a :class:`repro_torch.core.types.ShedReason` (or its string
        value) — the same enum the engine's ``Shed`` records and
        ``drive_paged`` reports, so sim and runtime breakdowns are keyed
        identically."""
        value = getattr(reason, "value", reason)
        if value not in SHED_REASONS:
            raise ValueError(f"unknown shed reason {reason!r}; "
                             f"expected one of {SHED_REASONS}")
        self.shed += 1
        self.shed_reasons[value] = self.shed_reasons.get(value, 0) + 1

    @property
    def request_throughput(self) -> float:
        return self.completed / max(self.duration, 1e-9)

    @property
    def token_throughput(self) -> float:
        return self.total_tokens / max(self.duration, 1e-9)

    @property
    def valid_token_throughput(self) -> float:
        return self.valid_tokens / max(self.duration, 1e-9)

    @property
    def avg_response_time(self) -> float:
        return float(np.mean(self.response_times)) if self.response_times else 0.0

    @property
    def p95_response_time(self) -> float:
        return float(np.percentile(self.response_times, 95)) \
            if self.response_times else 0.0

    def summary(self) -> dict:
        return {
            "completed": self.completed,
            "request_tp": round(self.request_throughput, 4),
            "token_tp": round(self.token_throughput, 1),
            "valid_token_tp": round(self.valid_token_throughput, 1),
            "avg_rt": round(self.avg_response_time, 2),
            "p95_rt": round(self.p95_response_time, 2),
            "oom": self.oom_events,
            "mean_batch": round(float(np.mean(self.batch_sizes)), 2)
            if self.batch_sizes else 0.0,
            "shed": self.shed,
            "shed_reasons": dict(self.shed_reasons),
            "deadline_misses": self.deadline_misses,
            "quarantined": self.quarantined,
            "retries": self.retries,
        }


@dataclasses.dataclass
class SimConfig:
    n_instances: int = 7
    reload_time: float = 30.0      # OOM: empty memory + reload the LLM
    drain: bool = True             # keep serving queued work after last arrival
    gen_scale: float = 1.0         # VSQ quality degradation (longer outputs)


class ClusterSimulator:
    """Batch-level policies (everything except CCB)."""

    def __init__(self, service: MagnusService, cost: CostModel,
                 cfg: Optional[SimConfig] = None):
        self.service = service
        self.cost = cost
        self.cfg = cfg or SimConfig()

    def run(self, workload: List[Request]) -> Metrics:
        m = Metrics()
        svc, cost, cfg = self.service, self.cost, self.cfg
        theta = svc.memory.physical_limit   # planning is at Θ; OOM is physical
        idle: List[int] = list(range(cfg.n_instances))
        events: List[Tuple[float, int, str, object]] = []
        seq = itertools.count()
        for r in workload:
            heapq.heappush(events, (r.arrival_time, next(seq), "arrival", r))
        end_of_arrivals = workload[-1].arrival_time if workload else 0.0
        now = 0.0

        def gen_len(r: Request) -> int:
            return max(1, int(round(r.gen_length * cfg.gen_scale)))

        def dispatch():
            while idle and len(svc.batcher.queue) > 0:
                b = svc.next_batch(now)
                if b is None:
                    break
                inst = idle.pop()
                est = svc.estimate_time(b)
                bl = b.length
                bg = max(gen_len(r) for r in b.requests)
                true_mem = svc.memory.batch_bytes(b.size, bl, bg)
                if true_mem > theta:
                    # find the iteration where the cache crosses Θ
                    lo, hi = 0, bg
                    while lo < hi:
                        mid = (lo + hi) // 2
                        if svc.memory.batch_bytes(b.size, bl, mid) > theta:
                            hi = mid
                        else:
                            lo = mid + 1
                    t_spent = cost.batch_serving_time(b.size, bl, lo)
                    t = t_spent + cfg.reload_time
                    heapq.heappush(events, (now + t, next(seq), "oom",
                                            (inst, b, est, t)))
                else:
                    t = cost.batch_serving_time(b.size, bl, bg)
                    heapq.heappush(events, (now + t, next(seq), "done",
                                            (inst, b, est, t)))

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if kind == "arrival":
                svc.on_request(payload, now)
                dispatch()
            elif kind == "done":
                inst, b, est, t = payload
                bg = max(gen_len(r) for r in b.requests)
                for r in b.requests:
                    r.finish_time = now
                    m.completed += 1
                    m.response_times.append(r.response_time)
                    m.valid_tokens += gen_len(r)
                m.total_tokens += b.size * bg
                m.batch_sizes.append(b.size)
                from repro_torch.core.wma import batch_wma
                m.wma_total += batch_wma([r.length for r in b.requests],
                                         [gen_len(r) for r in b.requests])
                svc.on_batch_done(b, est, t, now)
                idle.append(inst)
                dispatch()
            elif kind == "oom":
                inst, b, est, t = payload
                m.oom_events += 1
                if b.size <= 1:
                    # a single request that cannot fit: return truncated
                    # output (engines stream what was generated) instead of
                    # splitting forever
                    for r in b.requests:
                        r.finish_time = now
                        m.completed += 1
                        m.response_times.append(r.response_time)
                else:
                    svc.on_oom(b, now)
                idle.append(inst)
                dispatch()
        m.duration = max(now, end_of_arrivals)
        return m


class CCBSimulator:
    """Conservative continuous batching (paper baseline): per-instance
    active sets capped at ``parallel_limit``; a joining request pauses the
    whole instance for its prefill; finished requests return immediately."""

    def __init__(self, cost: CostModel, n_instances: int = 7,
                 parallel_limit: int = 7, join_overhead: float = 0.75):
        self.cost = cost
        self.n = n_instances
        self.limit = parallel_limit
        # per-join stall beyond the raw prefill: the paper's conservative
        # huggingface-based CCB rebuilds past_key_values / re-pads the whole
        # active set on every join (calibrated to Fig 10's CCB/VS token-
        # throughput ratio; see DESIGN.md assumptions log).
        self.join_overhead = join_overhead

    def run(self, workload: List[Request]) -> Metrics:
        m = Metrics()
        cost = self.cost
        # instance state: list of [req, generated(float), pause_until]
        active: List[List] = [[] for _ in range(self.n)]
        seg_start = [0.0] * self.n
        version = [0] * self.n
        pending: List[Request] = []
        events: List[Tuple[float, int, str, object]] = []
        seq = itertools.count()
        for r in workload:
            heapq.heappush(events, (r.arrival_time, next(seq), "arrival", r))
        now = 0.0

        def iter_time(inst: int) -> float:
            acts = active[inst]
            n_act = len(acts)
            ctx = np.mean([a[0].length + a[1] for a in acts]) if acts else 0
            return cost.decode_iter_time(max(n_act, 1), float(ctx))

        def advance(inst: int):
            """Credit tokens generated since seg_start at the segment rate."""
            if not active[inst]:
                return
            it = iter_time(inst)
            steps = max(0.0, (now - seg_start[inst]) / max(it, 1e-12))
            for a in active[inst]:
                a[1] = min(a[0].gen_length, a[1] + steps)
            seg_start[inst] = now

        def schedule_finish(inst: int):
            version[inst] += 1
            if not active[inst]:
                return
            it = iter_time(inst)
            rem = min(a[0].gen_length - a[1] for a in active[inst])
            t = now + max(rem, 0.0) * it
            heapq.heappush(events, (t, next(seq), "finish",
                                    (inst, version[inst])))

        def join(inst: int, r: Request):
            advance(inst)
            acts = active[inst]
            kv_bytes = sum((a[0].length + a[1]) for a in acts) \
                * cost.cfg.kv_bytes_per_token(cost.kv_dtype_bytes)
            rebuild = 2 * kv_bytes / (cost.hw.chips * cost.hw.hbm_bw)
            pause = (cost.prefill_time(1, r.length) + rebuild
                     + self.join_overhead)
            active[inst].append([r, 0.0, 0.0])
            # conservative join: everyone stalls for the prefill
            seg_start[inst] = now + pause
            m.total_tokens += 0
            schedule_finish(inst)

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if kind == "arrival":
                r = payload
                cands = [i for i in range(self.n)
                         if len(active[i]) < self.limit]
                if cands:
                    inst = min(cands, key=lambda i: len(active[i]))
                    join(inst, r)
                else:
                    pending.append(r)
            elif kind == "finish":
                inst, ver = payload
                if ver != version[inst]:
                    continue                      # stale
                advance(inst)
                done = [a for a in active[inst]
                        if a[1] >= a[0].gen_length - 1e-6]
                active[inst] = [a for a in active[inst]
                                if a[1] < a[0].gen_length - 1e-6]
                for a in done:
                    r = a[0]
                    r.finish_time = now
                    m.completed += 1
                    m.response_times.append(r.response_time)
                    m.valid_tokens += r.gen_length
                    m.total_tokens += r.gen_length   # CCB: no invalid tokens
                while pending and len(active[inst]) < self.limit:
                    join(inst, pending.pop(0))
                schedule_finish(inst)
        m.duration = now
        return m
