"""Deterministic fault injection for the paged serving engine (the
reference package's ``serving/faults.py``).

The Magnus admission story rests on *predicted* generation lengths
(PAPER.md §3): a misprediction must degrade into bounded evictions and
adaptive reservations, never into a hang, a crash, or stranded KV
blocks.  This module provides the seams that prove it (DESIGN.md §14):
a scripted, seeded :class:`FaultInjector` the engine consults at window
boundaries, plus the typed :class:`Shed` record serve loops emit when a
request is dropped instead of served.

Fault kinds (each a :class:`FaultEvent` on the plan):

``pool_shrink``
    Steal up to ``blocks`` free blocks from the engine's allocator under
    the reserved ``FAULT_SEQ`` sequence id — the engine experiences a
    smaller pool (allocator exhaustion) without any bookkeeping
    corruption.  ``pool_restore`` frees them again.
``predict_skew``
    Multiply every subsequent admission's predicted generation length by
    ``factor`` for ``app`` (``None`` = all apps): ``factor=0.25`` is a
    ×4 under-prediction storm, ``factor=4`` over-predicts.
``poison_logits``
    Overwrite one active slot's logits row with NaN before the next
    decode window — the engine's NaN/Inf guard must quarantine exactly
    that slot and keep every surviving stream bit-exact.
``poison_draft_logits``
    Overwrite one active slot's *draft* logits row with NaN before the
    next speculative window — the engine's draft guard must quarantine
    the slot's draft (cold draft: proposals stop, verification carries
    the stream) without touching the verified target stream
    (DESIGN.md §16).  A no-op on a spec-off engine.
``stall``
    Burn ``ticks`` scheduler-clock ticks without decoding (a stalled
    window): deadline/TTL accounting must advance, streams must not.
``radix_corrupt``
    Probe a rogue write into a cache-held radix block through the
    shadow-allocator path: with ``REPRO_SANITIZE=1`` the shadow raises
    ``SharedWriteError`` (the corruption is *blocked* and counted);
    without the shadow the probe is a recorded no-op.
``swap_stall``
    Delay host-tier transfers: the next ``ticks`` swap-in attempts are
    refused (the transfer "has not completed"), so suspended requests
    stay resident on host and resume later — streams must still be
    bit-exact, only latency may grow (DESIGN.md §15).
``host_pressure``
    Shrink the host swap tier by ``blocks`` page slots — swap-outs that
    no longer fit must fall back to the destructive evict path, never
    corrupt a suspended image.  A second event with ``blocks<=0``
    restores the original capacity.
``crash``
    Hard-stop the engine by raising :class:`EngineCrash` at the named
    ``seam`` (one of :data:`SEAMS`: ``"wave"`` — after a wave is
    reserved but before its batched prefill, ``"window"`` — after the
    window prologue but before the fused decode dispatch, ``"swap"`` —
    before a victim's pages are read back to host, ``"publish"`` — with
    radix publishes still queued) at the first time that seam is
    reached with ``engine.windows >= window``.  The kill-and-recover
    harness (DESIGN.md §17, ``tests/test_torch_recovery.py`` and
    ``chip_smoke.py`` phase 17) catches the raise, drops the crashed
    engine, and brings the run to completion through
    ``serving.snapshot.recover``: the last snapshot plus a replay of the
    write-ahead journal.

The injector is zero-cost when absent: the engine checks
``self.faults is not None`` exactly like the sanitizer checks
``REPRO_SANITIZE`` — a fault-free engine takes no new branches inside
the fused decode loop.

>>> ev = FaultEvent(window=2, kind="pool_shrink", blocks=3)
>>> FaultInjector([ev]).plan[0].kind
'pool_shrink'
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.sanitizer import SharedWriteError
from repro_torch.core.types import SHED_REASONS, ShedReason

__all__ = ["FAULT_SEQ", "KINDS", "SEAMS", "SHED_REASONS", "ShedReason",
           "EngineCrash", "FaultEvent", "Shed", "FaultInjector"]

#: allocator seq_id owning fault-held (shrunk-pool) blocks; distinct from
#: serving.paged_cache.NULL_SEQ (-1) so drain checks can tell a leaked
#: engine table from an unreleased fault plan
FAULT_SEQ = -2

KINDS = ("pool_shrink", "pool_restore", "predict_skew", "poison_logits",
         "poison_draft_logits", "stall", "radix_corrupt", "swap_stall",
         "host_pressure", "crash")

#: engine seams a ``crash`` event can hard-stop at (DESIGN.md §17)
SEAMS = ("wave", "window", "swap", "publish")


class EngineCrash(RuntimeError):
    """A scripted ``crash`` event fired: the engine process is dead.

    Raised *through* the serve loop on purpose — nothing between the seam
    and the harness may catch it, exactly like a SIGKILL.  Recovery is
    a fresh engine restored from the last snapshot plus journal replay
    (``repro_torch.serving.snapshot.recover``)."""

    def __init__(self, seam: str, window: int):
        super().__init__(f"scripted crash at seam {seam!r} "
                         f"(window {window})")
        self.seam = seam
        self.window = window


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: fires at the first ``step_window`` call whose
    1-based index is >= ``window`` (``predict_skew`` additionally
    activates at admission time, so a window-0 skew corrupts the very
    first reservation)."""
    window: int
    kind: str
    blocks: int = 0                  # pool_shrink: blocks to steal
    app: Optional[str] = None        # predict_skew: app (None = all)
    factor: float = 1.0              # predict_skew: multiplier on G'(p)
    slot: Optional[int] = None       # poison_logits: slot (None = first)
    ticks: int = 0                   # stall: clock ticks to burn
    seam: Optional[str] = None       # crash: engine seam to die at

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.kind == "crash" and self.seam not in SEAMS:
            raise ValueError(f"crash needs seam in {SEAMS}, "
                             f"got {self.seam!r}")


@dataclasses.dataclass
class Shed:
    """A request dropped instead of served — the typed load-shed result.
    ``clock`` is the engine's scheduler clock (decode iterations plus
    stall ticks) at the moment of the drop."""
    req: object
    reason: str
    clock: int = 0

    def __post_init__(self):
        if self.reason not in SHED_REASONS:
            raise ValueError(f"unknown shed reason {self.reason!r}; "
                             f"one of {SHED_REASONS}")


class FaultInjector:
    """Replays a scripted fault plan against a ``PagedContinuousEngine``.

    The engine calls :meth:`before_window` at the top of every
    ``step_window`` (firing due events, returning stall ticks) and
    :meth:`corrupt_prediction` inside ``reserve_tokens``.  All state is
    derived from the plan — two runs of the same plan against the same
    workload are bit-identical, which is what lets the chaos harness
    assert surviving streams against a fault-free reference run.
    """

    def __init__(self, plan: List[FaultEvent], seed: int = 0):
        self.plan = sorted(plan, key=lambda e: e.window)
        self.seed = seed
        self._idx = 0
        # window-fired events; crash events fire at seams, not windows
        self._events = [e for e in self.plan if e.kind != "crash"]
        self._crash_plan = [e for e in self.plan if e.kind == "crash"]
        self._crashed: set = set()   # indices into _crash_plan already fired
        self._skew_plan = [e for e in self.plan if e.kind == "predict_skew"]
        self._sidx = 0
        self._skew: Dict[Optional[str], float] = {}
        self.held_blocks = 0
        self.fired: List[Tuple[int, str]] = []   # (window, kind) log
        # counters (surfaced next to the engine's robustness counters)
        self.corrupted_predictions = 0
        self.poisoned = 0
        self.draft_poisoned = 0
        self.stalled_ticks = 0
        self.radix_corruptions_blocked = 0
        self.radix_probes_unchecked = 0
        self.swap_stalls = 0
        self._swap_stall_budget = 0
        self.host_pressure_events = 0
        self.crashes = 0

    # -- admission seam ------------------------------------------------------

    def corrupt_prediction(self, req, g: int, window: int) -> int:
        """Apply any active prediction skew to ``g`` for ``req``.  Skew
        events whose window has been reached activate here too, so a
        plan can corrupt predictions before the first decode window."""
        while (self._sidx < len(self._skew_plan)
               and self._skew_plan[self._sidx].window <= window):
            ev = self._skew_plan[self._sidx]
            self._sidx += 1
            self._skew[ev.app] = ev.factor
        f = self._skew.get(req.app, self._skew.get(None))
        if f is None or f == 1.0:
            return g
        self.corrupted_predictions += 1
        return max(1, int(g * f))

    # -- window seam ---------------------------------------------------------

    def before_window(self, engine) -> int:
        """Fire every event due at ``engine.windows``; returns stall
        ticks the engine must burn instead of decoding this window."""
        stall = 0
        while (self._idx < len(self._events)
               and self._events[self._idx].window <= engine.windows):
            ev = self._events[self._idx]
            self._idx += 1
            self.fired.append((engine.windows, ev.kind))
            if ev.kind == "pool_shrink":
                self._shrink(engine.allocator, ev.blocks)
            elif ev.kind == "pool_restore":
                self.release(engine.allocator)
            elif ev.kind == "predict_skew":
                self._skew[ev.app] = ev.factor
            elif ev.kind == "poison_logits":
                self._poison(engine, ev.slot)
            elif ev.kind == "poison_draft_logits":
                self._poison_draft(engine, ev.slot)
            elif ev.kind == "stall":
                stall += ev.ticks
                self.stalled_ticks += ev.ticks
            elif ev.kind == "radix_corrupt":
                self._radix_corrupt(engine)
            elif ev.kind == "swap_stall":
                self._swap_stall_budget += ev.ticks
            elif ev.kind == "host_pressure":
                self._host_pressure(engine, ev.blocks)
        return stall

    # -- crash seams (DESIGN.md §17) -----------------------------------------

    def crash_due(self, seam: str, window: int) -> None:
        """Raise :class:`EngineCrash` if a not-yet-fired ``crash`` event
        targets ``seam`` with its window reached.  Each event fires at
        most once, so the recovered engine (driven with a fresh injector
        or none at all) replays past the seam."""
        for i, ev in enumerate(self._crash_plan):
            if i in self._crashed or ev.seam != seam or ev.window > window:
                continue
            self._crashed.add(i)
            self.crashes += 1
            self.fired.append((window, "crash"))
            raise EngineCrash(seam=seam, window=window)

    # -- swap-tier seams -----------------------------------------------------

    def swap_stalled(self) -> bool:
        """The engine asks before every swap-in attempt: while the stall
        budget set by a ``swap_stall`` event lasts, the transfer is refused
        (and the attempt consumes one budget tick)."""
        if self._swap_stall_budget <= 0:
            return False
        self._swap_stall_budget -= 1
        self.swap_stalls += 1
        return True

    def _host_pressure(self, engine, blocks: int) -> None:
        tier = getattr(engine, "swap", None)
        if tier is None:
            return                      # no swap tier configured; no-op
        if blocks > 0:
            tier.shrink(blocks)
        else:
            tier.restore()
        self.host_pressure_events += 1

    def _shrink(self, allocator, blocks: int) -> None:
        n = min(blocks, len(allocator.free))
        if n <= 0:
            return
        have = len(allocator.tables.get(FAULT_SEQ, ()))
        allocator.allocate(FAULT_SEQ, (have + n) * allocator.block_tokens)
        self.held_blocks += n

    def release(self, allocator) -> None:
        """Free every fault-held block (``pool_restore``; chaos tests
        also call this before drain assertions so an unrestored plan
        cannot masquerade as an engine leak)."""
        if allocator.tables.get(FAULT_SEQ):
            allocator.free_seq(FAULT_SEQ)
        self.held_blocks = 0

    def _poison(self, engine, slot: Optional[int]) -> None:
        if slot is None or slot >= len(engine.active) \
                or engine.active[slot] is None:
            slot = next((s for s, a in enumerate(engine.active)
                         if a is not None), None)
        if slot is None:
            return                      # nothing active; event is a no-op
        # in place: a captured decode graph reads this very tensor
        engine.logits[slot] = float("nan")
        self.poisoned += 1

    def _poison_draft(self, engine, slot: Optional[int]) -> None:
        if getattr(engine, "draft_logits", None) is None:
            return                      # spec decode off; event is a no-op
        if slot is None or slot >= len(engine.active) \
                or engine.active[slot] is None:
            slot = next((s for s, a in enumerate(engine.active)
                         if a is not None), None)
        if slot is None:
            return                      # nothing active; event is a no-op
        engine.draft_logits[slot] = float("nan")
        self.draft_poisoned += 1

    def _radix_corrupt(self, engine) -> None:
        """Rogue write into a cache-held radix block, routed through the
        shadow allocator: the sanitizer must *block* it (SharedWriteError
        caught here, counted) — engine state is never actually mutated,
        so the degradation contract can assert both "corruption detected"
        and "streams unaffected" from one plan."""
        shadow = getattr(engine.allocator, "_shadow", None)
        cache = getattr(engine, "prefix_cache", None)
        if cache is not None:
            engine._flush_publishes()
        retained = cache.retained_blocks() if cache is not None else []
        if shadow is None or not retained:
            self.radix_probes_unchecked += 1
            return
        try:
            shadow.check_write(FAULT_SEQ, retained[:1])
        except SharedWriteError:
            self.radix_corruptions_blocked += 1
            return
        self.radix_probes_unchecked += 1

    # -- reporting -----------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        return {"fired": len(self.fired),
                "held_blocks": self.held_blocks,
                "corrupted_predictions": self.corrupted_predictions,
                "poisoned": self.poisoned,
                "draft_poisoned": self.draft_poisoned,
                "stalled_ticks": self.stalled_ticks,
                "radix_corruptions_blocked": self.radix_corruptions_blocked,
                "radix_probes_unchecked": self.radix_probes_unchecked,
                "swap_stalls": self.swap_stalls,
                "host_pressure_events": self.host_pressure_events,
                "crashes": self.crashes}
