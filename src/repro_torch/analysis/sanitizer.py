"""Runtime serve-sanitizer (DESIGN.md §13), the reference package's
``analysis/sanitizer.py``: opt-in invariant enforcement, enabled with
``REPRO_SANITIZE=1`` and zero-cost when disabled.

* :func:`hot_path` marks functions that must stay free of implicit
  device-to-host syncs;
* :func:`count_sync` is called at every intentional readback, so the
  engine's ``host_syncs`` counter is incremented at exactly the sites
  the reference counts; under ``REPRO_SANITIZE=1`` it also tallies the
  (file, function) call site in a ledger (:func:`sync_ledger`);
* :func:`count_host_reads` counts the tensor values that code reads on
  the host, so a test can show that a path has none to count;
* a :class:`ShadowAllocator` mirrors ``BlockAllocator`` bookkeeping with
  *holder identity* (a seq, the radix cache, the host swap tier), so
  double-frees, re-allocation of held blocks, and writes into shared or
  swap-held blocks raise with a provenance trace;
* :func:`check_allocator` and :func:`check_engine_drained` audit the
  allocator's refcounts against the block tables, the radix cache's
  retained set and the swap tier's device holds at teardown, sanitizer
  on or off.

:func:`check_sync_ledger` compares the ledger with the static
``# hotlint: sync`` sites of the port's lint,
``repro_torch.analysis.hotlint.collect_sync_sites`` (as the reference's
compares with its own lint's).

>>> s = ShadowAllocator()
>>> s.on_allocate(0, [3])
>>> s.on_retain([3], CACHE_HOLDER)
>>> s.on_release([3], 0)
>>> s.holders
{3: ['cache']}
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict, Iterator, List, Set, Tuple

import torch

#: holder tag the radix prefix cache uses for its retained references
CACHE_HOLDER = "cache"

#: holder tag the host swap tier uses for device blocks it keeps alive
#: while a host copy of their contents exists (DESIGN.md §15): the hold
#: certifies the block immutable, so writes into it are violations
SWAP_HOLDER = "swap"


def sanitize_enabled() -> bool:
    """True when the process runs with ``REPRO_SANITIZE=1`` (or any non-0)."""
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def hot_path(fn):
    """Marker: ``fn`` must stay free of implicit host syncs.  Pure
    annotation — returns ``fn`` unchanged."""
    return fn


@contextlib.contextmanager
def count_host_reads() -> Iterator[Dict[str, int]]:
    """Count, in ``counts["reads"]``, the tensor values read on the host
    inside the block (``.item()``, ``int()``, ``float()``, ``bool()`` of
    a tensor: each is one ``aten._local_scalar_dense``, which on a CUDA
    tensor is a device-to-host sync)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    counts = {"reads": 0}
    scalar = torch.ops.aten._local_scalar_dense.default

    class _Reads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is scalar:
                counts["reads"] += 1
            return func(*args, **(kwargs or {}))

    with _Reads():
        yield counts


class SanitizerError(AssertionError):
    """Base class: an engine invariant was violated at runtime."""


class BlockLeakError(SanitizerError):
    """A KV block reference was leaked (refcounts don't balance at drain)."""


class DoubleFreeError(SanitizerError):
    """A KV block was released more times than it was retained."""


class SharedWriteError(SanitizerError):
    """A sequence wrote into a block another holder still references."""


class SwappedBlockError(SharedWriteError):
    """A write targeted a block whose contents are mirrored on the host
    swap tier (held under ``SWAP_HOLDER``): the tier's dedup map would
    silently go stale.  Subclasses :class:`SharedWriteError` so existing
    shared-write handlers keep catching it."""


class SyncLedgerError(SanitizerError):
    """Observed host syncs disagree with the expected sync sites."""


# ---------------------------------------------------------------------------
# host-sync ledger
# ---------------------------------------------------------------------------

_SYNC_LEDGER: Dict[Tuple[str, str], int] = {}


def count_sync(n: int = 1) -> int:
    """Record one intentional host sync and return its count contribution
    (``self.host_syncs += count_sync()`` at each readback site).  Under
    ``REPRO_SANITIZE=1`` the (file, function) call site is tallied."""
    if sanitize_enabled():
        frame = sys._getframe(1)
        site = (os.path.basename(frame.f_code.co_filename),
                frame.f_code.co_name)
        _SYNC_LEDGER[site] = _SYNC_LEDGER.get(site, 0) + 1
    return n


def sync_ledger() -> Dict[Tuple[str, str], int]:
    """Snapshot of observed sync sites → counts (empty unless sanitizing)."""
    return dict(_SYNC_LEDGER)


def reset_sync_ledger() -> None:
    _SYNC_LEDGER.clear()


def check_sync_ledger(static_sites) -> None:
    """Every observed sync site must be one of ``static_sites``, the
    lint's ``hotlint.collect_sync_sites(["src/repro_torch"])``."""
    stray = sorted(set(_SYNC_LEDGER) - set(static_sites))
    if stray:
        raise SyncLedgerError(
            f"host syncs observed at sites with no static suppression: "
            f"{stray}")


# ---------------------------------------------------------------------------
# shadow allocator
# ---------------------------------------------------------------------------

class ShadowAllocator:
    """Holder-identity mirror of ``BlockAllocator``.

    The real allocator keeps bare refcounts; the shadow keeps *who* holds
    each reference (a seq id, ``CACHE_HOLDER``, ``SWAP_HOLDER``, or
    ``None`` for holder-less retains) plus a short per-block event trace,
    so violations raise with provenance.  Hooks run after the real
    allocator mutates, so the allocator's own ``ValueError`` paths keep
    their exception types.
    """

    def __init__(self) -> None:
        self.holders: Dict[int, List[object]] = {}
        self.materialized: Set[object] = set()
        self.trace: Dict[int, List[str]] = {}
        #: keys (req ids) whose KV currently lives on the host swap tier
        self.swapped: Set[object] = set()

    def _log(self, block: int, event: str) -> None:
        log = self.trace.setdefault(block, [])
        log.append(event)
        del log[:-8]

    def on_allocate(self, seq, blocks) -> None:
        for b in blocks:
            if self.holders.get(b):
                raise DoubleFreeError(
                    f"block {b} allocated to seq {seq} while still held by "
                    f"{self.holders[b]}; trace={self.trace.get(b)}")
            self.holders[b] = [seq]
            self._log(b, f"alloc->{seq}")

    def on_retain(self, blocks, holder) -> None:
        for b in blocks:
            self.holders.setdefault(b, []).append(holder)
            self._log(b, f"retain->{holder}")

    def on_release(self, blocks, holder) -> None:
        for b in blocks:
            held = self.holders.get(b)
            if not held:
                raise DoubleFreeError(
                    f"release of unheld block {b} by {holder}; "
                    f"trace={self.trace.get(b)}")
            if holder in held:
                held.remove(holder)
            elif None in held:       # holder-less retain
                held.remove(None)
            else:
                held.pop()
            self._log(b, f"release<-{holder}")
            if not held:
                del self.holders[b]

    def on_free_seq(self, seq) -> None:
        self.materialized.discard(seq)

    def on_swap_out(self, key) -> None:
        """``key``'s KV image moved to the host tier (DESIGN.md §15).  The
        tier's device holds are tracked as ordinary ``SWAP_HOLDER``
        references via on_retain/on_release."""
        self.swapped.add(key)

    def on_swap_in(self, key) -> None:
        """``key``'s image left the host tier (resumed *or* dropped)."""
        self.swapped.discard(key)

    def mark_materialized(self, seq) -> None:
        """``seq``'s KV pages now hold real data other seqs may share."""
        self.materialized.add(seq)

    def check_write(self, writer, blocks) -> None:
        """``writer`` is about to write KV into ``blocks``.

        A write is a violation when another holder of the block is the
        prefix cache, the host swap tier, or an already-materialized
        sequence: their KV (or the tier's host mirror of it) would be
        silently clobbered.  Not-yet-materialized holders are fine:
        §12's publish-then-admit shares a publisher's blocks with
        same-wave sharers *before* the wave dispatches.
        """
        for b in blocks:
            others = list(self.holders.get(b, ()))
            if writer in others:
                others.remove(writer)
            for h in others:
                if h == SWAP_HOLDER:
                    raise SwappedBlockError(
                        f"seq {writer} writing block {b} whose contents "
                        f"are host-resident on the swap tier (all holders "
                        f"{self.holders.get(b)}); trace={self.trace.get(b)}")
                if h == CACHE_HOLDER or h in self.materialized:
                    raise SharedWriteError(
                        f"seq {writer} writing block {b} still held by "
                        f"{h!r} (all holders {self.holders.get(b)}); "
                        f"trace={self.trace.get(b)}")


def maybe_shadow(alloc) -> "ShadowAllocator | None":
    """Shadow for a new ``BlockAllocator``, or ``None`` when not sanitizing."""
    return ShadowAllocator() if sanitize_enabled() else None


# ---------------------------------------------------------------------------
# drain-time accounting (always available, sanitizer on or off)
# ---------------------------------------------------------------------------

def check_allocator(alloc, cache=None, swap=None) -> None:
    """Audit a ``BlockAllocator``'s books: block conservation (free +
    live == pool), free-list uniqueness, and every live refcount
    explained by exactly the block-table occurrences plus the radix
    cache's retained blocks plus the swap tier's device holds.  With the
    sanitizer on, also cross-checks the shadow's holder counts."""
    free = list(alloc.free_blocks())
    if len(set(free)) != len(free):
        raise DoubleFreeError(f"free list contains duplicates: {free}")
    live = dict(alloc.refcount)
    both = set(free) & set(live)
    if both:
        raise BlockLeakError(
            f"blocks {sorted(both)} are simultaneously free and refcounted")
    if alloc.num_blocks != len(free) + len(live):
        raise BlockLeakError(
            f"block conservation violated: pool={alloc.num_blocks} != "
            f"{len(free)} free + {len(live)} live")
    expected: Dict[int, int] = {}
    for table in alloc.tables.values():
        for b in table:
            expected[b] = expected.get(b, 0) + 1
    if cache is not None:
        for b in cache.retained_blocks():
            expected[b] = expected.get(b, 0) + 1
    if swap is not None:
        for b in swap.device_holds():
            expected[b] = expected.get(b, 0) + 1
    if expected != live:
        bad = {b: (expected.get(b, 0), live.get(b, 0))
               for b in set(expected) | set(live)
               if expected.get(b, 0) != live.get(b, 0)}
        raise BlockLeakError(
            f"refcount imbalance {{block: (expected, actual)}}: {bad} — "
            f"a reference was retained without an owner or released twice")
    shadow = getattr(alloc, "_shadow", None)
    if shadow is not None:
        counts = {b: len(h) for b, h in shadow.holders.items() if h}
        if counts != live:
            raise BlockLeakError(
                f"shadow holder counts disagree with refcounts: "
                f"{counts} != {live}")


def check_engine_drained(engine) -> None:
    """After the queue drains: no slot is active, no seq table survives
    but the null block's, both memory tiers are empty (no suspended
    image, no host slot in use, no tier device hold), and the
    allocator's books balance (cache-retained blocks are legitimate
    survivors)."""
    active = [i for i, a in enumerate(engine.active) if a is not None]
    if active:
        raise BlockLeakError(
            f"drain check ran with slots still active: {active}")
    null_seq = engine._NULL_SEQ
    stray = sorted(s for s, t in engine.allocator.tables.items()
                   if s != null_seq and t)
    if stray:
        raise BlockLeakError(
            f"drained engine still owns block tables for seqs {stray}")
    swap = getattr(engine, "swap", None)
    if swap is not None:
        suspended = sorted(getattr(engine, "_swapped", ()))
        if suspended:
            raise BlockLeakError(
                f"drained engine still holds suspended images for "
                f"requests {suspended}")
        if not swap.empty:
            raise BlockLeakError(
                f"host swap tier not empty at drain: "
                f"{swap.used_slots} slots used, maps for "
                f"{sorted(map(repr, swap.maps))}, device holds "
                f"{sorted(swap.device_holds())}")
    shadow = getattr(engine.allocator, "_shadow", None)
    if shadow is not None and shadow.swapped:
        raise BlockLeakError(
            f"shadow residency registry not drained: {shadow.swapped}")
    check_allocator(engine.allocator, getattr(engine, "prefix_cache", None),
                    swap)
