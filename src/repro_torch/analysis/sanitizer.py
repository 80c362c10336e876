"""Host-sync accounting and drain-time checks for the paged engine.

A reduced copy of the reference package's sanitizer (DESIGN.md §13):

* :func:`hot_path` marks functions that must stay free of implicit
  device-to-host syncs;
* :func:`count_sync` is called at every intentional readback, so the
  engine's ``host_syncs`` counter is incremented at exactly the sites
  the reference counts;
* :func:`count_host_reads` counts the tensor values that code reads on
  the host, so a test can show that a path has none to count;
* :func:`check_allocator` and :func:`check_engine_drained` audit the
  allocator's refcounts against the block tables and the radix cache's
  retained set at teardown.

The shadow allocator and the ``REPRO_SANITIZE`` sync ledger are not part
of this copy."""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch


def hot_path(fn):
    """Marker: ``fn`` must stay free of implicit host syncs.  Pure
    annotation — returns ``fn`` unchanged."""
    return fn


def count_sync(n: int = 1) -> int:
    """One intentional host sync; returns its count contribution
    (``self.host_syncs += count_sync()`` at each readback site)."""
    return n


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


def check_allocator(alloc, cache=None) -> None:
    """Audit a ``BlockAllocator``'s books: block conservation (free +
    live == pool), free-list uniqueness, and every live refcount
    explained by exactly the block-table occurrences plus the radix
    cache's retained blocks."""
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
    if expected != live:
        bad = {b: (expected.get(b, 0), live.get(b, 0))
               for b in set(expected) | set(live)
               if expected.get(b, 0) != live.get(b, 0)}
        raise BlockLeakError(
            f"refcount imbalance {{block: (expected, actual)}}: {bad} — "
            f"a reference was retained without an owner or released twice")


def check_engine_drained(engine) -> None:
    """After the queue drains: no slot is active, no seq table survives
    but the null block's, and the allocator's books balance
    (cache-retained blocks are legitimate survivors)."""
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
    check_allocator(engine.allocator, getattr(engine, "prefix_cache", None))
