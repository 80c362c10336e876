"""Paged KV-cache block manager (vLLM-style; the paper cites
PagedAttention [46] as the memory-fragmentation motivation for its 70% Θ).

Beyond-paper extension: with block-granular allocation, a Magnus batch
only reserves cache for *predicted* lengths block-by-block as it decodes,
so the Eq.-(5) up-front reservation `beta*(L+G')*delta` becomes
`sum_p ceil((L_p + g_p(t))/BLOCK)*BLOCK*delta` — the adaptive batcher can
run a larger beta at the same Θ with OOM handled by eviction instead of
batch splitting.  This module is the allocator + accounting; the
`PagedMemoryModel` plugs into the same batcher interface as
`core.wma.MemoryModel`.

Prefix sharing (DESIGN.md §10-§11): blocks are **ref-counted**, so one
physical block can appear in many sequences' tables.  The LMaaS workload
serves `instruction + user_input` where the instruction is a fixed
per-application template — its KV pages are identical for every request
of that app (K/V at position i depend only on token i and its absolute
position).  :class:`RadixPrefixCache` indexes published prefix pages as
a **token-id radix tree** at block granularity: admission matches the
longest cached prefix across *all* apps (two templates sharing a
few-shot preamble share its pages even though their tails differ), and
:meth:`BlockAllocator.cow_if_not_appendable` lets the last *partial*
block of a match be shared read-only and cloned only when a sequence
must append into it (copy-on-write).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import (Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.analysis import sanitizer as _san
from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import Batch, Request
from repro_torch.core.wma import MemoryModel
from repro_torch.workload.tokenizer import encode, token_count

# Allocator seq_id owning permanently-reserved sentinel blocks (the
# engine's null block).  One shared constant: the engine's table setup and
# the memory model's Θ accounting must agree on which seq is unplannable.
NULL_SEQ = -1


class BlockAllocator:
    """Fixed-size block pool with per-sequence block tables and
    per-block reference counts.

    A block is *free* iff it has no references.  ``allocate`` hands out
    fresh blocks at refcount 1; ``share`` appends already-owned blocks to
    another sequence's table (refcount += 1); ``retain``/``release`` let
    a non-sequence holder (the prefix cache) keep blocks alive.  A block
    returns to the free list only when its refcount reaches 0 — freeing a
    sequence whose prefix is shared never reclaims the shared pages.

    **Copy-on-write** (:meth:`cow_if_not_appendable`): a table entry with
    refcount > 1 is read-only for its sequence — other holders (the radix
    cache, sibling sequences) see the same physical page.  Before a
    sequence may *append* into such a block it must swap the entry for a
    private clone; the allocator performs the ownership swap and the
    caller copies the KV page on device.

    >>> a = BlockAllocator(num_blocks=4, block_tokens=4)
    >>> a.allocate(0, 6)              # 6 tokens -> 2 blocks
    [3, 2]
    >>> a.retain([2])                 # a second holder: block 2 is shared
    >>> a.cow_if_not_appendable(0, 1) # seq 0 must not append into block 2
    (2, 1)
    >>> a.tables[0], a.refcount[2], a.refcount[1]
    ([3, 1], 1, 1)
    >>> a.cow_if_not_appendable(0, 1) is None   # already private: no-op
    True
    """

    def __init__(self, num_blocks: int, block_tokens: int = 16):
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self.free: List[int] = list(range(num_blocks))
        self.tables: Dict[int, List[int]] = {}      # seq_id -> block ids
        self.refcount: Dict[int, int] = {}          # block id -> references
        # holder-identity mirror, None unless REPRO_SANITIZE=1; hooks run
        # AFTER the real mutation so ValueError paths keep their types
        self._shadow = _san.maybe_shadow(self)

    def free_blocks(self) -> List[int]:
        """The free list (sanitizer/drain-check accessor)."""
        return self.free

    def blocks_needed(self, tokens: int) -> int:
        """Blocks covering ``tokens`` tokens (ceil division)."""
        return -(-tokens // self.block_tokens)

    def can_allocate(self, seq_id: int, tokens: int) -> bool:
        """Can seq ``seq_id`` grow its table to cover ``tokens`` tokens?"""
        have = len(self.tables.get(seq_id, []))
        return self.blocks_needed(tokens) - have <= len(self.free)

    def can_allocate_new(self, tokens: int) -> bool:
        """Would a *fresh* sequence of ``tokens`` tokens fit right now?
        (The admission probe — no sentinel seq id that could collide with
        a live sequence's table.)"""
        return self.blocks_needed(tokens) <= len(self.free)

    def allocate(self, seq_id: int, tokens: int) -> List[int]:
        """Grow seq ``seq_id``'s table to cover ``tokens`` tokens; every
        newly appended block is private (refcount 1).  Returns the table
        (shared + private entries, in position order).  Raises
        :class:`MemoryError` when the pool cannot supply the missing
        blocks — callers probe with :meth:`can_allocate` first."""
        table = self.tables.setdefault(seq_id, [])
        need = self.blocks_needed(tokens) - len(table)
        if need > len(self.free):
            raise MemoryError(
                f"paged OOM: need {need} blocks, {len(self.free)} free")
        fresh: List[int] = []
        for _ in range(max(need, 0)):
            b = self.free.pop()
            self.refcount[b] = 1
            table.append(b)
            fresh.append(b)
        if self._shadow is not None and fresh:
            self._shadow.on_allocate(seq_id, fresh)
        return table

    def share(self, seq_id: int, blocks: Sequence[int]) -> List[int]:
        """Start seq ``seq_id``'s table with already-live ``blocks``
        (refcount += 1 each).  Shared blocks must come first: the table
        must not exist yet (prefix pages precede private pages, so a
        request's private suffix/generation blocks always sit at higher
        positions than anything it shares)."""
        if self.tables.get(seq_id):
            raise ValueError(f"seq {seq_id} already has a table; shared "
                             f"prefix blocks must be its first entries")
        self.retain(blocks, holder=seq_id)
        table = self.tables.setdefault(seq_id, [])
        table.extend(blocks)
        return table

    def retain(self, blocks: Sequence[int], holder=None) -> None:
        """Add one reference to each of ``blocks`` (all must be live).
        ``holder`` tags the reference's owner for the sanitizer's shadow
        bookkeeping (a seq id, the cache, or None)."""
        for b in blocks:
            if self.refcount.get(b, 0) <= 0:
                raise ValueError(f"block {b} is free; cannot retain")
            self.refcount[b] += 1
        if self._shadow is not None:
            self._shadow.on_retain(blocks, holder)

    def release(self, blocks: Sequence[int], holder=None) -> None:
        """Drop one reference from each of ``blocks``; refcount 0 frees."""
        for b in blocks:
            n = self.refcount.get(b, 0)
            if n <= 0:
                raise ValueError(f"double free of block {b}")
            if n == 1:
                del self.refcount[b]
                self.free.append(b)
            else:
                self.refcount[b] = n - 1
        if self._shadow is not None:
            self._shadow.on_release(blocks, holder)

    def cow_if_not_appendable(self, seq_id: int,
                              idx: int) -> Optional[Tuple[int, int]]:
        """Make table entry ``idx`` of seq ``seq_id`` privately writable.

        If the block is already exclusive (refcount 1) this is a no-op
        returning ``None`` — the sequence may append in place.  Otherwise
        the entry is swapped for a fresh private block: the old block
        keeps its other holders' references (it is **never mutated**),
        the sequence's one reference moves to the clone, and
        ``(src, dst)`` is returned so the caller can copy the KV page on
        device (``pages[dst] = pages[src]``).  Raises
        :class:`MemoryError` when no free block is available for the
        clone — callers under pool pressure evict first."""
        table = self.tables[seq_id]
        src = table[idx]
        n = self.refcount.get(src, 0)
        if n <= 0:
            raise ValueError(f"block {src} is free; cannot copy-on-write")
        if n == 1:
            return None
        if not self.free:
            raise MemoryError("paged OOM: no free block for copy-on-write")
        dst = self.free.pop()
        self.refcount[dst] = 1
        self.refcount[src] = n - 1
        table[idx] = dst
        if self._shadow is not None:
            # the seq's one reference moves src -> dst
            self._shadow.on_release([src], seq_id)
            self._shadow.on_allocate(seq_id, [dst])
        return (src, dst)

    def free_seq(self, seq_id: int) -> None:
        """Drop the sequence's table, releasing one reference per entry
        (shared pages survive as long as any other holder remains)."""
        self.release(self.tables.pop(seq_id, []), holder=seq_id)
        if self._shadow is not None:
            self._shadow.on_free_seq(seq_id)

    def truncate(self, seq_id: int, keep_blocks: int) -> List[int]:
        """Shrink seq ``seq_id``'s table to its first ``keep_blocks``
        entries, releasing one reference per trailing block: the
        speculative-decode rollback (DESIGN.md §16).  It only ever
        decrements, so a trailing block another holder keeps (a
        published radix page, a swap image's device hold) survives with
        that holder's reference and is never mutated.  Returns the
        released trailing blocks."""
        table = self.tables.get(seq_id, [])
        if keep_blocks < 0:
            raise ValueError(f"keep_blocks must be >= 0, got {keep_blocks}")
        trailing = table[keep_blocks:]
        if trailing:
            del table[keep_blocks:]
            self.release(trailing, holder=seq_id)
        return trailing

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self.free)

    def utilization(self, live_tokens: int) -> float:
        """Fraction of allocated cache actually holding tokens (1 -
        internal fragmentation)."""
        used = self.used_blocks * self.block_tokens
        return live_tokens / used if used else 1.0


class RadixNode:
    """One cached block of prefix KV in the radix tree.

    ``tokens`` is the block's token-id content — exactly
    ``block_tokens`` ids for a *full* node (which may have children) or
    fewer for a *partial* leaf (which may not: the tree only chains
    through block boundaries).  ``block`` is the physical page holding
    that KV; the cache owns one allocator reference per node."""

    __slots__ = ("tokens", "block", "parent", "children", "partials",
                 "pins", "last_used")

    def __init__(self, tokens: Tuple[int, ...], block: Optional[int],
                 parent: Optional["RadixNode"]):
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.partials: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.pins = 0
        self.last_used = 0

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.partials


@dataclasses.dataclass
class PrefixMatch:
    """Result of a radix walk: the deepest matched node, its path's
    physical blocks (position order), and the matched token count.
    ``tokens % block_tokens != 0`` means the final block is shared
    *partially* — the admitting sequence must copy-on-write it before
    writing its own suffix KV into the remaining slots."""
    node: Optional[RadixNode]
    blocks: List[int]
    tokens: int

    def full_blocks(self, block_tokens: int) -> int:
        """Blocks of the match shared in their entirety (the memory the
        sharer does *not* pay for; a partial tail block is cloned, so it
        saves prefill compute but not pool capacity)."""
        return self.tokens // block_tokens


class RadixPrefixCache:
    """Token-id radix tree over published prefix KV blocks.

    Each edge holds one block's token content; a path from the root
    spells out a prefix of some published prompt, and every node on the
    path is a valid match endpoint — so two apps whose instruction
    templates share a long common head share the head's pages even
    though neither template is a prefix of the other (the
    content-keyed exact-match cache this replaces shared nothing there).
    Partial leaves additionally publish the tail of a prefix that ends
    mid-block; they are shared read-only and cloned on append
    (copy-on-write, :meth:`BlockAllocator.cow_if_not_appendable`).

    The cache holds one allocator reference per node, so published pages
    survive the publishing request's finish/eviction; per-request
    references come and go with the sharing sequences' tables.
    :meth:`pin`/:meth:`unpin` protect a matched node's whole root path
    while an admission is in flight; :meth:`evict_until` reclaims
    **unpinned leaves oldest-use-first** (a parent only becomes
    evictable once its subtree is gone, which preserves the invariant
    that every resident node's full path is resident — matches walk from
    the root).

    >>> alloc = BlockAllocator(num_blocks=8, block_tokens=2)
    >>> cache = RadixPrefixCache(alloc)
    >>> table = alloc.allocate(0, 5)          # covers ids [5,6,7,8,9]
    >>> cache.insert([5, 6, 7, 8, 9], table)  # 2 full nodes + 1 partial
    3
    >>> m = cache.match([5, 6, 7, 8, 9, 1])   # same head, longer prompt
    >>> (m.tokens, len(m.blocks), m.tokens % 2)
    (5, 3, 1)
    >>> cache.match([5, 6, 1]).tokens         # diverges inside block 2
    2
    >>> alloc.free_seq(0); cache.evict_until(8)  # cache refs released
    True
    >>> len(alloc.free)
    8
    """

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self.root = RadixNode((), None, None)
        self.hits = 0
        self.misses = 0
        self.evicted = 0
        self._clock = 0

    # -- matching ------------------------------------------------------------

    def match(self, token_ids: Sequence[int], *,
              peek: bool = False) -> PrefixMatch:
        """Longest cached prefix of ``token_ids``.

        Walks full-block children while they match entirely, then takes
        the longest partial extension — either a partial leaf or the
        leading tokens of a full child (a cached full block whose first
        r tokens match is shareable at valid length r: KV at a position
        depends only on the token at that position).  Callers that need
        ≥ 1 un-cached prompt token (a prefill needs a query position)
        pass a slice that stops one short — the cache matches whatever
        it is given.

        Matches shorter than one full block are reported as misses: a
        sub-block share (every prompt trivially shares its BOS token)
        would pay a copy-on-write clone to save fewer tokens than the
        clone costs.  With ``peek`` the walk is free of side effects;
        otherwise it bumps the hit/miss counters and the LRU clock of
        every node on the matched path."""
        bt = self.allocator.block_tokens
        node, blocks, matched = self.root, [], 0
        n = len(token_ids)
        while matched + bt <= n:
            child = node.children.get(tuple(token_ids[matched:matched + bt]))
            if child is None:
                break
            node = child
            blocks.append(child.block)
            matched += bt
        # partial extension: longest common prefix into any partial leaf
        # or full child at this depth.  Two-token gate: a non-starter's
        # LCP is 0, and the root fans out to every published chain (§12
        # publishes whole prompts, so stale per-request chains accumulate
        # until LRU eviction) — admission must not pay an LCP call per
        # candidate on the pure-miss hot path.  Two tokens, because at
        # the root every chain starts with BOS and one token gates
        # nothing.
        rest = tuple(token_ids[matched:])
        best, best_len = None, 0
        if rest:
            r0 = rest[0]
            r1 = rest[1] if len(rest) > 1 else None
            for group in (node.partials, node.children):
                for cand in group.values():
                    ct = cand.tokens
                    if ct[0] != r0:
                        continue              # LCP would be 0
                    if r1 is not None and len(ct) > 1 and ct[1] != r1:
                        l = 1                 # LCP stops at token two
                    else:
                        l = _lcp(ct, rest)
                    if l > best_len:
                        best, best_len = cand, l
        if best is not None:
            node = best
            blocks.append(best.block)
            matched += best_len
        if node is self.root or matched < bt:
            if not peek:
                self.misses += 1
            return PrefixMatch(None, [], 0)
        if not peek:
            self.hits += 1
            self._touch(node)
        return PrefixMatch(node, blocks, matched)

    def _touch(self, node: RadixNode) -> None:
        self._clock += 1
        while node is not None:
            node.last_used = self._clock
            node = node.parent

    # -- publishing ----------------------------------------------------------

    def insert(self, token_ids: Sequence[int],
               table: Sequence[int]) -> int:
        """Publish every block boundary of ``token_ids`` (whose KV lives
        in ``table``'s leading blocks): one full node per complete block
        plus a partial leaf for a mid-block tail.  Existing nodes with
        identical content are kept (their pages are already resident —
        nothing is retained twice); only newly created nodes take a
        cache reference on the corresponding table block.  Returns the
        number of nodes inserted.  Idempotent per content.  Spans
        shorter than one block publish nothing (they could never match —
        see :meth:`match`'s one-block floor)."""
        bt = self.allocator.block_tokens
        node, pos, created = self.root, 0, 0
        n = len(token_ids)
        if n < bt:
            return 0
        while pos + bt <= n:
            tup = tuple(token_ids[pos:pos + bt])
            child = node.children.get(tup)
            if child is None:
                block = table[pos // bt]
                self.allocator.retain([block], holder=_san.CACHE_HOLDER)
                child = RadixNode(tup, block, node)
                node.children[tup] = child
                created += 1
            node = child
            pos += bt
        if pos < n:
            tup = tuple(token_ids[pos:n])
            if tup not in node.partials:
                block = table[pos // bt]
                self.allocator.retain([block], holder=_san.CACHE_HOLDER)
                node.partials[tup] = RadixNode(tup, block, node)
                created += 1
        if created:
            self._clock += 1
            self._touch(node)
        return created

    # -- pinning -------------------------------------------------------------

    def pin(self, node: RadixNode) -> None:
        """Protect ``node``'s whole root path from eviction while an
        admission that shares its pages is in flight."""
        while node is not None and node.parent is not None:
            node.pins += 1
            node = node.parent

    def unpin(self, node: RadixNode) -> None:
        while node is not None and node.parent is not None:
            if node.pins <= 0:
                raise ValueError("unpin of an unpinned radix node")
            node.pins -= 1
            node = node.parent

    # -- introspection -------------------------------------------------------

    def nodes(self) -> Iterator[RadixNode]:
        """All resident nodes (excluding the block-less root)."""
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                yield n
            stack.extend(n.children.values())
            stack.extend(n.partials.values())

    @property
    def num_nodes(self) -> int:
        return sum(1 for _ in self.nodes())

    def retained_blocks(self) -> List[int]:
        """One entry per allocator reference the cache holds (a node owns
        exactly one) — the drain check's 'legitimate survivor' set."""
        return [n.block for n in self.nodes()]

    def reclaimable_blocks(self, keep: Optional[RadixNode] = None) -> int:
        """Blocks leaf-LRU eviction would actually *free*: blocks of
        unpinned evictable nodes (whole subtree evictable, ``keep``'s
        path excluded) that no live table references."""
        keep_path = set()
        while keep is not None:
            keep_path.add(id(keep))
            keep = keep.parent

        def walk(node: RadixNode) -> Tuple[bool, int]:
            evictable, count = True, 0
            for child in list(node.children.values()) + \
                    list(node.partials.values()):
                ok, c = walk(child)
                count += c
                evictable = evictable and ok
            if node is self.root:
                return evictable, count
            evictable = (evictable and node.pins == 0
                         and id(node) not in keep_path)
            if evictable and self.allocator.refcount.get(node.block) == 1:
                count += 1
            return evictable, count

        return walk(self.root)[1]

    # -- eviction ------------------------------------------------------------

    def _evict_node(self, victim: RadixNode) -> None:
        parent = victim.parent
        key = victim.tokens
        if len(key) == self.allocator.block_tokens:
            del parent.children[key]
        else:
            del parent.partials[key]
        self.allocator.release([victim.block], holder=_san.CACHE_HOLDER)
        self.evicted += 1

    def evict_until(self, free_blocks: int) -> bool:
        """Evict unpinned leaves (oldest use first) until the allocator
        has ``free_blocks`` free blocks; returns success.  Evicting a
        leaf releases the cache's reference — the block only frees if no
        live table shares it — and may expose its parent as the next
        eviction candidate.

        One tree walk seeds a heap of evictable leaves; evicting a leaf
        pushes its parent when it becomes an unpinned leaf, so freeing E
        blocks costs O(N + E log N), not the O(E·N) of a per-leaf
        rescan.  That matters since §12: publishing whole prompt spans
        means the tree indexes per-request content, and under pool
        pressure eviction runs on the admission path with O(num_blocks)
        resident nodes.  A node's ``last_used`` never changes while
        evicting (touches happen on match/insert), so heap order stays
        exact: each pop is the globally-oldest evictable leaf, the same
        victim the rescan picked."""
        if len(self.allocator.free) >= free_blocks:
            return True
        heap = [(n.last_used, id(n), n) for n in self.nodes()
                if n.is_leaf and n.pins == 0]
        heapq.heapify(heap)
        while len(self.allocator.free) < free_blocks:
            if not heap:
                return False
            _, _, victim = heapq.heappop(heap)
            self._evict_node(victim)
            parent = victim.parent
            if parent is not self.root and parent.is_leaf \
                    and parent.pins == 0:
                heapq.heappush(heap,
                               (parent.last_used, id(parent), parent))
        return True


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class MispredictionEWMA:
    """Per-app EWMA of observed/reserved generation-length ratio — the
    misprediction feedback loop (DESIGN.md §14).

    The engine observes ``(reserved G', actual G)`` at every finish and
    at every decode-time growth past the reservation; :meth:`factor`
    turns the smoothed ratio into an adaptive headroom multiplier
    (clamped to ``[1, max_headroom]``) that both the engine's
    ``reserve_tokens`` and the batcher's ``PagedMemoryModel.mem_of``
    apply to predicted lengths.  Because the ratio is measured against
    the *already-compensated* reservation, the loop self-damps: once the
    inflated reservations are sufficient, observed/reserved falls back
    to <= 1 and the headroom decays toward the clamp floor.

    >>> e = MispredictionEWMA(alpha=0.5)
    >>> e.factor("mt")                      # no evidence: no headroom
    1.0
    >>> e.observe("mt", predicted=4, observed=16)
    >>> e.factor("mt")
    2.5
    """

    def __init__(self, alpha: float = 0.3, max_headroom: float = 4.0):
        self.alpha = alpha
        self.max_headroom = max_headroom
        self.ratio: Dict[str, float] = {}
        self.samples = 0

    def observe(self, app: str, predicted: int, observed: int) -> None:
        r = observed / max(predicted, 1)
        prev = self.ratio.get(app, 1.0)
        self.ratio[app] = (1.0 - self.alpha) * prev + self.alpha * r
        self.samples += 1

    def factor(self, app: str) -> float:
        """Adaptive headroom multiplier for ``app``'s predictions."""
        return min(max(self.ratio.get(app, 1.0), 1.0), self.max_headroom)

    def snapshot(self) -> Dict[str, float]:
        """Per-app headroom multipliers (reporting)."""
        return {app: round(self.factor(app), 3)
                for app in sorted(self.ratio)}


@dataclasses.dataclass
class PagedMemoryModel:
    """MemoryModel-compatible facade: MEM(B) under block-granular
    allocation. ``mem_of``/``theta``/``physical_limit`` keep the batcher's
    Algorithm-1 interface; request footprints round up to blocks instead
    of reserving (L_max + G_max).

    When bound to a :class:`BlockAllocator` (``allocator``), planning Θ is
    the pool's exact byte capacity, so the batcher's Algorithm-1 check and
    the runtime engine admit against the same physical blocks.

    With ``prefix_sharing`` the per-request footprint splits into a
    shared instruction-prefix head and a private suffix +
    predicted-generation remainder.  Shared heads are charged **once per
    distinct full-block chain at longest-common-prefix granularity** — a
    trie over the batch's instruction token blocks mirrors the runtime's
    radix tree, so two templates sharing a 2-block preamble charge those
    2 blocks once even though the templates differ (the partial tail
    block is charged privately: the runtime clones it on append, so it
    saves prefill compute, not pool capacity)."""
    base: MemoryModel
    block_tokens: int = 16
    allocator: Optional[BlockAllocator] = None
    prefix_sharing: bool = False
    # misprediction feedback (DESIGN.md §14): when bound to the engine's
    # MispredictionEWMA, predicted footprints carry the same per-app
    # headroom multiplier the runtime's reserve_tokens applies, so the
    # batcher's Algorithm-1 check and the engine admit identically under
    # an under-prediction storm
    headroom: Optional[MispredictionEWMA] = dataclasses.field(
        default=None, repr=False, compare=False)
    _ids_memo: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def theta(self) -> int:
        if self.allocator is not None:
            # NULL_SEQ owns the engine's permanently-reserved null block:
            # not plannable capacity
            usable = (self.allocator.num_blocks
                      - len(self.allocator.tables.get(NULL_SEQ, ())))
            return usable * self.allocator.block_tokens * self.base.delta
        return self.base.theta

    @property
    def physical_limit(self) -> int:
        return self.base.physical_limit

    @property
    def max_len(self) -> int:
        return self.base.max_len

    @property
    def max_gen(self) -> int:
        return self.base.max_gen

    def _round(self, tokens: int) -> int:
        return -(-tokens // self.block_tokens) * self.block_tokens

    def request_bytes(self, total_tokens: int) -> int:
        return self.base.request_bytes(self._round(total_tokens))

    def batch_bytes(self, batch_size: int, batch_len: int,
                    batch_gen: int) -> int:
        # paged: no padding reservation — each request holds its own blocks
        return batch_size * self.request_bytes(batch_len + batch_gen)

    def shared_prefix_tokens(self, req: Request) -> int:
        """Full-block tokens of ``req``'s instruction prefix (the span
        the runtime's radix cache can share without cloning), leaving
        >= 1 prompt token uncached.  0 when prefix sharing is off or the
        template is shorter than one block."""
        if not self.prefix_sharing or self.base.cfg.family == "ssm":
            return 0
        instr = token_count(req.instruction, bos=True)
        n = min(instr, max(req.length - 1, 0))
        return n // self.block_tokens * self.block_tokens

    def _instr_ids(self, instruction: str) -> List[int]:
        ids = self._ids_memo.get(instruction)
        if ids is None:
            ids = encode(instruction, self.base.cfg.vocab_size)
            self._ids_memo[instruction] = ids
        return ids

    def mem_of(self, batch: Batch, extra: Optional[Request] = None,
               predicted: bool = True) -> int:
        reqs = batch.requests + ([extra] if extra is not None else [])
        total = 0
        trie: Dict = {}
        for r in reqs:
            g = (r.predicted_gen_length if predicted and
                 r.predicted_gen_length is not None else r.gen_length)
            if predicted and self.headroom is not None:
                h = self.headroom.factor(r.app)
                if h > 1.0:
                    g = min(int(math.ceil(g * h)), self.max_gen)
            span = self.shared_prefix_tokens(r)
            if span:
                # walk the batch-local trie at LCP granularity: only the
                # blocks this chain adds beyond already-charged heads
                # cost pool capacity — exactly one physical copy exists
                # in the runtime's ref-counted pool
                ids = self._instr_ids(r.instruction)
                node, new = trie, 0
                for d in range(0, span, self.block_tokens):
                    tup = tuple(ids[d:d + self.block_tokens])
                    nxt = node.get(tup)
                    if nxt is None:
                        nxt = node[tup] = {}
                        new += self.block_tokens
                    node = nxt
                if new:
                    total += self.request_bytes(new)
            total += self.request_bytes(r.length - span + g)
        return total

    def vanilla_batch_size(self) -> int:
        return self.base.vanilla_batch_size()


def make_paged_memory(cfg: ModelConfig, hbm_bytes: int = 16 * 2 ** 30,
                      block_tokens: int = 16, **kw) -> PagedMemoryModel:
    return PagedMemoryModel(MemoryModel(cfg, hbm_bytes=hbm_bytes, **kw),
                            block_tokens=block_tokens)


class HostSwapTier:
    """Host-memory page store backing non-destructive preemption
    (DESIGN.md §15).

    The device pool is tier 0; this is tier 1: a CPU tensor of page
    slots, allocated once when the tier is built, slot-major
    (``[slots, P, L, block_tokens, Hkv, D]``: ``page_shape`` is one
    block's ``(P, L, block_tokens, Hkv, D)`` across the pools, P =
    len(pools) in sorted key order, in the pools' ``dtype``), so the
    pages of consecutive slots are one contiguous run.  With
    ``pin_memory`` (an engine on the CUDA card) the store is
    page-locked, and a swap-out's device-to-host copy and a resume's
    host-to-device copy go straight between the device and the store's
    slots, asynchronously on the engine's stream (the engine waits for
    the swap-out's).  When the engine suspends a request it copies the
    request's pages here, frees its device blocks, and records a
    **per-sequence swap map** (host slot per table position) so the
    request can later resume bit for bit with zero re-prefilled tokens.

    Refcount/COW awareness — shared radix blocks swap **once**:

    * ``by_block`` deduplicates: a device block whose contents are
      already host-resident (published prefix shared by two suspended
      requests) gets no second copy, only a slot reference.
    * For every copied block that is *still live* after the owner's
      ``free_seq`` (the radix cache or a sibling holds it), the tier
      retains one allocator reference under ``SWAP_HOLDER``.  The hold
      certifies the device copy immutable (refcount ≥ 2 means
      ``cow_if_not_appendable`` clones before any append), so a resume
      may ``share`` it instead of scattering from host — and the
      sanitizer raises on any write into it.  Under pool pressure
      :meth:`release_device_holds` drops every hold (the host copies
      remain authoritative), trading resume bandwidth for free blocks.

    ``host_pressure`` faults :meth:`shrink` the soft ``capacity`` below
    ``num_slots``; :meth:`can_hold` then refuses new swap-outs (the
    engine falls back to destructive eviction) without ever touching
    resident images.

    >>> a = BlockAllocator(num_blocks=4, block_tokens=2)
    >>> tier = HostSwapTier(4, (2, 1, 2, 1, 1), torch.float32)
    >>> table = list(a.allocate(0, 4))
    >>> fresh = tier.fresh_blocks(table); fresh == table
    True
    >>> vals = torch.arange(8, dtype=torch.float32).reshape(2, 1, 2, 2, 1, 1)
    >>> a.free_seq(0)
    >>> tier.swap_out(7, table, fresh, vals, a)
    >>> tier.split_resident(7)          # nothing shareable on device
    ([], [0, 1])
    >>> torch.equal(tier.read([0, 1]), vals)
    True
    >>> tier.drop(7, a); tier.empty
    True
    """

    def __init__(self, num_slots: int, page_shape: Sequence[int],
                 dtype: torch.dtype, *, pin_memory: bool = False):
        self.num_slots = num_slots
        self.capacity = num_slots            # soft cap (host_pressure)
        self.pin_memory = pin_memory
        # pop() yields ascending slot ids — deterministic placement
        self.free: List[int] = list(range(num_slots - 1, -1, -1))
        # uninitialised: a slot is written before any map points at it
        self._store = self.host_empty((num_slots,) + tuple(page_shape),
                                      dtype)
        self.slot_ref: Dict[int, int] = {}   # host slot -> #maps using it
        self.by_block: Dict[int, int] = {}   # held device block -> slot
        self.slot_block: Dict[int, int] = {} # inverse of by_block
        self.maps: Dict[object, List[int]] = {}  # key -> slot per position
        self.copied_slots = 0
        self.deduped_blocks = 0

    # -- capacity ------------------------------------------------------------

    @property
    def used_slots(self) -> int:
        return self.num_slots - len(self.free)

    def can_hold(self, n_fresh: int) -> bool:
        """Room for ``n_fresh`` new page copies under the soft capacity?"""
        return (n_fresh <= len(self.free)
                and self.used_slots + n_fresh <= self.capacity)

    def shrink(self, n_slots: int) -> None:
        """Lower the soft capacity (``host_pressure`` fault): future
        swap-outs see a smaller tier; resident images are untouched."""
        self.capacity = max(0, self.capacity - n_slots)

    def restore(self) -> None:
        self.capacity = self.num_slots

    @property
    def empty(self) -> bool:
        return (not self.maps and not self.slot_ref and not self.by_block
                and self.used_slots == 0)

    def device_holds(self) -> List[int]:
        """Device blocks the tier keeps alive under ``SWAP_HOLDER`` (the
        drain check's second 'legitimate survivor' set)."""
        return list(self.by_block)

    # -- swap-out ------------------------------------------------------------

    def fresh_blocks(self, table: Sequence[int]) -> List[int]:
        """The subset of ``table`` needing a host copy — blocks already
        host-resident (``by_block``) are deduplicated to a reference."""
        return [b for b in table if b not in self.by_block]

    def host_empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """An uninitialised host tensor, page-locked with ``pin_memory``:
        the store, and the engine's copy of a suspended logits row."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.pin_memory)

    @staticmethod
    def _runs(slots: Sequence[int]) -> List[Tuple[int, int, int]]:
        """``(i, slot, n)`` for each run of ``n`` consecutive slots
        starting at position ``i`` of ``slots``: one contiguous piece of
        the store each."""
        runs: List[Tuple[int, int, int]] = []
        for i, s in enumerate(slots):
            if runs and runs[-1][1] + runs[-1][2] == s:
                runs[-1] = (runs[-1][0], runs[-1][1], runs[-1][2] + 1)
            else:
                runs.append((i, s, 1))
        return runs

    def swap_out(self, key, table: Sequence[int], fresh: Sequence[int],
                 values: Optional[torch.Tensor], allocator) -> None:
        """Suspend ``key``'s pages: ``values[:, :, i]`` is the page of
        ``fresh[i]`` (``[P, L, len(fresh), ...]``, the caller's gather,
        taken **before** freeing the seq, on the engine's device); dedup
        hits take slot references only.  The pages are copied straight
        into their slots, one copy a run of consecutive slots, without
        waiting for a device copy to land (the caller synchronises).
        Must run *after* the engine's ``free_seq`` so still-live fresh
        blocks (cache/sibling holders survive the free) can be
        identified and retained under ``SWAP_HOLDER``."""
        if key in self.maps:
            raise ValueError(f"key {key!r} is already swapped out")
        slots = [self.free.pop() for _ in fresh]
        if fresh:
            pages = values.movedim(2, 0)
            for i, s, n in self._runs(slots):
                self._store[s:s + n].copy_(pages[i:i + n],
                                           non_blocking=self.pin_memory)
        fresh_slot: Dict[int, int] = {}
        for b, s in zip(fresh, slots):
            fresh_slot[b] = s
            self.copied_slots += 1
            if allocator.refcount.get(b, 0) > 0:
                allocator.retain([b], holder=_san.SWAP_HOLDER)
                self.by_block[b] = s
                self.slot_block[s] = b
        seq_map: List[int] = []
        for b in table:
            if b in fresh_slot:
                s = fresh_slot[b]
            else:                        # dedup: already host-resident
                s = self.by_block[b]
                self.deduped_blocks += 1
            self.slot_ref[s] = self.slot_ref.get(s, 0) + 1
            seq_map.append(s)
        self.maps[key] = seq_map

    # -- swap-in -------------------------------------------------------------

    def split_resident(self, key) -> Tuple[List[int], List[int]]:
        """Partition ``key``'s map into a device-shareable prefix (blocks
        the tier still holds — immutable, so a resume can ``share`` them)
        and the host slots whose pages must be scattered back."""
        seq_map = self.maps[key]
        shared: List[int] = []
        for s in seq_map:
            b = self.slot_block.get(s)
            if b is None:
                break
            shared.append(b)
        return shared, seq_map[len(shared):]

    def read(self, slots: Sequence[int],
             device: Union[str, torch.device] = "cpu") -> torch.Tensor:
        """Page contents for ``slots`` (``[P, L, len(slots), ...]``), a new
        tensor on ``device``, copied straight from the store's runs (on
        the card asynchronously on the current stream, from page-locked
        memory)."""
        out = torch.empty((len(slots),) + tuple(self._store.shape[1:]),
                          dtype=self._store.dtype, device=device)
        for i, s, n in self._runs(list(slots)):
            out[i:i + n].copy_(self._store[s:s + n],
                               non_blocking=self.pin_memory)
        return out.movedim(0, 2)

    def drop(self, key, allocator) -> None:
        """Forget ``key``'s image (resumed or shed): slot references are
        released; a slot with no remaining references frees, and its
        device hold (if any) is released back to the allocator."""
        for s in self.maps.pop(key):
            n = self.slot_ref[s] - 1
            if n > 0:
                self.slot_ref[s] = n
                continue
            del self.slot_ref[s]
            self.free.append(s)
            b = self.slot_block.pop(s, None)
            if b is not None:
                del self.by_block[b]
                allocator.release([b], holder=_san.SWAP_HOLDER)

    def warm(self, values: torch.Tensor,
             device: Union[str, torch.device]) -> torch.Tensor:
        """A swap-out's store copy and a resume's read, once, for an
        engine's ``warmup()``: ``values`` (one page, ``[P, L, 1, ...]``)
        goes into a free slot, which stays free (its contents are junk,
        as every free slot's are), and comes back as :meth:`read` gives
        it."""
        s = self.free[-1]
        self._store[s:s + 1].copy_(values.movedim(2, 0),
                                   non_blocking=self.pin_memory)
        return self.read([s], device)

    # -- pressure escape hatch -----------------------------------------------

    def release_device_holds(self, allocator) -> bool:
        """Drop every ``SWAP_HOLDER`` reference (the cheapest pressure
        valve: nothing is lost — host copies remain authoritative and
        resumes fall back to scattering).  Returns whether any device
        block actually freed."""
        if not self.slot_block:
            return False
        before = len(allocator.free)
        for s, b in list(self.slot_block.items()):
            allocator.release([b], holder=_san.SWAP_HOLDER)
        self.slot_block.clear()
        self.by_block.clear()
        return len(allocator.free) > before
