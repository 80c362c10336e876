"""The serving engines on PyTorch (the reference package's
``serving/engine.py``).

- :class:`BatchEngine` is the paper's §II-D padded batch procedure: pad
  every request to the batch length, prefill, then decode until *every*
  request has finished (early finishers keep generating invalid tokens:
  request waiting), and report the measured WMA of Eqs. 2-4.
- :class:`ContinuousEngine` is conservative continuous batching (CCB):
  fixed slots over one dense cache; a joining request prefills alone.
- :class:`PagedContinuousEngine` serves over a shared physical block
  pool (``serving.paged_cache.BlockAllocator``): admission reserves
  blocks for the *predicted* generation length only, decode grows
  per-request block tables block by block, and a failed grow evicts and
  requeues instead of splitting the batch.
- Decode runs in fused multi-step windows (§9): ``k`` greedy steps on the
  device with the argmax feeding the next step, and one ``[B, k]`` token
  readback per window, counted in ``host_syncs`` (``ContinuousEngine``
  reads its tokens back every step, as in the reference).  On the card
  the paged engine and ``BatchEngine`` replay their decode step as a
  captured CUDA graph (``serving/graphs.py``): the paged engine captures
  once, at its first window or ahead of time in ``warmup()``, and
  ``BatchEngine`` once per batch, on the batch's own cache.  This is the
  port's counterpart of the reference's one compiled program per
  window.
- Admission is a single-dispatch variable-prefix wave (§12): radix hits
  and misses ride one ``prefill_wave`` call per suffix-length bucket.

Generation is length-scripted replay (DESIGN.md §7): logits come from the
real model, and a request stops at its ground-truth generation length.

Not in this module yet: fault injection, deadlines and the NaN guard
(§14), the host swap tier (§15), speculative decoding (§16) and
snapshot/restore (§17).  The padded engines serve the dense
and SSM (mamba2) families with a float cache; the paged engine serves
the dense family.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.analysis import sanitizer as _san
from repro_torch.analysis.sanitizer import count_sync, hot_path
from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import SHED_REASONS, Batch, Request
from repro_torch.core.wma import batch_wma
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.transformer import cast_params, supports_dense
from repro_torch.serving.paged_cache import (BlockAllocator,
                                             MispredictionEWMA, NULL_SEQ,
                                             PrefixMatch, RadixPrefixCache)
from repro_torch.serving.graphs import DecodeGraph
from repro_torch.workload.tokenizer import encode


class EngineFull(RuntimeError):
    """Admission refused: no free slot / not enough free KV blocks.
    Callers must keep the request queued and retry after a step_window().
    ``evicted`` exists on every instance so catch sites can requeue it
    without probing."""

    def __init__(self, msg: str = "", *,
                 evicted: Tuple[Request, ...] = ()):
        super().__init__(msg)
        self.evicted: Tuple[Request, ...] = tuple(evicted)


class PoolExhausted(MemoryError, EngineFull):
    """Decode-time growth cannot proceed: the pool is too small for the
    growing request, its table overflowed ``max_len + max_gen``, or a
    foreign sequence on a shared allocator holds the blocks.
    ``evicted`` carries the requests evicted earlier in the same failed
    ``step_window`` (callers must requeue them); ``culprit`` is the
    request whose growth raised, already freed from its slot."""

    def __init__(self, msg: str = "", *,
                 evicted: Tuple[Request, ...] = (),
                 culprit: Optional[Request] = None):
        EngineFull.__init__(self, msg, evicted=evicted)
        self.culprit = culprit


@dataclasses.dataclass
class Shed:
    """A request dropped instead of served.  ``clock`` is the engine's
    scheduler clock at the moment of the drop."""
    req: object
    reason: str
    clock: int = 0

    def __post_init__(self):
        if self.reason not in SHED_REASONS:
            raise ValueError(f"unknown shed reason {self.reason!r}; "
                             f"one of {SHED_REASONS}")


_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int, buckets=_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return _pow2_ceil(n)


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (max(n, 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    n = max(n, 1)
    return 1 << (n - 1).bit_length() if n & (n - 1) else n


def _upload(device: torch.device, *arrays: np.ndarray
            ) -> List[torch.Tensor]:
    """Host int32 arrays -> device tensors in ONE host-to-device copy
    (the reference hands its jitted call the numpy arrays, which jit
    batches into one transfer).  Every caller passes fresh arrays."""
    flat = np.concatenate([a.ravel() for a in arrays]).astype(np.int32)
    dev = torch.from_numpy(flat).to(device, non_blocking=True)
    out, o = [], 0
    for a in arrays:
        out.append(dev[o:o + a.size].view(a.shape))
        o += a.size
    return out


class _DenseEngine:
    """Device, config and weights of the dense-cache engines: ``device``
    defaults to the CUDA card and raises without one (tests pass
    ``device="cpu"``); ``params`` defaults to random weights from
    ``seed``, and given weights are cast once to ``dtype``."""

    def __init__(self, cfg: ModelConfig, params, seed: int,
                 dtype: torch.dtype, device):
        ok, why = supports_dense(cfg)
        if not ok:
            raise NotImplementedError(f"{cfg.name}: {why}")
        if cfg.cache_int8:
            raise NotImplementedError(
                f"{cfg.name}: the padded engines cannot serve an int8 KV "
                f"cache: prefill builds a float cache, as in the "
                f"reference, whose engines cannot serve cache_int8 either;"
                f" an int8 cache comes from init_cache or from quantising "
                f"a prefill cache, for decode_step and decode_multi")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.params = (cast_params(params, dtype) if params is not None
                       else M.init_params(cfg, seed=seed, device=self.device,
                                          dtype=dtype))
        self.host_syncs = 0


def _encode_prompt(req: Request, vocab_size: int) -> List[int]:
    return encode(f"{req.instruction} {req.user_input}", vocab_size)


@dataclasses.dataclass
class ServeResult:
    iterations: int
    batch_size: int
    batch_length: int
    wall_time: float
    wma: int
    total_tokens: int
    valid_tokens: int
    generated: Dict[int, List[int]]   # req_id -> generated token ids
    decode_time: float = 0.0          # decode loop only (prefill excluded)


# A CUDA ``BatchEngine`` captures a batch's decode step when the batch
# runs at least this many steps (G(B)); a batch of fewer decodes eagerly.
# The measured break-even (scripts/padded_graph_breakeven.py: 20 rows at
# full width in bf16, NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): a
# capture costs ~40-50 ms of host time beside an eager step of ~25-45 ms
# and a replayed one of ~10 ms, and the captured batch's decode time is
# the lower from G(B) = 4 for chatglm-6b and mamba2-780m alike; at
# G(B) = 3 it ties or loses.
MIN_GRAPH_STEPS = 4


class BatchEngine(_DenseEngine):
    """Padded batch serving with the real model (vanilla / Magnus
    runtime).

    On the card, each batch of at least ``MIN_GRAPH_STEPS`` decode steps
    captures its decode step as a CUDA graph after its prefill (the
    first step, run eagerly on the batch's state, is the capture's
    warm-up), and every later step of every window is one replay; the
    graph is dropped with the batch.  ``graph_captures`` counts the
    captures and ``capture_time`` sums their host seconds, which
    ``decode_time`` includes, as the reference's includes the jit
    compile at a shape's first call.  A CPU engine decodes eagerly."""

    def __init__(self, cfg: ModelConfig, params=None, *, seed: int = 0,
                 max_gen: int = 64, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(cfg, params, seed, dtype, device)
        self.max_gen = max_gen
        self.graph_captures = 0
        self.capture_time = 0.0
        self._capture_stream: Optional[torch.cuda.Stream] = None

    def _tokens(self, reqs: List[Request], pad_to: int) -> np.ndarray:
        out = np.zeros((len(reqs), pad_to), np.int32)
        for i, r in enumerate(reqs):
            ids = _encode_prompt(r, self.cfg.vocab_size)[:pad_to]
            out[i, :len(ids)] = ids
        return out

    @hot_path
    def serve_batch(self, batch: Batch) -> ServeResult:
        reqs = batch.requests
        t0 = time.perf_counter()
        bl = _bucket(max(r.length for r in reqs))
        lengths = np.array([min(r.length, bl) for r in reqs], np.int32)
        gen_targets = np.array([min(r.gen_length, self.max_gen)
                                for r in reqs], np.int32)
        bg = int(gen_targets.max())
        cache_len = _bucket(bl + bg)
        tokens, positions = _upload(self.device, self._tokens(reqs, bl),
                                    lengths)
        logits, cache = M.prefill(
            self.params, self.cfg, {"tokens": tokens, "lengths": positions},
            act_dtype=self.dtype, cache_len=cache_len)
        # gen_targets are known up front, so the whole decode loop fuses
        # into power-of-two on-device windows.  Decode until the slowest
        # request finishes (request waiting!).  decode_time excludes the
        # prefill: a barrier, not a readback
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_dec = time.perf_counter()
        graph, start = None, 0
        if self.device.type == "cuda" and bg >= MIN_GRAPH_STEPS:
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(device=self.device)
            # the warm-up step is the first window's first step
            graph, start = DecodeGraph.padded(
                self.params, self.cfg, cache, logits, positions,
                act_dtype=self.dtype, max_steps=_pow2_floor(bg),
                stream=self._capture_stream), 1
            self.graph_captures += 1
            self.capture_time += graph.capture_s
        chunks: List[np.ndarray] = []
        remaining = bg
        while remaining > 0:
            k = _pow2_floor(remaining)
            if graph is None:
                logits, cache, positions, toks = M.decode_multi(
                    self.params, self.cfg, cache,
                    {"logits": logits, "positions": positions},
                    num_steps=k, act_dtype=self.dtype)
            else:
                toks, start = graph.window(k, start), 0
            # the window token readback: one sync per window
            chunks.append(toks.cpu().numpy())
            self.host_syncs += count_sync()
            remaining -= k
        toks = (np.concatenate(chunks, axis=1) if chunks
                else np.zeros((len(reqs), 0), np.int32))
        decode_time = time.perf_counter() - t_dec
        generated = {r.req_id: toks[i, :int(gen_targets[i])].tolist()
                     for i, r in enumerate(reqs)}
        wall = time.perf_counter() - t0
        wma = batch_wma([int(l) for l in lengths],
                        [int(g) for g in gen_targets])
        return ServeResult(
            iterations=bg, batch_size=len(reqs), batch_length=bl,
            wall_time=wall, wma=wma, total_tokens=len(reqs) * bg,
            valid_tokens=int(gen_targets.sum()), generated=generated,
            decode_time=decode_time)


class ContinuousEngine(_DenseEngine):
    """Conservative continuous batching with the real model: fixed slots
    over one dense cache ``[L, slots, max_len + max_gen, Hkv, D]``; a
    join prefills alone (a single-request batch) while decoding pauses,
    and every step reads its tokens back."""

    def __init__(self, cfg: ModelConfig, params=None, *, seed: int = 0,
                 slots: int = 4, max_len: int = 256, max_gen: int = 64,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(cfg, params, seed, dtype, device)
        self.slots = slots
        self.max_len = max_len
        self.max_gen = max_gen
        self.cache = M.init_cache(
            cfg, slots, max_len + max_gen,
            dtype=torch.float32 if dtype == torch.float32 else torch.bfloat16,
            device=self.device)
        self.active: List[Optional[dict]] = [None] * slots
        self.logits = torch.zeros((slots, cfg.padded_vocab), dtype=dtype,
                                  device=self.device)
        self.positions = np.zeros(slots, np.int32)   # host mirror

    def _merge_cache_slot(self, slot: int, single_cache) -> None:
        """Copy a single-request prefill cache into slot ``slot``, leaf by
        leaf, each cut or zero-padded along axis 2 to the slot's (a KV
        leaf's capacity; an SSM leaf's axis 2 is equal on both sides, so
        it is copied whole)."""
        for key, leaves in self.cache.items():
            for dst, src in zip(leaves, single_cache[key]):
                n = min(src.shape[2], dst.shape[2])
                dst[:, slot, :n] = src[:, 0, :n].to(dst.dtype)
                dst[:, slot, n:] = 0

    @property
    def has_capacity(self) -> bool:
        return None in self.active

    @hot_path
    def join(self, req: Request) -> int:
        if not self.has_capacity:
            raise EngineFull(
                f"all {self.slots} slots occupied; queue req "
                f"{req.req_id} and retry after step()")
        slot = self.active.index(None)
        ids = _encode_prompt(req, self.cfg.vocab_size)[:self.max_len]
        tokens = np.zeros((1, _bucket(len(ids))), np.int32)
        tokens[0, :len(ids)] = ids
        tokens_t, lengths_t = _upload(self.device, tokens,
                                      np.array([len(ids)], np.int32))
        logits, single_cache = M.prefill(
            self.params, self.cfg, {"tokens": tokens_t, "lengths": lengths_t},
            act_dtype=self.dtype, cache_len=self.max_len + self.max_gen)
        self._merge_cache_slot(slot, single_cache)
        self.logits[slot] = logits[0].to(self.dtype)
        self.positions[slot] = len(ids)
        self.active[slot] = {"req": req, "generated": [],
                             "target": min(req.gen_length, self.max_gen)}
        return slot

    @hot_path
    def step(self) -> List[Request]:
        """One decode iteration over all active slots; returns finished."""
        if not any(self.active):
            return []
        next_tok = torch.argmax(self.logits[:, :self.cfg.vocab_size],
                                dim=-1).to(torch.int32)
        (positions,) = _upload(self.device, self.positions)
        self.logits, self.cache = M.decode_step(
            self.params, self.cfg, self.cache,
            {"tokens": next_tok, "positions": positions},
            act_dtype=self.dtype)
        self.logits = self.logits.to(self.dtype)
        self.positions = self.positions + 1
        # read the tokens back only after the decode step is queued: the
        # copy waits for the argmax, not for the step
        tok_host = next_tok.cpu().numpy()
        self.host_syncs += count_sync()
        for slot, a in enumerate(self.active):
            if a is not None:
                a["generated"].append(int(tok_host[slot]))
        finished = []
        for slot, a in enumerate(self.active):
            if a is not None and len(a["generated"]) >= a["target"]:
                finished.append(a["req"])
                self.active[slot] = None
                self.positions[slot] = 0
        return finished


class PagedContinuousEngine:
    """Continuous batching over a shared physical block pool.

    KV lives in per-layer pools ``[L, num_blocks, block_tokens, Hkv, D]``
    on ``device``; each active request owns a block table (allocator
    seq_id = its slot).  Admission reserves ``L(p) + G'(p)`` tokens of
    blocks; when a request outlives its prediction, decode grows its
    table one block at a time, and if the pool is exhausted the
    least-progress other request is evicted and returned for requeue.

    Block tables, positions, the active mask and the carried logits are
    device tensors, updated in place; host mirrors (``pos_host`` and the
    allocator's tables) carry the scheduling arithmetic and are never
    read back from the device.  A reserved *null block* backs every
    idle/pad table entry, so masked reads and idle-slot writes never
    touch a live request's pages.

    With ``prefix_cache`` (DESIGN.md §11) admission walks a token-id
    radix tree of published prefix blocks: the longest cached prefix is
    shared (ref-counted) and only the suffix runs through the model; a
    match ending mid-block is copy-on-written.  Every admission publishes
    its whole prompt at block boundaries (§12), deferred off the
    admission hot path to ``_flush_publishes``.

    Decode runs in fused windows (``step_window``): ``k`` is the minimum
    over active slots of steps-to-finish and steps-to-block-boundary,
    rounded down to a power of two.  ``fuse=False`` pins ``k = 1`` (the
    per-token baseline: the same streams and steps, one readback a
    step).  On a CUDA engine each step of a window is one replay of the
    captured decode graph (``serving/graphs.py``); a CPU engine runs
    ``decode_multi_paged`` eagerly through the plain versions.
    ``warmup=True`` calls :meth:`warmup` at construction.

    ``device`` defaults to the CUDA card and raises without one; tests
    pass ``device="cpu"``.  ``params`` defaults to random weights from
    ``seed``; given weights are cast once to ``dtype``.
    """

    def __init__(self, cfg: ModelConfig, params=None, *, seed: int = 0,
                 max_concurrency: int = 8, num_blocks: int = 64,
                 block_tokens: int = 16, max_len: int = 256,
                 max_gen: int = 64, dtype: torch.dtype = torch.float32,
                 allocator: Optional[BlockAllocator] = None,
                 prefix_cache=False,
                 mispredict: Optional[MispredictionEWMA] = None,
                 device=None, fuse: bool = True, warmup: bool = False):
        ok, why = M.supports_paged(cfg)
        if not ok:
            raise NotImplementedError(f"{cfg.name}: {why}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        self.max_gen = max_gen
        self.dtype = dtype
        self.fuse = fuse
        self.allocator = allocator if allocator is not None else \
            BlockAllocator(num_blocks, block_tokens)
        if isinstance(prefix_cache, RadixPrefixCache):
            if prefix_cache.allocator is not self.allocator:
                raise ValueError("prefix_cache must share the engine's "
                                 "BlockAllocator (one physical pool)")
            self.prefix_cache: Optional[RadixPrefixCache] = prefix_cache
        else:
            self.prefix_cache = (RadixPrefixCache(self.allocator)
                                 if prefix_cache else None)
        self.bt = self.allocator.block_tokens
        self.slots = max_concurrency
        self.max_blocks = -(-(max_len + max_gen) // self.bt)
        # the null block: every pad/idle table entry points here
        self.null_block = self.allocator.allocate(self._NULL_SEQ, 1)[0]
        self.params = (cast_params(params, dtype) if params is not None
                       else M.init_params(cfg, seed=seed, device=self.device,
                                          dtype=dtype))
        self.pages = M.init_paged_cache(
            cfg, self.allocator.num_blocks, self.bt,
            dtype=torch.float32 if dtype == torch.float32
            else torch.bfloat16, device=self.device)
        b = self.slots
        self.active: List[Optional[dict]] = [None] * b
        self._null_row = torch.full((self.max_blocks,), self.null_block,
                                    dtype=torch.int32, device=self.device)
        self.tables = self._null_row[None, :].repeat(b, 1)
        self.positions = torch.zeros(b, dtype=torch.int32,
                                     device=self.device)
        self.active_mask = torch.zeros(b, dtype=torch.bool,
                                       device=self.device)
        self.pos_host = np.zeros(b, np.int32)
        self.logits = torch.zeros((b, cfg.padded_vocab), dtype=dtype,
                                  device=self.device)
        self.evictions = 0
        self.host_syncs = 0
        self.decode_steps = 0
        self.prefill_tokens = 0   # tokens actually run through a prefill
        self.prefill_dispatches = 0  # variable-prefix wave dispatches
        self.cow_copies = 0       # copy-on-write block clones performed
        self.mispredict = (mispredict if mispredict is not None
                           else MispredictionEWMA())
        self.clock = 0            # scheduler clock: decode iterations
        self.requeue_prefix_hits = 0  # evicted requests readmitted via radix
        self.shed_log: List[Shed] = []
        self.retries: Dict[int, int] = {}        # req_id -> eviction count
        self._observed_gen: Dict[int, int] = {}  # req_id -> max progress
        self._requeued: Set[int] = set()         # req_ids evicted at least once
        self.window_stats: Optional[Dict[str, int]] = None
        self.generated: Dict[int, List[int]] = {}   # finished req -> tokens
        # admission hot-path memo: encoded prompt ids per (instruction,
        # user_input)
        self._ids_memo: Dict[Tuple[str, str], List[int]] = {}
        # radix publishes deferred off the admission hot path
        self._publish_queue: List[Tuple[Tuple[int, ...], List[int]]] = []
        # chains published earlier in the CURRENT admission wave
        self._wave_pending: List[Dict[str, object]] = []
        # the captured decode step (CUDA engines) and how often one was
        # captured: the torch side of the reference's compile audit
        self._decode_graph: Optional[DecodeGraph] = None
        self.graph_captures = 0
        if warmup:
            self.warmup()

    _NULL_SEQ = NULL_SEQ   # allocator seq_id owning the null block
    # eviction-retry budget (§14): a request evicted this many times
    # reserves past its observed progress on readmission
    retry_budget = 3

    # -- host <-> device -----------------------------------------------------

    def _upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        return _upload(self.device, *arrays)

    # -- admission -----------------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(a is not None for a in self.active)

    _IDS_MEMO_CAP = 4096   # bound the prompt memo

    def _prompt_ids(self, req: Request) -> List[int]:
        key = (req.instruction, req.user_input)
        ids = self._ids_memo.get(key)
        if ids is None:
            ids = encode(f"{req.instruction} {req.user_input}",
                         self.cfg.vocab_size)[:self.max_len]
            if len(self._ids_memo) >= self._IDS_MEMO_CAP:
                del self._ids_memo[next(iter(self._ids_memo))]
            self._ids_memo[key] = ids
        return ids

    def _shareable_ids(self, req: Request, ids: List[int]) -> List[int]:
        """The shareable span: the whole prompt, capped one short of its
        end (a prefill needs >= 1 query token to produce logits)."""
        return ids[:len(ids) - 1]

    def _match_wave_pending(self, share_ids: List[int],
                            beat: int) -> Optional[Dict[str, object]]:
        """Longest full-block prefix of ``share_ids`` among chains
        published earlier in the CURRENT wave (radix-aware scheduling,
        DESIGN.md §12).  Full blocks only; only a strictly longer match
        than the tree's ``beat`` wins."""
        best: Optional[Dict[str, object]] = None
        best_tokens = beat
        s1 = share_ids[1] if len(share_ids) > 1 else None
        for e in self._wave_pending:
            ids = e["ids"]
            # two-token gate (every prompt starts with BOS)
            if s1 is not None and self.bt > 1 and len(ids) > 1 \
                    and ids[1] != s1:
                continue
            n = 0
            for a, b in zip(ids, share_ids):
                if a != b:
                    break
                n += 1
            n = n // self.bt * self.bt
            if n >= self.bt and n > best_tokens:
                best_tokens = n
                best = {"tokens": n, "blocks": e["table"][:n // self.bt],
                        "gen": int(e["gen"]) + 1}
        return best

    def _flush_publishes(self) -> None:
        """Insert queued shareable spans into the radix tree (deferred
        off the admission hot path; flushed by the next operation that
        reads the tree or can free blocks)."""
        if self.prefix_cache is None or not self._publish_queue:
            return
        queue, self._publish_queue = self._publish_queue, []
        for ids, table in queue:
            self.prefix_cache.insert(ids, table)

    def reserve_tokens(self, req: Request,
                       n_prompt: Optional[int] = None) -> int:
        """Admission footprint: encoded prompt + *predicted* generation
        tokens, with the per-app misprediction headroom and the
        retry-budget escalation (§14)."""
        if n_prompt is None:
            n_prompt = len(self._prompt_ids(req))
        g = (req.predicted_gen_length
             if req.predicted_gen_length is not None else self.max_gen)
        h = self.mispredict.factor(req.app)
        if h > 1.0:
            g = int(math.ceil(g * h))
        if self.retries.get(req.req_id, 0) >= self.retry_budget:
            g = max(g, self._observed_gen.get(req.req_id, 0) + 1)
        return n_prompt + max(1, min(g, self.max_gen))

    def _reserve(self, req: Request) -> Dict[str, object]:
        """Claim a slot + blocks for ``req`` (raises EngineFull) and mark
        the slot active; the KV pages are written by the caller's wave
        dispatch.  With the radix cache on: match (tree or same-wave
        chain), probe (evict cold leaves or refuse), share the matched
        pages, copy-on-write a partial tail, allocate, queue the
        publish."""
        if None not in self.active:
            raise EngineFull(f"all {self.slots} slots occupied")
        slot = self.active.index(None)
        ids = self._prompt_ids(req)
        share_ids: List[int] = []
        m: Optional[PrefixMatch] = None
        pend: Optional[Dict[str, object]] = None
        looked_up = False
        if self.prefix_cache is not None:
            share_ids = self._shareable_ids(req, ids)
            if share_ids:
                m = self.prefix_cache.match(share_ids)
                looked_up = True
                tree_tokens = m.tokens if m.node is not None else 0
                if m.node is None:
                    m = None
                pend = self._match_wave_pending(share_ids, beat=tree_tokens)
                if pend is not None:
                    if m is None:
                        # the same-wave chain turns a tree miss into a hit
                        self.prefix_cache.misses -= 1
                        self.prefix_cache.hits += 1
                    m = None            # the pending chain supersedes it
        gen = int(pend["gen"]) if pend is not None else 0
        cached = (int(pend["tokens"]) if pend is not None
                  else m.tokens if m is not None else 0)
        full = cached // self.bt * self.bt   # memory actually shared
        want = self.reserve_tokens(req, n_prompt=len(ids))
        if m is not None:
            self.prefix_cache.pin(m.node)   # protect from LRU while admitting
        try:
            need = self.allocator.blocks_needed(want - full)
            if need > len(self.allocator.free):
                if self.prefix_cache is None \
                        or not self.prefix_cache.evict_until(need):
                    raise EngineFull(
                        f"{need} new blocks wanted, "
                        f"{len(self.allocator.free)} free")
            cow = None
            if pend is not None:
                self.allocator.share(slot, pend["blocks"])
            elif m is not None:
                self.allocator.share(slot, m.blocks)
                if cached % self.bt:
                    cow = self.allocator.cow_if_not_appendable(
                        slot, len(m.blocks) - 1)
            table = list(self.allocator.allocate(slot, want))
        except EngineFull:
            if m is not None:
                self.prefix_cache.unpin(m.node)
            if looked_up:
                # a refused admission is retried later: keep the hit/miss
                # counters from inflating
                if m is not None or pend is not None:
                    self.prefix_cache.hits -= 1
                else:
                    self.prefix_cache.misses -= 1
            raise
        if self.prefix_cache is not None and share_ids:
            self._publish_queue.append((tuple(share_ids), list(table)))
            self._wave_pending.append(
                {"ids": share_ids, "table": list(table), "gen": gen})
        if cached and req.req_id in self._requeued:
            self.requeue_prefix_hits += 1
        self.active[slot] = {"req": req, "generated": [],
                             "target": min(req.gen_length, self.max_gen),
                             "prefix": m.node if m is not None else None,
                             "reserve_tokens": want,
                             "reserve_g": want - len(ids)}
        return {"slot": slot, "ids": ids, "table": table, "cached": cached,
                "cow": cow, "gen": gen, "req": req}

    def _dispatch_wave(self, plans: List[Dict[str, object]]) -> None:
        """ONE ``prefill_wave`` call for a group of just-reserved
        requests sharing a suffix-length bucket: copy-on-write clones,
        the variable-prefix prefill, the suffix-KV write and the per-slot
        state update, in place, with nothing read back.  The gather table
        is width-1 all-null for a pure-miss group and ``max_blocks`` wide
        otherwise.  Pad rows repeat row 0's slot and values; their KV
        writes go to the null block via ``write_lens == 0``."""
        n = len(plans)
        nb = _pow2_ceil(n)
        sb = _bucket(max(len(p["ids"]) - p["cached"] for p in plans))
        width = self.max_blocks if any(p["cached"] for p in plans) else 1
        tokens = np.zeros((nb, sb), np.int32)
        lengths = np.ones(nb, np.int32)
        wlens = np.zeros(nb, np.int32)       # write validity: pads drop
        plens = np.zeros(nb, np.int32)
        rows = np.full((nb, self.max_blocks), self.null_block, np.int32)
        src = np.full(nb, self.null_block, np.int32)
        dst = np.full(nb, self.null_block, np.int32)
        slots = np.zeros(nb, np.int32)
        sel = np.zeros(nb, np.int32)
        pos_vals = np.ones(nb, np.int32)
        for i, p in enumerate(plans):
            sfx = p["ids"][p["cached"]:]
            tokens[i, :len(sfx)] = sfx
            lengths[i] = len(sfx)
            wlens[i] = len(sfx)
            plens[i] = p["cached"]
            rows[i, :len(p["table"])] = p["table"]
            slots[i] = p["slot"]
            sel[i] = i
            pos_vals[i] = len(p["ids"])
            if p["cow"] is not None:
                src[i], dst[i] = p["cow"]
                self.cow_copies += 1
            self.prefill_tokens += len(sfx)
        # pad rows repeat row 0's slot/table/position (identical duplicate
        # writes) and keep plens[0] for a valid attention gather
        plens[n:] = plens[0]
        rows[n:] = rows[0]
        slots[n:] = slots[0]
        pos_vals[n:] = pos_vals[0]
        attn = (rows[:, :width] if width > 1
                else np.full((nb, 1), self.null_block, np.int32))
        (tokens_t, lengths_t, plens_t, attn_t, rows_t, wlens_t, src_t, dst_t,
         slots_t, sel_t, pos_t) = self._upload(
            tokens, lengths, plens, attn, rows, wlens, src, dst, slots, sel,
            pos_vals)
        state = {"tables": self.tables, "positions": self.positions,
                 "active": self.active_mask, "logits": self.logits}
        M.prefill_wave(
            self.params, self.cfg, self.pages, state,
            {"tokens": tokens_t, "lengths": lengths_t,
             "prefix_lens": plens_t, "attn_tables": attn_t,
             "tables": rows_t, "write_lens": wlens_t, "cow_src": src_t,
             "cow_dst": dst_t, "slots": slots_t, "row_sel": sel_t,
             "positions": pos_t},
            null_block=self.null_block, act_dtype=self.dtype)
        self.prefill_dispatches += 1
        for p in plans:
            self.pos_host[p["slot"]] = len(p["ids"])

    def _prefill_admitted(self, admitted: List[Dict[str, object]]) -> None:
        """Order the wave radix-aware and dispatch it with the minimum
        number of prefill calls (DESIGN.md §12): same-wave chain sharers
        one generation after their publisher, then one call per
        suffix-length bucket within a generation."""
        gens: Dict[int, List[Dict[str, object]]] = {}
        for a in admitted:
            gens.setdefault(int(a["gen"]), []).append(a)
        for g in sorted(gens):
            buckets: Dict[int, List[Dict[str, object]]] = {}
            for a in gens[g]:
                buckets.setdefault(
                    _bucket(max(len(a["ids"]) - a["cached"], 1)),
                    []).append(a)
            for sb in sorted(buckets):
                self._dispatch_wave(buckets[sb])

    @hot_path
    def join(self, req: Request) -> int:
        self._flush_publishes()
        self._wave_pending = []
        plan = self._reserve(req)
        self._prefill_admitted([plan])
        return int(plan["slot"])

    @hot_path
    def join_many(self, reqs: Iterable[Request]) -> int:
        """Admit the longest admissible prefix of ``reqs`` as ONE
        admission wave; returns how many were admitted (the caller pops
        that many).  Stops at the first request that does not fit."""
        self._flush_publishes()
        self._wave_pending = []
        admitted = []
        for req in reqs:
            try:
                admitted.append(self._reserve(req))
            except EngineFull:
                break
        if admitted:
            self._prefill_admitted(admitted)
        return len(admitted)

    # -- eviction ------------------------------------------------------------

    def _release(self, slot: int) -> None:
        """Reset a slot's device/host state to idle (null table, pos 0)."""
        self.tables[slot] = self._null_row
        self.positions[slot] = 0
        self.active_mask[slot] = False
        self.pos_host[slot] = 0
        self.active[slot] = None

    def _unpin_prefix(self, slot: int) -> None:
        node = self.active[slot].get("prefix")
        if node is not None:
            self.prefix_cache.unpin(node)

    def _evict(self, slot: int) -> Request:
        self._flush_publishes()   # queued spans reference live tables only
        a = self.active[slot]
        req = a["req"]
        self.retries[req.req_id] = self.retries.get(req.req_id, 0) + 1
        if len(a["generated"]) > self._observed_gen.get(req.req_id, 0):
            self._observed_gen[req.req_id] = len(a["generated"])
        self._requeued.add(req.req_id)
        self._unpin_prefix(slot)
        self.allocator.free_seq(slot)     # shared prefix pages survive:
        self._release(slot)               # the cache still holds a reference
        self.evictions += 1
        return req

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """Least decode progress first (cheapest recompute on readmit)."""
        best, best_prog = None, None
        for slot, a in enumerate(self.active):
            if a is None or slot == exclude:
                continue
            prog = len(a["generated"])
            if best is None or prog < best_prog:
                best, best_prog = slot, prog
        return best

    def _grow(self, slot: int,
              evicted: List[Request]) -> List[Tuple[int, int]]:
        """Ensure the slot can hold pos_host[slot] + 1 tokens AND
        privately owns every block the coming window writes into; evict
        on demand (cold radix leaves first, then the least-progress
        request).  Returns the (src, dst) copy-on-write pairs the caller
        applies on the device before decoding."""
        need = int(self.pos_host[slot]) + 1
        if self.allocator.blocks_needed(need) > self.max_blocks:
            raise MemoryError(
                f"request outgrew max_len+max_gen table ({self.max_blocks} "
                f"blocks)")
        # impossible-fit check BEFORE any eviction
        if self.allocator.blocks_needed(need) > self.allocator.num_blocks - 1:
            raise MemoryError(
                f"paged pool ({self.allocator.num_blocks} blocks) smaller "
                f"than one request's "
                f"{self.allocator.blocks_needed(need)}-block KV")
        had = len(self.allocator.tables.get(slot, ()))
        while not self.allocator.can_allocate(slot, need):
            missing = (self.allocator.blocks_needed(need)
                       - len(self.allocator.tables.get(slot, ())))
            if self.prefix_cache is not None \
                    and self.prefix_cache.evict_until(missing):
                continue
            victim = self._pick_victim(exclude=slot)
            if victim is None:
                raise MemoryError(
                    "paged pool exhausted by sequences outside this engine")
            evicted.append(self._evict(victim))
        table = self.allocator.allocate(slot, need)
        a = self.active[slot]
        if len(table) != had and need > a["reserve_tokens"]:
            # growth past the reservation feeds the misprediction EWMA
            self.mispredict.observe(
                a["req"].app, a["reserve_g"],
                need - (a["reserve_tokens"] - a["reserve_g"]))
        # copy-on-write: any still-shared block at or past the write
        # cursor is cloned before the window appends into it
        pairs: List[Tuple[int, int]] = []
        start = int(self.pos_host[slot]) // self.bt
        for idx in range(start, len(table)):
            while self.allocator.refcount.get(table[idx], 0) > 1 \
                    and not self.allocator.free:
                if self.prefix_cache is not None \
                        and self.prefix_cache.evict_until(1):
                    continue
                victim = self._pick_victim(exclude=slot)
                if victim is None:
                    raise MemoryError(
                        "paged pool exhausted by sequences outside this "
                        "engine")
                evicted.append(self._evict(victim))
            pair = self.allocator.cow_if_not_appendable(slot, idx)
            if pair is not None:
                pairs.append(pair)
                self.cow_copies += 1
        if len(table) != had or pairs:
            row = np.full(self.max_blocks, self.null_block, np.int32)
            row[:len(table)] = table
            self.tables[slot] = self._upload(row)[0]
        return pairs

    # -- decode --------------------------------------------------------------

    def _window_steps(self) -> int:
        """Fusion-window length: the minimum over active slots of
        steps-to-finish and steps-to-block-boundary, so no finish / grow /
        evict event falls inside the window (the §9 invariant)."""
        k = self.max_gen
        for slot, a in enumerate(self.active):
            if a is None:
                continue
            to_finish = a["target"] - len(a["generated"])
            cap = len(self.allocator.tables[slot]) * self.bt
            to_boundary = cap - int(self.pos_host[slot])
            k = min(k, to_finish, to_boundary)
        return max(k, 1)

    def step_window(self, max_steps: Optional[int] = None
                    ) -> Tuple[List[Request], List[Request], int]:
        """Run one fused decode window over all active requests.
        Returns (finished, evicted, steps_run); evicted requests must be
        requeued by the caller (they restart from scratch on readmit)."""
        evicted: List[Request] = []
        if not any(a is not None for a in self.active):
            return [], [], 0
        # deferred radix publishes land here, before any grow/evict/finish
        # could free a queued span's blocks
        self._flush_publishes()
        try:
            for slot, a in enumerate(self.active):
                if a is None:
                    continue
                pairs = self._grow(slot, evicted)
                # apply this slot's COW copies IMMEDIATELY: a later slot's
                # _grow may evict this one and recycle its clone block
                if pairs:
                    npairs = _pow2_ceil(len(pairs))
                    src = np.full(npairs, self.null_block, np.int32)
                    dst = np.full(npairs, self.null_block, np.int32)
                    for i, (s, d) in enumerate(pairs):
                        src[i], dst[i] = s, d
                    M.copy_pages(self.pages, *self._upload(src, dst))
        except MemoryError as e:
            # the culprit slot is freed (and attached) so the engine stays
            # serviceable and drainable after the raise
            culprit = (self._evict(slot)
                       if self.active[slot] is not None else None)
            raise PoolExhausted(str(e), evicted=tuple(evicted),
                                culprit=culprit) from e
        if not any(a is not None for a in self.active):
            self.window_stats = None
            return [], evicted, 0
        k = self._window_steps()
        if max_steps is not None:
            k = max(1, min(k, max_steps))
        # power-of-two windows: O(log max_gen) distinct window lengths
        k = _pow2_floor(k) if self.fuse else 1
        # post-grow/evict snapshot: lets drivers reconstruct the
        # per-iteration utilization ramp
        self.window_stats = {
            "live0": int(sum(int(self.pos_host[s])
                             for s, a in enumerate(self.active)
                             if a is not None)),
            "active": self.num_active,
            "used_tokens": self.allocator.used_blocks * self.bt,
        }
        toks = self._decode(k)
        # the one window token readback (§9 fused decode)
        toks = toks.cpu().numpy()
        self.host_syncs += count_sync()
        self.decode_steps += k
        self.clock += k
        finished = []
        for slot, a in enumerate(self.active):
            if a is None:
                continue
            a["generated"].extend(toks[slot, :k].tolist())
            self.pos_host[slot] += k
            if len(a["generated"]) >= a["target"]:
                finished.append(a["req"])
                self.generated[a["req"].req_id] = a["generated"]
                self.mispredict.observe(a["req"].app, a["reserve_g"],
                                        len(a["generated"]))
                self._unpin_prefix(slot)
                self.allocator.free_seq(slot)
                self._release(slot)
        return finished, evicted, k

    def _decode(self, k: int) -> torch.Tensor:
        """``k`` greedy decode steps over every slot, written into the
        engine's tensors in place; returns the tokens ``[B, k]`` on the
        device.  A CUDA engine replays its captured step, capturing it
        first if no window or ``warmup()`` has (that window's first step
        is then the capture's warm-up step, so each step still runs
        once); a CPU engine runs ``decode_multi_paged``."""
        if self.device.type == "cpu":
            logits, _, positions, toks = M.decode_multi_paged(
                self.params, self.cfg, self.pages,
                {"logits": self.logits, "positions": self.positions,
                 "block_tables": self.tables, "active": self.active_mask},
                num_steps=k, act_dtype=self.dtype)
            self.logits.copy_(logits)
            self.positions.copy_(positions)
            return toks
        start = 0
        if self._decode_graph is None:
            self._decode_graph = DecodeGraph.paged(self, live=True)
            self.graph_captures += 1
            start = 1
        return self._decode_graph.window(k, start)

    # -- warmup ---------------------------------------------------------------

    def warmup(self, *, suffix_buckets: Optional[List[int]] = None,
               batch_sizes: Optional[List[int]] = None,
               windows: Optional[List[int]] = None) -> None:
        """Run the serve path's shapes once before serving (the
        reference's ``warmup``, which pre-compiles them): the
        variable-prefix wave at every (batch bucket x suffix bucket x
        gather-table width) shape, the grow path's copy-on-write copy at
        every power of two up to ``slots`` (with the prefix cache), and
        the decode.  On a CUDA engine the decode step is captured here
        (once per engine; a second call captures nothing), so that a
        serve after ``warmup()`` captures nothing; a CPU engine runs the
        fused decode at every window in ``windows``.

        Nothing is written that a live request could read: the waves
        have ``write_lens == 0`` and null-to-null copy-on-write pairs,
        and update sacrificial copies of the slot state; the decode runs
        on an idle state (null tables, position 0, no slot active), so
        its junk lands in the null block only.  The defaults are the
        reference's."""
        if suffix_buckets is None:
            top = _bucket(self.max_len)
            suffix_buckets = [b for b in _BUCKETS if b <= top]
            nxt = _BUCKETS[-1] * 2          # pow2 tail for max_len > table
            while nxt <= top:
                suffix_buckets.append(nxt)
                nxt *= 2
            suffix_buckets = suffix_buckets or [top]
        if batch_sizes is None:
            batch_sizes, n = [], 1
            while n < self.slots:
                batch_sizes.append(n)
                n <<= 1
            batch_sizes.append(n)
        if windows is None:
            windows, k = [], 1
            while k <= max(self.max_gen, 1):
                windows.append(k)
                k <<= 1
        widths = [1] + ([self.max_blocks]
                        if self.prefix_cache is not None else [])
        for nb in batch_sizes:
            zeros = np.zeros(nb, np.int32)
            nulls = np.full(nb, self.null_block, np.int32)
            for sb in suffix_buckets:
                for w in widths:
                    (tokens, lengths, plens, attn, rows, wlens, src, dst,
                     slots, sel, pos) = self._upload(
                        np.zeros((nb, sb), np.int32), np.ones(nb, np.int32),
                        zeros, np.full((nb, w), self.null_block, np.int32),
                        np.full((nb, self.max_blocks), self.null_block,
                                np.int32), zeros, nulls, nulls, zeros, zeros,
                        zeros)
                    state = {"tables": self.tables.clone(),
                             "positions": self.positions.clone(),
                             "active": self.active_mask.clone(),
                             "logits": self.logits.clone()}
                    M.prefill_wave(
                        self.params, self.cfg, self.pages, state,
                        {"tokens": tokens, "lengths": lengths,
                         "prefix_lens": plens, "attn_tables": attn,
                         "tables": rows, "write_lens": wlens,
                         "cow_src": src, "cow_dst": dst, "slots": slots,
                         "row_sel": sel, "positions": pos},
                        null_block=self.null_block, act_dtype=self.dtype)
        if self.prefix_cache is not None:
            # grow-path copy-on-write copies pad to a power of two <=
            # slots; null -> null clones leave the pool unchanged
            k = 1
            while k <= _pow2_ceil(self.slots):
                nulls = np.full(k, self.null_block, np.int32)
                M.copy_pages(self.pages, *self._upload(nulls, nulls))
                k <<= 1
        if self.device.type == "cuda":
            if self._decode_graph is None:
                self._decode_graph = DecodeGraph.paged(self, live=False)
                self.graph_captures += 1
            return
        b = self.slots
        for k in windows:
            M.decode_multi_paged(
                self.params, self.cfg, self.pages,
                {"logits": self.logits.clone(),
                 "positions": torch.zeros_like(self.positions),
                 "block_tables": self._null_row[None, :].repeat(b, 1),
                 "active": torch.zeros_like(self.active_mask)},
                num_steps=k, act_dtype=self.dtype)

    def utilization(self) -> float:
        """1 - internal fragmentation over live tokens (null block counts
        as overhead)."""
        live = int(sum(int(self.pos_host[s])
                       for s, a in enumerate(self.active) if a is not None))
        return self.allocator.utilization(live)

    def assert_drained(self) -> None:
        """Teardown invariant (DESIGN.md §13): with every request finished
        or evicted, the only live allocation is the null block and every
        refcount is explained by the tables + the radix cache's retained
        references.  Raises ``BlockLeakError`` otherwise."""
        self._flush_publishes()
        _san.check_engine_drained(self)


def drive_paged(engine: PagedContinuousEngine, requests: List[Request], *,
                max_steps: int = 2_000, refill=None, backlog=None,
                stall_limit: int = 64) -> Dict[str, object]:
    """The canonical paged serve loop: batched admission until the engine
    refuses, fused decode windows, evictions requeued at the queue front.

    ``refill(steps)`` (optional) is called whenever the local queue
    drains and may return more requests (an external scheduler's next
    admission wave); ``backlog()`` (optional) reports whether that
    scheduler still holds work, keeping the loop alive.  A
    ``PoolExhausted`` window sheds the culprit with reason ``oom`` and
    requeues the rest; ``stall_limit`` consecutive idle iterations with
    no progress shed the queue head (``admission_stalled``) instead of
    hanging.

    ``steps`` counts decode iterations, not windows; ``util`` holds one
    sample per decode iteration; ``host_syncs`` is the device-to-host
    readback count."""
    pending: Deque[Request] = deque(requests)
    served = steps = peak = evictions = no_progress = 0
    syncs0 = engine.host_syncs
    shed0 = len(engine.shed_log)

    def _shed(req: Request, reason: str) -> None:
        engine.shed_log.append(Shed(req, reason, engine.clock))

    util: List[float] = []
    while (pending or engine.num_active
           or (backlog() if backlog is not None else False)) \
            and steps < max_steps:
        admitted = 0
        while True:
            n = engine.join_many(pending)
            admitted += n
            for _ in range(n):
                pending.popleft()
            if pending or refill is None:
                break                        # head does not fit / no source
            more = refill(steps)
            if not more:
                break
            pending.extend(more)
        if not (pending or engine.num_active
                or (backlog() if backlog is not None else False)):
            break
        peak = max(peak, engine.num_active)
        try:
            finished, evicted, k = engine.step_window(
                max_steps=max_steps - steps)
        except PoolExhausted as e:
            if e.culprit is not None:
                _shed(e.culprit, "oom")
            evictions += len(e.evicted)
            for r in reversed(e.evicted):
                pending.appendleft(r)
            steps += 1
            no_progress += 1
            continue
        served += len(finished)
        evictions += len(evicted)
        for r in reversed(evicted):
            pending.appendleft(r)
        # reconstruct the per-iteration utilization ramp from the
        # window's post-grow snapshot
        ws = engine.window_stats
        if k > 1 and ws is not None and ws["used_tokens"] > 0:
            util.extend((ws["live0"] + i * ws["active"]) / ws["used_tokens"]
                        for i in range(1, k))
        util.append(engine.utilization())
        steps += max(k, 1)
        if admitted or finished:
            no_progress = 0
        elif not engine.num_active:
            no_progress += 1
            if no_progress >= stall_limit and pending:
                _shed(pending.popleft(), "admission_stalled")
                no_progress = 0
    return {"served": served, "steps": steps, "peak": peak,
            "evictions": evictions, "util": util,
            "host_syncs": engine.host_syncs - syncs0,
            "unserved": list(pending),
            "shed": list(engine.shed_log[shed0:]),
            "requeue_prefix_hits": engine.requeue_prefix_hits,
            "retries_max": max(engine.retries.values(), default=0)}
