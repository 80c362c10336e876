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
  reads its tokens back every step, as in the reference, while the rest
  of the step runs).  On the card every engine replays its decode step
  as a captured CUDA graph (``serving/graphs.py``): the paged engine
  captures once, at its first window or ahead of time in ``warmup()``,
  ``BatchEngine`` once per batch, on the batch's own cache, and
  ``ContinuousEngine`` once, at its first step.  This is the port's
  counterpart of the reference's one compiled program per window.
- Admission is a single-dispatch variable-prefix wave (§12): radix hits
  and misses ride one ``prefill_wave`` call per suffix-length bucket.
- The paged engine's lifecycle (§14): scripted faults
  (``serving/faults.py``), deadlines, the misprediction guard rails
  (EWMA headroom, retry-budget escalation) and the NaN/Inf quarantine;
  and its host swap tier (§15): pool pressure suspends a victim's pages
  to host memory (pinned on the card) and resumes it later with zero
  re-prefilled tokens.  Every write these paths make into the tensors a
  captured decode graph reads (logits, positions, tables, active mask,
  pools) is in place, so the graph never decodes from a stale tensor.
- Speculative decoding on the paged engine (§16): a draft model with a
  pool of its own in the same allocator proposes ``draft_k`` tokens a
  window, the target verifies them in one batched pass, and rollback is
  block-table truncation.  On the card the whole window (draft steps
  and verify) is one captured CUDA graph per engine.
- Crash-safe serving on the paged engine (§17): ``drive_paged`` journals
  every admission write-ahead through a ``serving.snapshot``
  ``RecoveryManager``, which snapshots the whole engine every few
  windows (:meth:`PagedContinuousEngine.snapshot`, two counted
  readbacks); ``serving.snapshot.recover`` restores the last snapshot
  into a fresh engine (:meth:`PagedContinuousEngine.restore`, in place,
  so a graph captured before it reads the restored state) and replays
  the journal's unfinished requests.

Generation is length-scripted replay (DESIGN.md §7): logits come from the
real model, and a request stops at its ground-truth generation length.

The padded engines serve every family with a float cache: dense, MoE
(with GQA, or MLA's latent cache for deepseek-v3), SSM (mamba2), hybrid
(hymba: KV and recurrent state in one cache), vlm (internvl2: zero
patches in front of every prompt, as in the reference) and
encoder-decoder (whisper: zero audio frames through the encoder, the
self and cross K/V in one cache); the paged engine serves the dense and
MoE families without MLA.
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
from repro_torch.core.types import Batch, Request
from repro_torch.core.wma import batch_wma
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.transformer import cast_params
from repro_torch.serving.faults import FaultInjector, Shed
from repro_torch.serving.paged_cache import (BlockAllocator, HostSwapTier,
                                             MispredictionEWMA, NULL_SEQ,
                                             PrefixMatch, RadixPrefixCache)
from repro_torch.serving.graphs import DecodeGraph, SpecGraph, \
    spec_window_into
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


_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int, buckets=_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return _pow2_ceil(n)


def _bucket_list(top: int) -> List[int]:
    """Every bucket a length up to the bucket ``top`` pads to: the table's
    buckets up to ``top``, then its power-of-two tail."""
    out = [b for b in _BUCKETS if b <= top]
    nxt = _BUCKETS[-1] * 2
    while nxt <= top:
        out.append(nxt)
        nxt *= 2
    return out or [top]


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (max(n, 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    n = max(n, 1)
    return 1 << (n - 1).bit_length() if n & (n - 1) else n


def _restore_slot(tables: torch.Tensor, positions: torch.Tensor,
                  active: torch.Tensor, logits: torch.Tensor, slot: int,
                  row: torch.Tensor, pos: torch.Tensor,
                  logits_row: torch.Tensor) -> None:
    """§15 resume: restore a suspended slot's four engine tensors, in
    place (the reference's compiled ``_restore_slot`` returns four new
    arrays; a captured decode graph reads these very tensors).  ``row``
    [M] and ``pos`` [1] are on the engine's device; ``logits_row`` is the
    host copy of the slot's logits in their own dtype, copied back bit
    for bit, asynchronously from pinned memory on the card."""
    tables[slot].copy_(row)
    positions[slot:slot + 1].copy_(pos)
    # fill_, not ``active[slot] = True``: an index write of a Python
    # value copies it from the host and waits for the device
    active[slot].fill_(True)
    logits[slot].copy_(logits_row, non_blocking=True)


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

    def _patches(self, rows: int) -> torch.Tensor:
        """The vlm family's image input: zero patches [rows, P, d] in the
        engine's dtype, as the reference's engines feed (the vision
        tower is a stub there too)."""
        return torch.zeros((rows, self.cfg.num_patches, self.cfg.d_model),
                           dtype=self.dtype, device=self.device)

    def _frontend(self, batch_in: Dict[str, torch.Tensor],
                  rows: int) -> Dict[str, torch.Tensor]:
        """``batch_in`` with the family's stubbed front-end input: the
        vlm family's patches (:meth:`_patches`), the encoder-decoder
        family's audio frames, zeros [rows, encoder_seq, d] in the
        engine's dtype, as the reference's engines feed (the codec front
        end is a stub there too)."""
        if self.cfg.family == "vlm":
            batch_in["patches"] = self._patches(rows)
        if self.cfg.family == "audio":
            batch_in["frames"] = torch.zeros(
                (rows, self.cfg.encoder_seq, self.cfg.d_model),
                dtype=self.dtype, device=self.device)
        return batch_in


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
        vlm = self.cfg.family == "vlm"
        cache_len = _bucket(bl + bg + (self.cfg.num_patches if vlm else 0))
        tokens, positions = _upload(self.device, self._tokens(reqs, bl),
                                    lengths)
        batch_in = self._frontend({"tokens": tokens, "lengths": positions},
                                  len(reqs))
        logits, cache = M.prefill(self.params, self.cfg, batch_in,
                                  act_dtype=self.dtype, cache_len=cache_len)
        # gen_targets are known up front, so the whole decode loop fuses
        # into power-of-two on-device windows.  Decode until the slowest
        # request finishes (request waiting!).  decode_time excludes the
        # prefill: a barrier, not a readback
        if self.device.type == "cuda":
            # hotlint: sync(uncounted: decode_time barrier, not a readback)
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
            # hotlint: sync(window token readback — one sync per window)
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
    and every step reads its tokens back.

    A step argmaxes the carried logits into :attr:`tokens` and queues
    their copy to the host, then runs the rest of the step
    (``model.decode_step_fed_into``) on the engine's cache, logits and
    :attr:`device_positions`, all written in place.  The host waits for
    the tokens' copy only, so its bookkeeping and the next step's
    enqueue overlap the step on the card, as the reference's readback
    overlaps its compiled step.  On the card the rest of the step is one
    CUDA graph (``DecodeGraph.continuous``), captured at the engine's
    first ``step()`` (live: the warm-up is that step, as the reference
    compiles at its first call) and replayed at every later one;
    ``graph_captures`` counts the captures and ``capture_time`` sums
    their host seconds.  A CPU engine runs the same step eagerly.

    The cache is sized without the vlm family's patch prefix, as in the
    reference: a join whose patches plus prompt bucket exceed
    ``max_len + max_gen`` ring-packs its prefill into the slot (the last
    ``max_len + max_gen`` positions), so its decode no longer reads the
    first patches (ROADMAP §3)."""

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
        self.device_positions = torch.zeros(slots, dtype=torch.int32,
                                            device=self.device)
        self.tokens = torch.zeros(slots, dtype=torch.int32,
                                  device=self.device)
        cuda = self.device.type == "cuda"
        self._tokens_host = torch.zeros(slots, dtype=torch.int32,
                                        pin_memory=cuda)
        self._tokens_ready = torch.cuda.Event() if cuda else None
        self._graph: Optional[DecodeGraph] = None
        self.graph_captures = 0
        self.capture_time = 0.0

    # device-resident attrs: hotlint taints reads of these in hot regions,
    # and the captured step reads every one of them, so each is written
    # in place (positions is the HOST mirror, deliberately absent)
    _DEVICE_STATE = ("cache", "logits", "device_positions", "tokens")

    def _merge_cache_slot(self, slot: int, single_cache) -> None:
        """Copy a single-request prefill cache into slot ``slot``, leaf by
        leaf, each cut or zero-padded along axis 2 to the slot's (a KV
        leaf's capacity; the encoder-decoder family's cross leaves, from
        the encoder's padded rows to ``encoder_seq``; an SSM leaf's axis
        2 is equal on both sides, so it is copied whole)."""
        for key, leaves in self.cache.items():
            for dst, src in zip(leaves, single_cache[key]):
                n = min(src.shape[2], dst.shape[2])
                dst[:, slot, :n] = src[:, 0, :n].to(dst.dtype)
                dst[:, slot, n:].zero_()

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
        batch_in = self._frontend({"tokens": tokens_t,
                                   "lengths": lengths_t}, 1)
        logits, single_cache = M.prefill(
            self.params, self.cfg, batch_in, act_dtype=self.dtype,
            cache_len=self.max_len + self.max_gen)
        self._merge_cache_slot(slot, single_cache)
        self.logits[slot] = logits[0].to(self.dtype)
        self.positions[slot] = len(ids)
        self.device_positions[slot].fill_(len(ids))
        self.active[slot] = {"req": req, "generated": [],
                             "target": min(req.gen_length, self.max_gen)}
        return slot

    def _decode(self) -> None:
        """The step after its argmax, in place: a CUDA engine replays its
        captured graph, capturing it at its first step (whose warm-up is
        this step, so it runs once); a CPU engine runs it eagerly."""
        if self.device.type == "cpu":
            M.decode_step_fed_into(
                self.params, self.cfg, self.cache,
                {"logits": self.logits, "positions": self.device_positions,
                 "tokens": self.tokens}, act_dtype=self.dtype)
        elif self._graph is None:
            self._graph = DecodeGraph.continuous(self)
            self.graph_captures += 1
            self.capture_time += self._graph.capture_s
        else:
            self._graph.replay()

    @hot_path
    def step(self) -> List[Request]:
        """One decode iteration over all active slots; returns finished."""
        if not any(self.active):
            return []
        M.greedy_token_into(self.cfg, self.logits, self.tokens)
        # the tokens' copy is queued ahead of the rest of the step, and
        # the host waits for it alone
        self._tokens_host.copy_(self.tokens, non_blocking=True)
        if self._tokens_ready is not None:
            self._tokens_ready.record()
        self._decode()
        self.positions = self.positions + 1
        if self._tokens_ready is not None:
            # hotlint: sync(per-step token readback, overlapped with decode)
            self._tokens_ready.synchronize()
            self.host_syncs += count_sync()
        else:
            self.host_syncs += count_sync()
        tok_host = self._tokens_host.numpy()
        for slot, a in enumerate(self.active):
            if a is not None:
                a["generated"].append(int(tok_host[slot]))
        finished = []
        for slot, a in enumerate(self.active):
            if a is not None and len(a["generated"]) >= a["target"]:
                finished.append(a["req"])
                self.active[slot] = None
                self.positions[slot] = 0
                self.device_positions[slot].fill_(0)
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

    Lifecycle (§14): ``faults`` replays a scripted
    :class:`~repro_torch.serving.faults.FaultInjector` plan at window
    boundaries; ``default_ttl`` gives every request without its own
    ``ttl_steps`` a deadline in scheduler-clock ticks (an expired request
    is a typed shed); a request evicted ``retry_budget`` times reserves
    past its observed progress on readmission; ``nan_guard`` (default:
    on exactly when ``faults`` is given) reads back one finite flag per
    slot each window and quarantines a slot whose logits are not finite.
    Host swap tier (§15): ``swap_blocks`` > 0 host page slots let pool
    pressure suspend a victim instead of destroying it; it resumes with
    zero re-prefilled tokens.  The swap paths run eagerly between
    windows, never inside the captured graph.

    Speculative decoding (§16): with ``spec_decode`` a draft model
    (``draft_cfg``, default the target's; ``draft_params``, default the
    target's own weight tensors for a self-draft, else random from
    ``draft_seed``) keeps a pool of its own, carved out of the same
    allocator, and each window proposes ``draft_k`` tokens per slot that
    the target verifies in one batched pass: the longest agreeing prefix
    is accepted on the device, and the host reads back one packed
    ``[B, draft_k + 2]`` array, one sync a window.  Greedy streams equal
    the spec-off engine's.  It needs ``fuse=True`` and a draft of the
    target's vocab.  A CUDA spec engine captures the whole window (the
    draft's steps and the verify) as one graph and never captures the
    plain decode step.

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
                 faults: Optional[FaultInjector] = None,
                 retry_budget: int = 3,
                 default_ttl: Optional[int] = None,
                 mispredict: Optional[MispredictionEWMA] = None,
                 nan_guard: Optional[bool] = None,
                 swap_blocks: int = 0,
                 spec_decode: bool = False, draft_k: int = 4,
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_params=None, draft_seed: int = 1,
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
        # §16: a speculative window writes up to draft_k lookahead KV
        # positions past the accepted stream before rollback truncates
        # them, so the tables cover that overshoot
        self.max_blocks = -(-(max_len + max_gen
                              + (draft_k if spec_decode else 0)) // self.bt)
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
        # -- fault lifecycle (DESIGN.md §14) ------------------------------
        self.faults = faults
        self.retry_budget = retry_budget
        self.default_ttl = default_ttl
        self.mispredict = (mispredict if mispredict is not None
                           else MispredictionEWMA())
        # NaN/Inf logits quarantine: on when faults are injected unless
        # forced either way (its per-window readback must not tax
        # fault-free serving)
        self._nan_guard = (nan_guard if nan_guard is not None
                           else faults is not None)
        self.clock = 0            # scheduler clock: decode iters + stalls
        self.windows = 0          # step_window calls (fault-plan time base)
        self.stall_ticks = 0
        self.deadline_misses = 0
        self.quarantined = 0      # NaN/Inf-poisoned slots removed
        self.guard_readbacks = 0  # NaN-guard readbacks (in host_syncs)
        self.requeue_prefix_hits = 0  # evicted requests readmitted via radix
        self.shed_log: List[Shed] = []
        self.retries: Dict[int, int] = {}        # req_id -> eviction count
        self._observed_gen: Dict[int, int] = {}  # req_id -> max progress
        self._requeued: Set[int] = set()         # req_ids evicted at least once
        # -- host swap tier (DESIGN.md §15) --------------------------------
        # its store is allocated here, not at the first swap-out, so no
        # suspension pays for it; page-locked on the card, so the copies
        # between the pools and the store are asynchronous on the
        # engine's stream; plain CPU tensors otherwise
        pool = self.pages[sorted(self.pages)[0]]
        self.swap: Optional[HostSwapTier] = (
            HostSwapTier(swap_blocks,
                         (len(self.pages), pool.shape[0]) + pool.shape[2:],
                         pool.dtype, pin_memory=self.device.type == "cuda")
            if swap_blocks > 0 else None)
        self._swapped: Dict[int, Dict[str, object]] = {}  # req_id -> image
        # req_ids suspended and not yet resumed: an admission of one
        # through the prefill path is a re-prefill §15 forbids, counted
        self._swap_debt: Set[int] = set()
        self.swap_outs = 0
        self.swap_ins = 0
        self.swapped_blocks = 0        # host page copies performed
        self.swap_reused_blocks = 0    # dedup/device-shared: no copy
        self.reprefilled_swapped_tokens = 0
        self.swapped_ctx_tokens = 0    # context length at each suspension
        self.swap_in_s = 0.0           # host time inside _swap_in
        # -- crash-safe serving (DESIGN.md §17) ----------------------------
        # write-ahead admission journal hook (a RecoveryManager attaches
        # its journal here; None = durability off, zero-cost)
        self.journal = None
        # req_ids whose progress a restored snapshot already covers: a
        # re-prefill of one after restore is a recovery bug, counted
        self._restored_ids: Set[int] = set()
        self.replayed_reprefill_tokens = 0
        # -- speculative decoding (DESIGN.md §16) ------------------------
        # the draft's pool is carved out of the SAME allocator, so
        # admission, grow and the §13/§15 pressure valves see its
        # footprint like the target's
        self.spec_decode = bool(spec_decode)
        self.draft_k = int(draft_k)
        self.spec_w = self.draft_k + 1
        self.draft_cfg: Optional[ModelConfig] = None
        self.draft_params = None
        self.draft_pages = None
        self.draft_tables: Optional[torch.Tensor] = None
        self.draft_logits: Optional[torch.Tensor] = None
        self.spec_windows = 0
        self.spec_slot_windows = 0   # verify rows: active slots x windows
        self.spec_emitted = 0        # tokens emitted by speculative windows
        self.spec_accepted = 0       # draft proposals accepted (emitted - 1)
        self.spec_drafted = 0        # draft proposals offered (k per row)
        self.draft_quarantined = 0   # drafts iced for good by the guard
        self.draft_prefill_tokens = 0    # draft-pool admission prefills
        self.draft_reprefill_tokens = 0  # draft rebuilds at swap resume
        if spec_decode:
            if draft_k < 1:
                raise ValueError("draft_k must be >= 1")
            if not fuse:
                raise ValueError("spec_decode requires the fused window "
                                 "path (fuse=True)")
            dcfg = draft_cfg if draft_cfg is not None else cfg
            ok, why = M.supports_paged(dcfg)
            if not ok:
                raise NotImplementedError(f"draft {dcfg.name}: {why}")
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "draft vocab must match the target vocab "
                    f"({dcfg.vocab_size} != {cfg.vocab_size}): proposals "
                    "are consumed verbatim by the target's embedding")
            self.draft_cfg = dcfg
            # a self-draft (no draft config or weights given) shares the
            # target's weight tensors: every proposal must verify
            self.draft_params = (
                cast_params(draft_params, dtype) if draft_params is not None
                else self.params if draft_cfg is None
                else M.init_params(dcfg, seed=draft_seed, device=self.device,
                                   dtype=dtype))
            self.draft_pages = M.init_paged_cache(
                dcfg, self.allocator.num_blocks, self.bt,
                dtype=torch.float32 if dtype == torch.float32
                else torch.bfloat16, device=self.device)
            self.draft_tables = self._null_row[None, :].repeat(b, 1)
            self.draft_logits = torch.zeros((b, dcfg.padded_vocab),
                                            dtype=dtype, device=self.device)
        self.window_stats: Optional[Dict[str, int]] = None
        self.generated: Dict[int, List[int]] = {}   # finished req -> tokens
        # admission hot-path memo: encoded prompt ids per (instruction,
        # user_input)
        self._ids_memo: Dict[Tuple[str, str], List[int]] = {}
        # radix publishes deferred off the admission hot path
        self._publish_queue: List[Tuple[Tuple[int, ...], List[int]]] = []
        # chains published earlier in the CURRENT admission wave
        self._wave_pending: List[Dict[str, object]] = []
        # the captured decode step, or speculative window (CUDA engines),
        # and how often one was captured: the torch side of the
        # reference's compile audit
        self._decode_graph: Optional[DecodeGraph] = None
        self._spec_graph: Optional[SpecGraph] = None
        self.graph_captures = 0
        if warmup:
            self.warmup()

    _NULL_SEQ = NULL_SEQ   # allocator seq_id owning the null block

    # device-resident attrs: hotlint taints reads of these in hot regions,
    # and flags any rebinding of them once a captured graph reads them
    # (pos_host and the allocator tables are HOST mirrors, deliberately
    # absent: reading them costs nothing)
    _DEVICE_STATE = ("pages", "tables", "positions", "active_mask", "logits",
                     "draft_pages", "draft_tables", "draft_logits",
                     "_null_row")

    # §16: the allocator seq_ids owning a slot's DRAFT pool blocks live in
    # a negative band of their own, apart from NULL_SEQ (-1) and the
    # fault injector's FAULT_SEQ (-2), so drain checks and shadow reports
    # name the pool that leaked
    _DRAFT_SEQ_BASE = -100

    def _draft_seq(self, slot: int) -> int:
        return self._DRAFT_SEQ_BASE - slot

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
        if self.faults is not None:
            # §17 crash seam: mid-publish, queued spans not yet in the tree
            self.faults.crash_due("publish", self.windows)
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
        if self.faults is not None:
            g = self.faults.corrupt_prediction(req, g, self.windows)
        h = self.mispredict.factor(req.app)
        if h > 1.0:
            g = int(math.ceil(g * h))
        if self.retries.get(req.req_id, 0) >= self.retry_budget:
            g = max(g, self._observed_gen.get(req.req_id, 0) + 1)
        return n_prompt + max(1, min(g, self.max_gen))

    def _reclaimable_blocks(self, keep=None) -> int:
        """Blocks radix leaf-LRU eviction would actually free: blocks of
        unpinned evictable nodes (``keep``'s path excluded) referenced by
        no live table."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.reclaimable_blocks(keep=keep)

    def can_admit(self, req: Request) -> bool:
        """Would :meth:`join` succeed right now?  Counts free blocks plus
        what cache eviction could reclaim, minus the fully-shared blocks a
        radix hit would not need to claim, plus a speculative engine's
        private draft copy of the reservation.  Flushes deferred
        publishes first, exactly like :meth:`join`, so the answer
        reflects the tree state the join it predicts would see."""
        self._flush_publishes()
        if None not in self.active:
            return False
        ids = self._prompt_ids(req)
        want = self.reserve_tokens(req, n_prompt=len(ids))
        keep, full = None, 0
        if self.prefix_cache is not None:
            share = self._shareable_ids(req, ids)
            if share:
                m = self.prefix_cache.match(share, peek=True)
                keep = m.node
                full = m.full_blocks(self.bt) * self.bt
        need = self.allocator.blocks_needed(want - full)
        if self.spec_decode:
            # the draft pool shares nothing (no radix for drafts): a full
            # private copy of the reservation rides every admission
            need += self.allocator.blocks_needed(want)
        return need <= (len(self.allocator.free)
                        + self._reclaimable_blocks(keep=keep))

    def _reserve(self, req: Request) -> Dict[str, object]:
        """Claim a slot + blocks for ``req`` (raises EngineFull) and mark
        the slot active; the KV pages are written by the caller's wave
        dispatch.  With the radix cache on: match (tree or same-wave
        chain), probe (evict cold leaves or refuse), share the matched
        pages, copy-on-write a partial tail, allocate, queue the
        publish.  A speculative engine also claims the slot's draft pool,
        a private copy of the reservation, last."""
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
            if self.spec_decode:
                # §16: the slot's draft pool claims a full private copy
                # of the reservation (drafts never share radix blocks)
                need += self.allocator.blocks_needed(want)
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
        draft_table: List[int] = []
        if self.spec_decode:
            # allocated last, after every refusable step: an EngineFull
            # above leaves no half-claimed draft pool to roll back.  The
            # probe counted these blocks, so this allocate cannot fail
            draft_table = list(self.allocator.allocate(
                self._draft_seq(slot), want))
        if self.prefix_cache is not None and share_ids:
            self._publish_queue.append((tuple(share_ids), list(table)))
            self._wave_pending.append(
                {"ids": share_ids, "table": list(table), "gen": gen})
        if cached and req.req_id in self._requeued:
            self.requeue_prefix_hits += 1
        ttl = (req.ttl_steps if req.ttl_steps is not None
               else self.default_ttl)
        self.active[slot] = {"req": req, "generated": [],
                             "target": min(req.gen_length, self.max_gen),
                             "prefix": m.node if m is not None else None,
                             "deadline": (self.clock + ttl
                                          if ttl is not None else None),
                             "reserve_tokens": want,
                             "reserve_g": want - len(ids)}
        return {"slot": slot, "ids": ids, "table": table, "cached": cached,
                "cow": cow, "gen": gen, "req": req,
                "draft_table": draft_table}

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
            if p["req"].req_id in self._swap_debt:
                # a suspended request came back through the prefill path
                # instead of _swap_in: count the wasted tokens exactly
                self.reprefilled_swapped_tokens += len(sfx)
            if p["req"].req_id in self._restored_ids:
                # a snapshot-covered request re-entered through the
                # prefill path: the restore should have rebuilt its KV
                # from the image (§17), so count the wasted tokens
                self.replayed_reprefill_tokens += len(sfx)
        # pad rows repeat row 0's slot/table/position (identical duplicate
        # writes) and keep plens[0] for a valid attention gather
        plens[n:] = plens[0]
        rows[n:] = rows[0]
        slots[n:] = slots[0]
        pos_vals[n:] = pos_vals[0]
        attn = (rows[:, :width] if width > 1
                else np.full((nb, 1), self.null_block, np.int32))
        shadow = self.allocator._shadow
        if shadow is not None:
            # every block this wave's KV write lands in (suffix +
            # predicted-generation tail) must be privately owned
            for p in plans:
                shadow.check_write(p["slot"],
                                   p["table"][p["cached"] // self.bt:])
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
            if shadow is not None:
                # the dispatch wrote this slot's KV: a same-wave sharer
                # writing into its pages is a violation from here on
                shadow.mark_materialized(p["slot"])
        if self.spec_decode:
            # §16: seed the wave's draft pools in one more dispatch (the
            # draft model's weights; not counted as a target wave)
            self._draft_prefill(
                [(p["slot"], p["ids"], p["draft_table"]) for p in plans])

    def _draft_prefill(self, items: List[Tuple[int, List[int], List[int]]],
                       *, resume: bool = False) -> None:
        """ONE draft-model ``prefill_wave`` building draft-pool KV for a
        group of ``(slot, token_ids, draft_table)`` rows (§16): always a
        full-history, prefix-0 wave, as the draft pool has no radix tree
        to share from.  Its slot-state update writes the draft tables and
        the draft carry logits, and rewrites positions and the active
        mask with the values the target wave already set."""
        n = len(items)
        nb = _pow2_ceil(n)
        sb = _bucket(max(len(ids) for _, ids, _ in items))
        tokens = np.zeros((nb, sb), np.int32)
        lengths = np.ones(nb, np.int32)
        wlens = np.zeros(nb, np.int32)       # write validity: pads drop
        plens = np.zeros(nb, np.int32)
        rows = np.full((nb, self.max_blocks), self.null_block, np.int32)
        nulls = np.full(nb, self.null_block, np.int32)
        attn = np.full((nb, 1), self.null_block, np.int32)
        slots = np.zeros(nb, np.int32)
        sel = np.zeros(nb, np.int32)
        pos_vals = np.ones(nb, np.int32)
        shadow = self.allocator._shadow
        for i, (slot, ids, table) in enumerate(items):
            tokens[i, :len(ids)] = ids
            lengths[i] = len(ids)
            wlens[i] = len(ids)
            rows[i, :len(table)] = table
            slots[i] = slot
            sel[i] = i
            pos_vals[i] = len(ids)
            if resume:
                self.draft_reprefill_tokens += len(ids)
            else:
                self.draft_prefill_tokens += len(ids)
            if shadow is not None:
                # draft blocks are never shared: the whole table must be
                # privately owned by this slot's draft seq
                shadow.check_write(self._draft_seq(slot), table)
        rows[n:] = rows[0]
        slots[n:] = slots[0]
        pos_vals[n:] = pos_vals[0]
        (tokens_t, lengths_t, plens_t, attn_t, rows_t, wlens_t, src_t, dst_t,
         slots_t, sel_t, pos_t) = self._upload(
            tokens, lengths, plens, attn, rows, wlens, nulls, nulls, slots,
            sel, pos_vals)
        state = {"tables": self.draft_tables, "positions": self.positions,
                 "active": self.active_mask, "logits": self.draft_logits}
        M.prefill_wave(
            self.draft_params, self.draft_cfg, self.draft_pages, state,
            {"tokens": tokens_t, "lengths": lengths_t,
             "prefix_lens": plens_t, "attn_tables": attn_t,
             "tables": rows_t, "write_lens": wlens_t, "cow_src": src_t,
             "cow_dst": dst_t, "slots": slots_t, "row_sel": sel_t,
             "positions": pos_t},
            null_block=self.null_block, act_dtype=self.dtype)
        if shadow is not None:
            for slot, _, _ in items:
                shadow.mark_materialized(self._draft_seq(slot))

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
        self._resume_swapped()   # suspended requests outrank admissions
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
        self._resume_swapped()   # suspended requests outrank admissions
        self._wave_pending = []
        admitted = []
        for req in reqs:
            try:
                admitted.append(self._reserve(req))
            except EngineFull:
                break
        if admitted:
            if self.faults is not None:
                # §17 crash seam: mid-wave, reservations made, prefill
                # not yet dispatched
                self.faults.crash_due("wave", self.windows)
            self._prefill_admitted(admitted)
        return len(admitted)

    # -- eviction ------------------------------------------------------------

    def _release(self, slot: int) -> None:
        """Reset a slot's device/host state to idle (null table, pos 0),
        in place."""
        if self.spec_decode:
            # the slot's draft pool dies with it (finish, eviction and
            # swap-out all land here); a quarantined draft freed its seq
            # earlier, and free_seq of a missing seq is a no-op
            self.allocator.free_seq(self._draft_seq(slot))
            self.draft_tables[slot] = self._null_row
        self.tables[slot] = self._null_row
        # fill_, not an index write of a Python value, which copies it
        # from the host and waits for the device
        self.positions[slot].fill_(0)
        self.active_mask[slot].fill_(False)
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
        # destructive eviction: the readmission legitimately re-prefills
        # (the §17 snapshot-coverage tripwire must not fire on it)
        self._restored_ids.discard(req.req_id)
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

    # -- host swap tier: suspend / resume (DESIGN.md §15) --------------------

    @property
    def num_suspended(self) -> int:
        """Requests suspended on the host tier (images awaiting resume)."""
        return len(self._swapped)

    def _pick_swap_victim(self, exclude: int) -> Optional[int]:
        """Victim policy for *suspension*: largest EWMA-inflated predicted
        remaining work first (the request expected to occupy the pool
        longest frees the most), ties broken toward least progress (the
        smallest image to transfer)."""
        best, best_key = None, None
        for slot, a in enumerate(self.active):
            if a is None or slot == exclude:
                continue
            prog = len(a["generated"])
            remaining = (max(a["reserve_g"] - prog, 1)
                         * self.mispredict.factor(a["req"].app))
            key = (remaining, -prog)
            if best is None or key > best_key:
                best, best_key = slot, key
        return best

    @hot_path
    def _swap_out(self, slot: int) -> bool:
        """Suspend ``slot``'s request to the host tier: copy its logits
        row (one counted device-to-host copy) and its pages (one gather
        into a device snapshot, copied straight into the tier's slots
        and waited for: one more) to host memory, free the slot and its
        device blocks, and register the image with the tier.  The gather
        is enqueued before ``free_seq`` lets the blocks be reused, and
        the copies have landed before the engine enqueues anything else.
        Shared blocks swap once (the tier deduplicates; copied blocks
        that outlive the ``free_seq`` stay device-resident under a
        ``SWAP_HOLDER`` reference).  Returns False (nothing changed) when
        the tier cannot hold the image's fresh pages."""
        a = self.active[slot]
        req = a["req"]
        self._flush_publishes()   # queued spans reference live tables only
        table = list(self.allocator.tables[slot])
        fresh = self.swap.fresh_blocks(table)
        if not self.swap.can_hold(len(fresh)):
            return False
        if self.faults is not None:
            # §17 crash seam: mid-swap, tier committed to, image not yet
            # read back
            self.faults.crash_due("swap", self.windows)
        vals = None
        if fresh:
            vals = M.gather_pages(
                self.pages, self._upload(np.array(fresh, np.int32))[0])
        # the logits-row copy, in the logits' dtype, for a bit-exact resume
        logits_row = self.swap.host_empty(self.logits.shape[1:],
                                          self.logits.dtype)
        # hotlint: sync(§15 swap-out logits-row snapshot for bit-exact resume)
        logits_row.copy_(self.logits[slot])
        self.host_syncs += count_sync()
        image = {"req": req, "generated": a["generated"],
                 "target": a["target"], "deadline": a["deadline"],
                 "reserve_tokens": a["reserve_tokens"],
                 "reserve_g": a["reserve_g"],
                 "pos": int(self.pos_host[slot]),
                 "blocks": len(table), "logits": logits_row}
        self._unpin_prefix(slot)
        self.allocator.free_seq(slot)
        self._release(slot)
        self.swap.swap_out(req.req_id, table, fresh, vals, self.allocator)
        if fresh and self.device.type == "cuda":
            # the swap-out page copy: ONE readback per suspension (the
            # tier's copies are asynchronous, so the wait for them is it)
            # hotlint: sync(§15 swap-out page snapshot — ONE readback per suspension)
            torch.cuda.current_stream(self.device).synchronize()
            self.host_syncs += count_sync()
        elif fresh:
            # a CPU engine's copies have landed: the same one readback
            self.host_syncs += count_sync()
        self._swapped[req.req_id] = image
        self._swap_debt.add(req.req_id)
        self.swap_outs += 1
        self.swapped_blocks += len(fresh)
        self.swap_reused_blocks += len(table) - len(fresh)
        self.swapped_ctx_tokens += int(image["pos"])
        shadow = self.allocator._shadow
        if shadow is not None:
            shadow.on_swap_out(req.req_id)
        if self.journal is not None:
            self.journal.append("swap", rid=int(req.req_id), dir="out",
                                clock=int(self.clock))
        return True

    def _swap_out_victim(self, exclude: int) -> bool:
        """Suspend the policy's victim; True only when device blocks
        actually freed (a fully-shared image frees nothing, and the
        caller falls through to the next pressure valve)."""
        victim = self._pick_swap_victim(exclude)
        if victim is None:
            return False
        before = len(self.allocator.free)
        if not self._swap_out(victim):
            return False
        return len(self.allocator.free) > before

    @hot_path
    def _swap_in(self, rid: int, image: Dict[str, object],
                 shared: List[int], host_slots: List[int]) -> None:
        """Resume a suspended image into a free slot: re-``share`` the
        device-resident prefix the tier still holds, allocate fresh blocks
        for the rest, copy the host pages back and scatter them into the
        pools, and restore the slot's tensors (table row, position, active
        flag, the pre-suspension logits row) in place, so the next window
        continues the stream with zero re-prefilled tokens.  Nothing is
        read back: the copies are enqueued on the engine's stream, ahead
        of the next window's decode."""
        t0 = time.perf_counter()
        slot = self.active.index(None)
        if shared:
            self.allocator.share(slot, shared)
        table = self.allocator.allocate(slot, int(image["blocks"]) * self.bt)
        fresh = table[len(shared):]
        shadow = self.allocator._shadow
        if shadow is not None and fresh:
            shadow.check_write(slot, fresh)
        row = np.full(self.max_blocks, self.null_block, np.int32)
        row[:len(table)] = table
        pos = int(image["pos"])
        blk, row_t, pos_t = self._upload(np.array(fresh, np.int32), row,
                                         np.array([pos], np.int32))
        if fresh:
            vals = self.swap.read(host_slots, self.device)
            M.scatter_pages(self.pages, blk, vals)
        _restore_slot(self.tables, self.positions, self.active_mask,
                      self.logits, slot, row_t, pos_t, image["logits"])
        self.pos_host[slot] = pos
        self.active[slot] = {"req": image["req"],
                             "generated": image["generated"],
                             "target": image["target"], "prefix": None,
                             "deadline": image["deadline"],
                             "reserve_tokens": image["reserve_tokens"],
                             "reserve_g": image["reserve_g"]}
        if self.spec_decode:
            # §16: the draft pool was dropped at suspension (draft KV is
            # disposable: verification is the oracle), so one DRAFT
            # prefill over the full history rebuilds it.  The target
            # stream re-prefills nothing: the §15 invariant and its
            # counter are untouched
            draft_table = list(self.allocator.allocate(
                self._draft_seq(slot), max(pos, 1)))
            self._draft_prefill(
                [(slot, self._prompt_ids(image["req"])
                  + list(image["generated"]), draft_table)], resume=True)
        self.swap.drop(rid, self.allocator)
        del self._swapped[rid]
        self._swap_debt.discard(rid)
        self.swap_ins += 1
        if shadow is not None:
            shadow.mark_materialized(slot)
            shadow.on_swap_in(rid)
        if self.journal is not None:
            self.journal.append("swap", rid=int(rid), dir="in",
                                clock=int(self.clock))
        self.swap_in_s += time.perf_counter() - t0

    def _try_resume(self, rid: int) -> bool:
        """Resume ``rid`` if device blocks can be found: escalate through
        the same non-destructive pressure valves as ``_grow`` (cold radix
        leaves, then the tier's own device holds) before giving up."""
        image = self._swapped[rid]
        while True:
            shared, host_slots = self.swap.split_resident(rid)
            need = len(host_slots)
            if self.spec_decode:
                # the resume also rebuilds the slot's draft pool (§16)
                need += self.allocator.blocks_needed(int(image["pos"]))
            if need <= len(self.allocator.free):
                self._swap_in(rid, image, shared, host_slots)
                return True
            if self.prefix_cache is not None \
                    and self.prefix_cache.evict_until(need):
                continue
            if self.swap.release_device_holds(self.allocator):
                continue   # holds freed; re-split (shared prefix shrank)
            return False

    def _resume_swapped(self) -> int:
        """Swap suspended requests back in, oldest first, while slots and
        blocks allow: called at the admission seams (``join`` /
        ``join_many``) and the window prologue, so resumes outrank fresh
        admissions.  FIFO is strict: if the oldest image cannot resume,
        younger ones wait.  A ``swap_stall`` fault refuses attempts."""
        if self.swap is None or not self._swapped:
            return 0
        self._flush_publishes()   # resume may evict radix leaves below
        n = 0
        for rid in list(self._swapped):
            if None not in self.active:
                break
            if self.faults is not None and self.faults.swap_stalled():
                break
            if not self._try_resume(rid):
                break
            n += 1
        return n

    def _drop_swapped(self, rid: int, reason: str) -> Request:
        """Give up on a suspended image: typed shed, host slots freed."""
        image = self._swapped.pop(rid)
        self._flush_publishes()   # drop may free tier-held device blocks
        self.swap.drop(rid, self.allocator)
        shadow = self.allocator._shadow
        if shadow is not None:
            shadow.on_swap_in(rid)
        self.shed_log.append(Shed(image["req"], reason, self.clock))
        return image["req"]

    def shed_oldest_swapped(self) -> Optional[Request]:
        """The serve loop's stall escape: shed the oldest suspended image
        with reason ``swapped_timeout`` (a wedged pool degrades into a
        typed shed, never a hang)."""
        if not self._swapped:
            return None
        return self._drop_swapped(next(iter(self._swapped)),
                                  "swapped_timeout")

    def _expire_swapped(self) -> None:
        """Deadline sweep for suspended images: an image past its
        deadline sheds with ``swapped_timeout``."""
        if self.swap is None or not self._swapped:
            return
        for rid in list(self._swapped):
            image = self._swapped[rid]
            if image["deadline"] is None or self.clock < image["deadline"]:
                continue
            self._drop_swapped(rid, "swapped_timeout")
            self.deadline_misses += 1

    def _grow(self, slot: int,
              evicted: List[Request]) -> List[Tuple[int, int]]:
        """Ensure the slot can hold pos_host[slot] + 1 tokens AND
        privately owns every block the coming window writes into; free
        blocks on demand through the §15 valves, cheapest first: the swap
        tier's own device holds, cold radix leaves, suspending a live
        request to the host tier, and last the destructive
        evict-and-requeue of the least-progress request.  Returns the
        (src, dst) copy-on-write pairs the caller applies on the device
        before decoding.  With speculation on, the window writes up to
        ``spec_w`` lookahead positions before rollback truncates the
        rejected tail (§16), so the capacity target is pos + spec_w."""
        need = int(self.pos_host[slot]) \
            + (self.spec_w if self.spec_decode else 1)
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
            if self.swap is not None \
                    and self.swap.release_device_holds(self.allocator):
                continue
            if self.prefix_cache is not None \
                    and self.prefix_cache.evict_until(missing):
                continue
            if self.swap is not None and self._swap_out_victim(exclude=slot):
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
                # the same valve order; dropping a tier hold on THIS
                # block can also make the clone unnecessary
                if self.swap is not None \
                        and self.swap.release_device_holds(self.allocator):
                    continue
                if self.prefix_cache is not None \
                        and self.prefix_cache.evict_until(1):
                    continue
                if self.swap is not None \
                        and self._swap_out_victim(exclude=slot):
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

    def _grow_draft(self, slot: int, evicted: List[Request]) -> None:
        """§16 counterpart of :meth:`_grow` for the slot's draft pool:
        make it hold ``pos + spec_w`` tokens through the same valves.  No
        copy-on-write: draft blocks are never shared, so growth is pure
        allocation.  The draft table row is written in place."""
        seq = self._draft_seq(slot)
        need = int(self.pos_host[slot]) + self.spec_w
        had = len(self.allocator.tables.get(seq, ()))
        while not self.allocator.can_allocate(seq, need):
            missing = (self.allocator.blocks_needed(need)
                       - len(self.allocator.tables.get(seq, ())))
            if self.swap is not None \
                    and self.swap.release_device_holds(self.allocator):
                continue
            if self.prefix_cache is not None \
                    and self.prefix_cache.evict_until(missing):
                continue
            if self.swap is not None and self._swap_out_victim(exclude=slot):
                continue
            victim = self._pick_victim(exclude=slot)
            if victim is None:
                raise MemoryError(
                    "paged pool exhausted by sequences outside this engine")
            evicted.append(self._evict(victim))
        table = self.allocator.allocate(seq, need)
        if len(table) != had:
            row = np.full(self.max_blocks, self.null_block, np.int32)
            row[:len(table)] = table
            self.draft_tables[slot] = self._upload(row)[0]

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

    def _expire_deadlines(self) -> None:
        """Free every active slot past its deadline (checked between
        windows on the scheduler clock): a typed shed, not an eviction;
        its blocks are freed, the miss is counted, and it is NOT
        requeued (§14)."""
        for slot, a in enumerate(self.active):
            if a is None or a["deadline"] is None \
                    or self.clock < a["deadline"]:
                continue
            self.shed_log.append(Shed(a["req"], "deadline", self.clock))
            self.deadline_misses += 1
            self._unpin_prefix(slot)
            self.allocator.free_seq(slot)
            self._release(slot)

    def step_window(self, max_steps: Optional[int] = None
                    ) -> Tuple[List[Request], List[Request], int]:
        """Run one fused decode window over all active requests.
        Returns (finished, evicted, steps_run); evicted requests must be
        requeued by the caller (they restart from scratch on readmit).

        Window prologue, on the host between windows (DESIGN.md §14):
        fault events due this window fire first (pool shrink/restore,
        logits poisoning, stalls), suspended images expire or resume
        (§15), deadlines are swept, then the NaN/Inf guard quarantines
        any poisoned slot — all before the grow loop, so surviving slots
        decode the window a fault-free engine would run.  A stalled
        window burns scheduler-clock ticks and returns ``steps_run == 0``
        without decoding."""
        self.windows += 1
        stalled = 0
        evicted: List[Request] = []
        if self.faults is not None:
            # the fault seam fires even with nothing active: a restore
            # must be able to un-wedge an engine whose whole active set
            # was evicted by the matching shrink
            self._flush_publishes()
            stalled = self.faults.before_window(self)
            if stalled:
                self.clock += stalled
                self.stall_ticks += stalled
        if self.swap is not None and self._swapped:
            # suspended images first, BEFORE the idle check, or an engine
            # whose whole active set is suspended could never wake up
            self._expire_swapped()
            self._resume_swapped()
        if not any(a is not None for a in self.active):
            return [], [], 0
        # deferred radix publishes land here, before any grow/evict/finish
        # could free a queued span's blocks
        self._flush_publishes()
        self._expire_deadlines()
        if self._nan_guard and any(a is not None for a in self.active):
            # the guard's readback: one finite flag per slot, reduced on
            # the device (the reference reads the whole [B, V] logits)
            # hotlint: sync(§14 NaN/Inf quarantine guard readback)
            finite = torch.isfinite(self.logits).all(dim=1).cpu().numpy()
            self.host_syncs += count_sync()
            self.guard_readbacks += 1
            for slot, a in enumerate(self.active):
                if a is not None and not finite[slot]:
                    # quarantine: clear the poisoned row in place (idle
                    # rows feed the fused argmax, masked) and evict for
                    # readmission, which re-prefills from the prompt
                    self.logits[slot].fill_(0.0)
                    evicted.append(self._evict(slot))
                    self.quarantined += 1
        if (self.spec_decode and self._nan_guard
                and any(a is not None for a in self.active)):
            # §16 draft-health guard: a poisoned DRAFT must not kill the
            # request (verification is the oracle), so the guard ices
            # the slot's draft for good (proposals stop, the stream goes
            # on at one verified token a window) and evicts nothing.  One
            # flag per slot, reduced on the device
            # hotlint: sync(§16 draft-health guard readback)
            dfinite = torch.isfinite(self.draft_logits).all(dim=1) \
                .cpu().numpy()
            self.host_syncs += count_sync()
            self.guard_readbacks += 1
            for slot, a in enumerate(self.active):
                if a is not None and not a.get("draft_cold") \
                        and not dfinite[slot]:
                    self._quarantine_draft(slot)
        if stalled or not any(a is not None for a in self.active):
            self.window_stats = None
            return [], evicted, 0
        if self.faults is not None:
            # §17 crash seam: mid-window, prologue done, decode not yet
            # dispatched
            self.faults.crash_due("window", self.windows)
        try:
            for slot, a in enumerate(self.active):
                if a is None:
                    continue
                try:
                    pairs = self._grow(slot, evicted)
                except MemoryError:
                    if self.faults is not None and self.faults.held_blocks:
                        # a transient fault-held pool: evict the growing
                        # request itself (requeued by the caller) instead
                        # of failing the window; a later pool_restore
                        # lets it finish
                        evicted.append(self._evict(slot))
                        continue
                    raise
                # apply this slot's COW copies IMMEDIATELY: a later slot's
                # _grow may evict this one and recycle its clone block
                if pairs:
                    npairs = _pow2_ceil(len(pairs))
                    src = np.full(npairs, self.null_block, np.int32)
                    dst = np.full(npairs, self.null_block, np.int32)
                    for i, (s, d) in enumerate(pairs):
                        src[i], dst[i] = s, d
                    M.copy_pages(self.pages, *self._upload(src, dst))
                if self.spec_decode and not a.get("draft_cold"):
                    # the draft pool grows to the same pos + spec_w through
                    # the same valves (after the copies above, so that an
                    # eviction here cannot recycle a clone's source first)
                    try:
                        self._grow_draft(slot, evicted)
                    except MemoryError:
                        if self.faults is not None \
                                and self.faults.held_blocks:
                            evicted.append(self._evict(slot))
                            continue
                        raise
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
        shadow = self.allocator._shadow
        if shadow is not None:
            # the window appends from each slot's write cursor: every
            # block at or past it must be privately owned (post-_grow COW)
            for slot, a in enumerate(self.active):
                if a is not None:
                    t = self.allocator.tables[slot]
                    shadow.check_write(
                        slot, t[int(self.pos_host[slot]) // self.bt:])
                    if self.spec_decode and not a.get("draft_cold"):
                        dseq = self._draft_seq(slot)
                        dt = self.allocator.tables.get(dseq, [])
                        shadow.check_write(
                            dseq, dt[int(self.pos_host[slot]) // self.bt:])
        if self.spec_decode:
            finished, k = self._spec_window(max_steps)
            return finished, evicted, k
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
        # hotlint: sync(the one window token readback — §9 fused decode)
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

    def step(self) -> Tuple[List[Request], List[Request]]:
        """One decode iteration (a window of at most one step); returns
        (finished, evicted).  Kept for callers that interleave
        per-token."""
        finished, evicted, _ = self.step_window(max_steps=1)
        return finished, evicted

    def _quarantine_draft(self, slot: int) -> None:
        """Ice a slot's draft for good (§16): free its draft pool, null
        its draft table row and clear the poisoned carry row, in place.
        The slot keeps serving (every window still emits its one verified
        token); only a fresh admission builds a new draft."""
        self.allocator.free_seq(self._draft_seq(slot))
        self.draft_tables[slot] = self._null_row
        self.draft_logits[slot].fill_(0.0)
        self.active[slot]["draft_cold"] = True
        self.draft_quarantined += 1

    @hot_path
    def _spec_window(self, max_steps: Optional[int]
                     ) -> Tuple[List[Request], int]:
        """One speculative window (§16): the draft proposes ``spec_w``
        tokens per slot, the target verifies all of them in ONE batched
        pass over the same positions, and the longest agreeing prefix is
        accepted on the device; the host reads back one packed
        ``[tokens | emit count]`` row per slot, the fused window's one
        sync.  Rollback of the rejected tail is table truncation on both
        pools (the verify already rewound the positions); truncation
        never mutates a block, and a trailing block the radix tree still
        holds only loses this slot's reference."""
        w = self.spec_w
        max_emit = np.ones(self.slots, np.int32)
        for slot, a in enumerate(self.active):
            if a is None:
                continue
            e = min(a["target"] - len(a["generated"]), w)
            if max_steps is not None:
                e = min(e, max_steps)
            max_emit[slot] = max(e, 1)
        # post-grow/evict snapshot (the fused window's contract)
        self.window_stats = {
            "live0": int(sum(int(self.pos_host[s])
                             for s, a in enumerate(self.active)
                             if a is not None)),
            "active": self.num_active,
            "used_tokens": self.allocator.used_blocks * self.bt,
        }
        # hotlint: sync(the one spec-window readback — §16 packed tokens + accept counts)
        packed = self._speculate(max_emit).cpu().numpy()
        self.host_syncs += count_sync()
        self.spec_windows += 1
        finished: List[Request] = []
        kmax = 0
        for slot, a in enumerate(self.active):
            if a is None:
                continue
            e = int(packed[slot, w])
            a["generated"].extend(packed[slot, :e].tolist())
            self.pos_host[slot] += e
            kmax = max(kmax, e)
            self.spec_slot_windows += 1
            self.spec_emitted += e
            self.spec_accepted += max(e - 1, 0)
            if not a.get("draft_cold"):
                # proposals clamped away by max_emit (a finish, max_steps)
                # were never candidates: counting them as rejections
                # would understate the draft's quality
                self.spec_drafted += min(w - 1, int(max_emit[slot]) - 1)
            if len(a["generated"]) >= a["target"]:
                finished.append(a["req"])
                self.generated[a["req"].req_id] = a["generated"]
                self.mispredict.observe(a["req"].app, a["reserve_g"],
                                        len(a["generated"]))
                self._unpin_prefix(slot)
                self.allocator.free_seq(slot)
                self._release(slot)
                continue
            # rollback = truncation: both pools drop every block past the
            # accepted stream, floored at the admission reservation so
            # that speculation never un-reserves the blocks the §13
            # admission control promised this request
            keep = max(
                self.allocator.blocks_needed(
                    max(int(self.pos_host[slot]), 1)),
                self.allocator.blocks_needed(int(a["reserve_tokens"])))
            self.allocator.truncate(slot, keep)
            self.allocator.truncate(self._draft_seq(slot), keep)
        self.decode_steps += kmax
        self.clock += kmax
        return finished, kmax

    def _spec_state(self, max_emit: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"logits": self.logits, "positions": self.positions,
                "tables": self.tables, "active": self.active_mask,
                "draft_logits": self.draft_logits,
                "draft_tables": self.draft_tables, "max_emit": max_emit}

    def _speculate(self, max_emit: np.ndarray) -> torch.Tensor:
        """One speculative window under the per-slot budget ``max_emit``,
        written into the engine's tensors in place; returns the packed
        ``[B, spec_w + 1]`` on the device.  A CUDA engine replays its
        captured window, capturing it first if no window or ``warmup()``
        has (that window is then the capture's warm-up run, so it still
        runs once); a CPU engine runs it eagerly."""
        if self.device.type == "cpu":
            b, w = self.slots, self.spec_w
            proposed = torch.zeros((b, w), dtype=torch.int32)
            packed = torch.zeros((b, w + 1), dtype=torch.int32)
            spec_window_into(
                self.params, self.cfg, self.pages, self.draft_params,
                self.draft_cfg, self.draft_pages,
                self._spec_state(self._upload(max_emit)[0]), proposed,
                packed, null_block=self.null_block, act_dtype=self.dtype)
            return packed
        if self._spec_graph is None:
            self._spec_graph = SpecGraph(self, live=True, max_emit=max_emit)
            self.graph_captures += 1
            return self._spec_graph.packed
        return self._spec_graph.run(max_emit)

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
        every power of two up to ``slots`` (with the prefix cache), one
        swap-out and one resume (with the swap tier), and the decode.  On
        a CUDA engine the decode step is captured here (once per engine;
        a second call captures nothing), so that a serve after
        ``warmup()`` captures nothing; a CPU engine runs the fused decode
        at every window in ``windows``.  A speculative engine never runs
        the plain decode: it runs the draft model's wave at every (batch
        bucket x full-history bucket) shape, and captures its speculative
        window instead (a CPU engine runs one).

        Nothing is written that a live request could read: the waves
        have ``write_lens == 0`` and null-to-null copy-on-write pairs,
        and update sacrificial copies of the slot state; the swap pass
        moves the null block through a free tier slot and restores a
        sacrificial copy of the slot state; the decode and the
        speculative window run on an idle state (null tables, position
        0, no slot active), so their junk lands in the null blocks only.
        The defaults are the reference's."""
        if suffix_buckets is None:
            suffix_buckets = _bucket_list(_bucket(self.max_len))
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
        self._warm_waves(self.params, self.cfg, self.pages, self.tables,
                         self.logits, batch_sizes, suffix_buckets, widths)
        if self.prefix_cache is not None:
            # grow-path copy-on-write copies pad to a power of two <=
            # slots; null -> null clones leave the pool unchanged
            k = 1
            while k <= _pow2_ceil(self.slots):
                nulls = np.full(k, self.null_block, np.int32)
                M.copy_pages(self.pages, *self._upload(nulls, nulls))
                k <<= 1
        if self.swap is not None:
            self._warm_swap()
        if self.spec_decode:
            # the draft's admission and resume waves: full history (a
            # resume's too), prefix 0
            hist = self.max_len + (self.max_gen if self.swap is not None
                                   else 0)
            top = _bucket(hist)
            self._warm_waves(self.draft_params, self.draft_cfg,
                             self.draft_pages, self.draft_tables,
                             self.draft_logits, batch_sizes,
                             _bucket_list(top), [1])
            self._warm_spec()
            return
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

    def _warm_swap(self) -> None:
        """The swap pass of :meth:`warmup` (§15): one swap-out's and one
        resume's work, each copy and allocation of it, on one page: the
        null block's pages are gathered, copied with a logits row into
        pinned memory (one free tier slot, which stays free), read back,
        scattered into the null block again, and restored into a
        sacrificial copy of the slot state; then the work is waited for,
        as a swap-out waits for its copies.  The reference compiles and
        runs its gather, scatter and slot restore here."""
        if not self.swap.free:
            return
        null = self._upload(np.array([self.null_block], np.int32))[0]
        vals = M.gather_pages(self.pages, null)
        row = self.swap.host_empty(self.logits.shape[1:], self.logits.dtype)
        row.copy_(self.logits[0])
        M.scatter_pages(self.pages, null, self.swap.warm(vals, self.device))
        row_t, pos_t = self._upload(
            np.full(self.max_blocks, self.null_block, np.int32),
            np.zeros(1, np.int32))
        _restore_slot(self.tables.clone(), self.positions.clone(),
                      self.active_mask.clone(), self.logits.clone(), 0,
                      row_t, pos_t, row)
        if self.device.type == "cuda":
            # hotlint: sync(uncounted: warmup waits for its swap pass, before any serve)
            torch.cuda.current_stream(self.device).synchronize()

    def _warm_waves(self, params, cfg, pages, tables: torch.Tensor,
                    logits: torch.Tensor, batch_sizes: List[int],
                    buckets: List[int], widths: List[int]) -> None:
        """One variable-prefix wave of ``params`` on ``pages`` at every
        (batch bucket x suffix bucket x gather-table width) shape, with
        ``write_lens == 0`` and null-to-null copy-on-write pairs, each
        updating a sacrificial copy of the slot state (``tables``,
        ``logits`` and the engine's positions and active mask)."""
        for nb in batch_sizes:
            zeros = np.zeros(nb, np.int32)
            nulls = np.full(nb, self.null_block, np.int32)
            for sb in buckets:
                for w in widths:
                    (tokens, lengths, plens, attn, rows, wlens, src, dst,
                     slots, sel, pos) = self._upload(
                        np.zeros((nb, sb), np.int32), np.ones(nb, np.int32),
                        zeros, np.full((nb, w), self.null_block, np.int32),
                        np.full((nb, self.max_blocks), self.null_block,
                                np.int32), zeros, nulls, nulls, zeros, zeros,
                        zeros)
                    state = {"tables": tables.clone(),
                             "positions": self.positions.clone(),
                             "active": self.active_mask.clone(),
                             "logits": logits.clone()}
                    M.prefill_wave(
                        params, cfg, pages, state,
                        {"tokens": tokens, "lengths": lengths,
                         "prefix_lens": plens, "attn_tables": attn,
                         "tables": rows, "write_lens": wlens,
                         "cow_src": src, "cow_dst": dst, "slots": slots,
                         "row_sel": sel, "positions": pos},
                        null_block=self.null_block, act_dtype=self.dtype)

    def _idle_spec_state(self) -> Dict[str, torch.Tensor]:
        """A speculative window's state on which it writes only into the
        null blocks of the two pools: copies of the logits, null tables,
        position 0, no slot active, a budget of 1."""
        b = self.slots
        return {"logits": self.logits.clone(),
                "positions": torch.zeros_like(self.positions),
                "tables": self._null_row[None, :].repeat(b, 1),
                "active": torch.zeros_like(self.active_mask),
                "draft_logits": self.draft_logits.clone(),
                "draft_tables": self._null_row[None, :].repeat(b, 1),
                "max_emit": torch.ones(b, dtype=torch.int32,
                                       device=self.device)}

    def _warm_spec(self) -> None:
        """The speculative window of :meth:`warmup` (§16), on an idle
        state: captured on the card, run on the CPU."""
        if self.device.type == "cuda":
            if self._spec_graph is None:
                self._spec_graph = SpecGraph(self, live=False)
                self.graph_captures += 1
            return
        b, w = self.slots, self.spec_w
        spec_window_into(
            self.params, self.cfg, self.pages, self.draft_params,
            self.draft_cfg, self.draft_pages, self._idle_spec_state(),
            torch.zeros((b, w), dtype=torch.int32),
            torch.zeros((b, w + 1), dtype=torch.int32),
            null_block=self.null_block, act_dtype=self.dtype)

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

    # -- crash-safe snapshot / restore (DESIGN.md §17) -----------------------

    @hot_path
    def snapshot(self, path: str) -> str:
        """Serialize the complete engine image to ``path`` (checksummed
        npz, written atomically).  Exactly TWO counted readbacks: one
        gather of every live block of the pool (null block excluded: its
        contents are junk by construction), read back in one copy, and
        one of the logits rows;
        everything else the snapshot stores is host state.  Must be
        taken at a window boundary: mid-wave state (``_wave_pending``)
        and §16 speculative engines refuse."""
        from repro_torch.serving import snapshot as snaplib
        if self.spec_decode:
            raise snaplib.SnapshotError(
                "snapshot/restore does not cover speculative engines (§16)")
        self._flush_publishes()
        if self._wave_pending:
            raise snaplib.SnapshotError(
                "snapshot inside an admission wave (wave_pending non-empty)")
        used = sorted(b for b in self.allocator.refcount
                      if b != self.null_block)
        vals = None
        if used:
            # the page readback: ONE copy of the whole pool image (a bf16
            # pool's bytes as they are; the file keeps them as uint16)
            # hotlint: sync(§17 snapshot page readback — ONE gather for the whole pool image)
            vals = M.gather_pages(
                self.pages, self._upload(np.array(used, np.int32))[0]).cpu()
            self.host_syncs += count_sync()
        # hotlint: sync(§17 snapshot logits readback for bit-exact restore)
        logits = self.logits.cpu()
        self.host_syncs += count_sync()
        return snaplib.save_engine(self, path, page_blocks=used,
                                   page_values=vals, logits=logits)

    def restore(self, path: str) -> None:
        """Apply a snapshot to this freshly constructed (or warmed) engine:
        allocator books overwritten wholesale (free-list order included),
        exactly the snapshot's pages scattered back into the pools, the
        slot tensors written in place (so a decode graph captured before
        the restore replays on the restored state), radix tree and swap
        tier rebuilt, counters, EWMA and clock restored, and the §13
        shadow REBUILT from the snapshot, then cross-checked against the
        restored books.  Not a hot path: restore happens once, at
        process start."""
        from repro_torch.serving import snapshot as snaplib
        snaplib.load_engine(self, path)


def drive_paged(engine: PagedContinuousEngine, requests: List[Request], *,
                max_steps: int = 2_000, refill=None, backlog=None,
                queue_cap: Optional[int] = None,
                max_retries: Optional[int] = None,
                stall_limit: int = 64,
                recovery=None) -> Dict[str, object]:
    """The canonical paged serve loop: batched admission until the engine
    refuses, fused decode windows, evictions requeued at the queue front.

    ``refill(steps)`` (optional) is called whenever the local queue
    drains and may return more requests (an external scheduler's next
    admission wave); ``backlog()`` (optional) reports whether that
    scheduler still holds work, keeping the loop alive.

    Robustness knobs (DESIGN.md §14), all off by default: ``queue_cap``
    bounds the local admission queue (overflow is shed with reason
    ``queue_full``); ``max_retries`` bounds evict/requeue cycles per
    request (exhaustion sheds with ``retry_budget``; with ``None`` the
    engine escalates the reservation through its retry budget and serves
    the request); ``stall_limit`` consecutive no-progress iterations
    shed the queue head (``admission_stalled``), or with an empty queue
    the oldest suspended image (``swapped_timeout``), instead of
    hanging.  A ``PoolExhausted`` window sheds the culprit with reason
    ``oom`` and requeues the rest.

    ``recovery`` (optional) is a §17 ``RecoveryManager``
    (``serving.snapshot``): every request is journaled write-ahead,
    before any engine work touches it, and finish/shed records are
    fsync'd at each window boundary, with a full snapshot every
    ``snapshot_every`` windows.

    ``steps`` counts decode iterations, not windows; ``util`` holds one
    sample per decode iteration; ``host_syncs`` is the device-to-host
    readback count."""
    pending: Deque[Request] = deque(requests)
    served = steps = peak = evictions = no_progress = 0
    syncs0 = engine.host_syncs
    shed0 = len(engine.shed_log)

    def _shed(req: Request, reason: str) -> None:
        engine.shed_log.append(Shed(req, reason, engine.clock))

    if recovery is not None:
        recovery.attach(engine)
        for r in pending:
            recovery.on_admit(r, engine)
    if queue_cap is not None:
        while len(pending) > queue_cap:
            _shed(pending.pop(), "queue_full")
    util: List[float] = []
    while (pending or engine.num_active or engine.num_suspended
           or (backlog() if backlog is not None else False)) \
            and steps < max_steps:
        swap_ins0 = engine.swap_ins
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
            if recovery is not None:
                for r in more:
                    recovery.on_admit(r, engine)
            if queue_cap is not None:
                while len(pending) > queue_cap:
                    _shed(pending.pop(), "queue_full")
        if not (pending or engine.num_active or engine.num_suspended
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
            if recovery is not None:
                recovery.after_window(engine)
            steps += 1
            no_progress += 1
            continue
        served += len(finished)
        evictions += len(evicted)
        for r in reversed(evicted):
            if max_retries is not None \
                    and engine.retries.get(r.req_id, 0) > max_retries:
                _shed(r, "retry_budget")
            else:
                pending.appendleft(r)
        if recovery is not None:
            # §17 window boundary: fsync the WAL tail, maybe snapshot
            recovery.after_window(engine, finished)
        # reconstruct the per-iteration utilization ramp from the
        # window's post-grow snapshot
        ws = engine.window_stats
        if k > 1 and ws is not None and ws["used_tokens"] > 0:
            util.extend((ws["live0"] + i * ws["active"]) / ws["used_tokens"]
                        for i in range(1, k))
        util.append(engine.utilization())
        steps += max(k, 1)
        # progress = admissions, finishes or swap-ins; eviction churn and
        # stalled windows are not progress
        if admitted or finished or engine.swap_ins > swap_ins0:
            no_progress = 0
        elif not engine.num_active:
            no_progress += 1
            if no_progress >= stall_limit:
                if pending:
                    _shed(pending.popleft(), "admission_stalled")
                    no_progress = 0
                elif engine.num_suspended:
                    # a wedged pool with only suspended images left
                    # degrades into a typed shed, never a hang (§15)
                    engine.shed_oldest_swapped()
                    no_progress = 0
    return {"served": served, "steps": steps, "peak": peak,
            "evictions": evictions, "util": util,
            "host_syncs": engine.host_syncs - syncs0,
            "unserved": list(pending),
            "shed": list(engine.shed_log[shed0:]),
            "deadline_misses": engine.deadline_misses,
            "quarantined": engine.quarantined,
            "requeue_prefix_hits": engine.requeue_prefix_hits,
            "retries_max": max(engine.retries.values(), default=0),
            "swap_outs": engine.swap_outs,
            "swap_ins": engine.swap_ins,
            "reprefilled_swapped_tokens": engine.reprefilled_swapped_tokens,
            "replayed_reprefill_tokens": engine.replayed_reprefill_tokens,
            # §16 speculative decoding (all zero with spec off)
            "spec_windows": engine.spec_windows,
            "spec_emitted": engine.spec_emitted,
            "spec_accepted": engine.spec_accepted,
            "spec_drafted": engine.spec_drafted,
            "draft_quarantined": engine.draft_quarantined,
            "draft_prefill_tokens": engine.draft_prefill_tokens,
            "draft_reprefill_tokens": engine.draft_reprefill_tokens,
            # the headline §16 metric: tokens emitted per target verify
            # row (1.0 is the spec-off baseline)
            "accepted_per_dispatch": (
                engine.spec_emitted / engine.spec_slot_windows
                if engine.spec_slot_windows else 0.0),
            "acceptance_rate": (
                engine.spec_accepted / engine.spec_drafted
                if engine.spec_drafted else 0.0)}
