"""A decode step, or a speculative window, as a captured CUDA graph: the
port's counterpart of the reference's compiled decode entries
(``_jitted`` in the reference package's ``serving/engine.py``, which
compiles ``decode_multi`` and ``decode_multi_paged`` into one XLA
program per power-of-two window, and ``draft_window`` and
``verify_window`` into one each).

What is captured is ONE greedy step written in place on an engine's own
tensors: the argmax of the carried logits, the model's decode step, the
position advance, and the token written into a static ``[B]`` buffer.
A window of ``k`` steps is ``k`` replays, each followed by a copy of the
token into a ``[B, max_steps]`` buffer, and then the engine's one
``[B, k]`` readback.  One graph serves every window length, where the
reference compiles one program per power-of-two window.  Three engines
capture one:

- :meth:`DecodeGraph.paged`: ``decode_step_paged_into`` on the paged
  engine's pool, tables, positions and logits.  Its batch is always its
  ``slots``, so it captures once per engine, at its first window or in
  ``warmup()``.
- :meth:`DecodeGraph.padded`: ``decode_step_into`` on one padded batch's
  dense cache (the MLA family's latents, the SSM state, both KV and
  state for the hybrid family, or the self and cross K/V of the
  encoder-decoder family, the cross cache only read) and logits, with
  positions of its own.  A ``BatchEngine`` allocates that
  cache in each batch's prefill, so it captures once per batch, and the
  graph is dropped with the batch.
- :meth:`DecodeGraph.continuous`: ``decode_step_fed_into`` on a
  ``ContinuousEngine``'s dense cache, logits and device positions, once
  per engine, at its first step.  Its argmax stays outside the graph:
  the engine writes each step's token into the graph's token buffer and
  queues its copy to the host before the replay, so the host waits for
  the token, not for the step (the reference's readback, which XLA's
  asynchronous dispatch overlaps with the step).

A speculative paged engine (§16) never runs the plain decode step.  It
captures its whole window instead, :class:`SpecGraph`: the draft
model's ``W`` steps on its own pool, then the target's verify pass
(:func:`spec_window_into`), once per engine, and replays it once a
window.  :class:`CapturedStep` holds what the two kinds share.

A graph binds one engine's tensors, so graphs are per engine (and per
batch), where the reference's compiled programs are shared by every
engine of a (config, dtype).

Where a capture can go wrong, and what is done about it here:

- *Addresses.*  A graph replays on the addresses it captured.  The step
  writes the logits, the positions and the cache or pages in place, and
  nothing rebinds them while the graph lives.
- *Split counters.*  The decode kernels' shared counter buffer is
  replaced, and the old one freed, when a launch needs more counters
  (``kernels/decode_attention/kernel.py``).  The capture takes a buffer
  of its own (``private_split_counters``), which this object keeps
  alive.  The split partials are allocated per launch; under capture
  they come from the graph's private memory pool, which lives as long
  as the graph.
- *Warm before capture.*  The step runs once on a side stream before
  it is captured on that same stream, as torch's documentation does:
  the first launch of a kernel of the ctypes library may load its
  module or raise its shared-memory limit, and the first cuBLAS call on
  a stream creates its handle and workspace; none of that may happen
  inside a capture.
- *No barrier.*  The capture is begun and ended on the graph itself,
  not through ``torch.cuda.graph``, whose entry synchronises the device
  and empties the allocator's cache: once per padded batch, that would
  ``cudaFree`` the previous batch's cached blocks only for the next
  prefill to allocate them again.
- *Host reads.*  A host read inside the step would make the capture
  fail; the step has none, and a replayed window reads nothing until
  the engine's one readback.  The speculative window's one input from
  the host, its emit budget, is copied from pinned memory into a static
  buffer ahead of each replay.
- *Launch counts.*  The kernels' wrappers count launches in Python,
  which does not run under replay.  Each wrapper's count grows by the
  launches it made while the step was captured; that growth is taken
  back (a capture launches nothing) and added again at every replay.

There is no eager fallback: a capture that fails raises."""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as scan_ops
from repro_torch.models import model as M

_WRAPPERS = decode_ops.KERNELS + flash_ops.KERNELS + scan_ops.KERNELS

State = Dict[str, torch.Tensor]


def _launches() -> Dict[object, int]:
    return {fn: fn.launches for fn in _WRAPPERS}


def _query_heads(params) -> int:
    """Query heads a decode launch plans split counters for; 0 for a
    model whose layers have no ``"attn"`` weights, which launches no
    decode kernel: the SSM family (no attention) and the MLA family
    (its absorbed decode is plain PyTorch, as in the reference).  The
    encoder-decoder family's two decode launches a layer (self and
    cross) have the decoder's heads each, and run one after the other
    on the same counters."""
    if "dec_blocks" in params:
        return params["dec_blocks"]["self"]["wq"].shape[2]
    attn = params["blocks"].get("attn")
    return 0 if attn is None else attn["wq"].shape[2]


class CapturedStep:
    """One step on an engine's state, warmed and captured at
    construction; :meth:`replay` runs it again.

    ``step(state)`` runs the step in place on ``state``; the capture is
    of ``step(state)``.  The warm-up step runs on ``warm``; with
    ``warm=None`` (live) it runs on ``state`` itself, so it is a real
    step of the serve.  Both run on ``stream``, a side stream of
    ``device``: an engine that captures again and again passes the same
    one, so that cuBLAS's handle and workspace for it are made once.
    ``rows * heads`` sizes the private split counters (the query heads
    of the step's largest decode launch).  ``step`` is kept, and with it
    what it closes over (the weights, the cache or the pages), whose
    addresses the graph replays on.  ``capture_s`` is the host time the
    capture took (the capture and the graph's instantiation, not the
    warm-up step)."""

    def __init__(self, step: Callable[[State], None], state: State, *,
                 rows: int, heads: int, device: torch.device,
                 stream: torch.cuda.Stream, warm: Optional[State] = None):
        self.step, self.state = step, state
        current = torch.cuda.current_stream(device)
        self.graph = torch.cuda.CUDAGraph()
        with decode_kernel.private_split_counters(device, rows * heads) \
                as counters:
            self.counters = counters
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                step(state if warm is None else warm)
                current.wait_stream(stream)
                t0 = time.perf_counter()
                before = _launches()
                self.graph.capture_begin()
                try:
                    step(state)
                finally:
                    self.graph.capture_end()
                    after = _launches()
                    for fn, n in before.items():
                        fn.launches = n
                self.capture_s = time.perf_counter() - t0
        self.delta = {fn: after[fn] - n for fn, n in before.items()
                      if after[fn] != n}

    def replay(self) -> None:
        """One step on the captured state; each wrapper counts the
        launches the step makes."""
        self.graph.replay()
        for fn, n in self.delta.items():
            fn.launches += n


class DecodeGraph(CapturedStep):
    """One greedy decode step: ``step(state, tok)`` runs it in place on
    ``state`` and writes its token into ``tok``, the graph's own buffer;
    :meth:`window` gathers the tokens of its replays into ``toks``.
    With ``warm=None`` (live) the warm-up step is the first step of the
    window being run, and its token is already in ``toks[:, 0]``.  Given
    the caller's ``tok`` (:meth:`continuous`), the step reads the token
    the caller wrote there, and the graph has no ``toks`` and no
    window."""

    def __init__(self, step: Callable[[State, torch.Tensor], None],
                 state: State, *, rows: int, heads: int, max_steps: int,
                 device: torch.device, stream: torch.cuda.Stream,
                 warm: Optional[State] = None,
                 tok: Optional[torch.Tensor] = None):
        # the closure holds the buffer, not the graph: no reference
        # cycle keeps a dropped engine's pools alive until a collection
        own = tok is None
        if own:
            tok = torch.zeros(rows, dtype=torch.int32, device=device)
            self.toks = torch.zeros((rows, max(max_steps, 1)),
                                    dtype=torch.int32, device=device)
        self.tok = tok
        super().__init__(lambda s: step(s, tok), state, rows=rows,
                         heads=heads, device=device, stream=stream, warm=warm)
        if warm is None and own:
            self.toks[:, 0].copy_(tok)

    @classmethod
    def paged(cls, engine, *, live: bool) -> "DecodeGraph":
        """The paged engine's step on its own state.  ``live=True`` (the
        lazy capture at an engine's first window, as jit compiles at the
        first call): the warm-up step is that window's first step.
        ``live=False`` (``warmup()``): the warm-up step runs on an idle
        copy of the state (null tables, position 0, no slot active),
        which writes only into the null block of the pool."""
        params, cfg, pages, dtype = (engine.params, engine.cfg, engine.pages,
                                     engine.dtype)
        b = engine.slots
        state = {"logits": engine.logits, "positions": engine.positions,
                 "tables": engine.tables, "active": engine.active_mask}
        warm = None if live else {
            "logits": engine.logits.clone(),
            "positions": torch.zeros_like(engine.positions),
            "tables": engine._null_row[None, :].repeat(b, 1),
            "active": torch.zeros_like(engine.active_mask)}

        def step(s: State, tok: torch.Tensor) -> None:
            M.decode_step_paged_into(params, cfg, pages, s, tok,
                                     act_dtype=dtype)

        dev = engine.logits.device
        return cls(step, state, rows=b, heads=_query_heads(params),
                   max_steps=engine.max_gen, device=dev,
                   stream=torch.cuda.Stream(device=dev), warm=warm)

    @classmethod
    def padded(cls, params, cfg, cache, logits: torch.Tensor,
               positions: torch.Tensor, *, act_dtype: torch.dtype,
               max_steps: int, stream: torch.cuda.Stream) -> "DecodeGraph":
        """One padded batch's step on its prefill's ``cache`` and
        ``logits``, both written in place from here on, and on a copy of
        ``positions`` that the graph owns (the caller's may share storage
        with other inputs).  Live: the warm-up step is the batch's first
        decode step."""
        state = {"logits": logits, "positions": positions.clone()}

        def step(s: State, tok: torch.Tensor) -> None:
            M.decode_step_into(params, cfg, cache, s, tok,
                               act_dtype=act_dtype)

        return cls(step, state, rows=logits.shape[0],
                   heads=_query_heads(params), max_steps=max_steps,
                   device=logits.device, stream=stream)

    @classmethod
    def continuous(cls, engine) -> "DecodeGraph":
        """A ``ContinuousEngine``'s step after its argmax
        (``decode_step_fed_into``) on the engine's cache, logits and
        device positions, all written in place, reading the token the
        engine wrote into ``engine.tokens`` before each replay.  Once per
        engine (its cache lives as long as it does), at its first step:
        live, the warm-up step is that step."""
        params, cfg, cache, dtype = (engine.params, engine.cfg, engine.cache,
                                     engine.dtype)
        state = {"logits": engine.logits,
                 "positions": engine.device_positions}

        def step(s: State, tok: torch.Tensor) -> None:
            M.decode_step_fed_into(params, cfg, cache, {**s, "tokens": tok},
                                   act_dtype=dtype)

        dev = engine.device
        return cls(step, state, rows=engine.slots,
                   heads=_query_heads(params), max_steps=0, device=dev,
                   stream=torch.cuda.Stream(device=dev), tok=engine.tokens)

    def window(self, k: int, start: int = 0) -> torch.Tensor:
        """Steps ``start`` .. ``k - 1`` of a ``k``-step window, one replay
        each; returns the window's tokens ``[B, k]`` (on the device:
        reading them is the caller's one sync)."""
        for i in range(start, k):
            self.replay()
            self.toks[:, i].copy_(self.tok)
        return self.toks[:, :k]


def spec_window_into(params, cfg, pages, dparams, dcfg, dpages, s: State,
                     proposed: torch.Tensor, packed: torch.Tensor, *,
                     null_block: int, act_dtype: torch.dtype) -> None:
    """One speculative window in place (DESIGN.md §16): the draft
    model (``dparams``, ``dcfg``, ``dpages``) proposes ``W`` tokens per
    slot into ``proposed`` [B, W], then the target verifies them into
    ``packed`` [B, W + 1].  ``s`` holds the engine's tensors: "logits",
    "positions", "tables", "active", "draft_logits", "draft_tables" and
    the budget "max_emit".  What :class:`SpecGraph` captures, and what a
    CPU engine runs eagerly."""
    M.draft_window_into(
        dparams, dcfg, dpages,
        {"target_logits": s["logits"], "logits": s["draft_logits"],
         "positions": s["positions"], "tables": s["draft_tables"],
         "active": s["active"]},
        proposed, target_vocab=cfg.vocab_size, act_dtype=act_dtype)
    M.verify_window_into(
        params, cfg, pages,
        {"logits": s["logits"], "positions": s["positions"],
         "tables": s["tables"], "active": s["active"],
         "max_emit": s["max_emit"]},
        proposed, packed, null_block=null_block, act_dtype=act_dtype)


class SpecGraph(CapturedStep):
    """A paged engine's whole speculative window (DESIGN.md §16) as one
    graph: ``W = draft_k + 1`` fused decode steps of the draft model on
    its own pool and tables, from a scratch copy of the positions
    (the draft's advance is discarded, as in the reference), then the
    target's one verify pass over the ``W`` proposals.  It writes the
    engine's logits, positions, draft logits and both pools in place,
    and the packed ``[B, W + 1]`` tokens and emit counts into
    :attr:`packed`, the window's one readback.

    Its one host-computed input, the per-slot emit budget, is the static
    device buffer :attr:`max_emit`, which :meth:`run` fills from pinned
    memory before each replay, without a sync (the previous window's
    readback has waited for the previous copy).  ``live=True`` (the
    lazy capture at an engine's first window, under that window's budget
    ``max_emit``): the warm-up run is that window, and its result is in
    :attr:`packed`.  ``live=False`` (``warmup()``): it runs on an idle
    copy of the state (null tables, position 0, no slot active, a budget
    of 1), which writes only into the null blocks of the two pools.  The split
    counters cover the larger of the two models' query heads."""

    def __init__(self, engine, *, live: bool, max_emit=None):
        dev, b, w = engine.logits.device, engine.slots, engine.spec_w
        self.max_emit = torch.ones(b, dtype=torch.int32, device=dev)
        self._max_emit_host = torch.ones(b, dtype=torch.int32,
                                         pin_memory=True)
        self.proposed = proposed = torch.zeros((b, w), dtype=torch.int32,
                                               device=dev)
        self.packed = packed = torch.zeros((b, w + 1), dtype=torch.int32,
                                           device=dev)
        params, cfg, pages = engine.params, engine.cfg, engine.pages
        dparams, dcfg, dpages = (engine.draft_params, engine.draft_cfg,
                                 engine.draft_pages)
        dtype, null = engine.dtype, engine.null_block
        state = engine._spec_state(self.max_emit)
        warm = None if live else engine._idle_spec_state()
        if live:
            self.set_budget(max_emit)

        def step(s: State) -> None:
            spec_window_into(params, cfg, pages, dparams, dcfg, dpages, s,
                             proposed, packed, null_block=null,
                             act_dtype=dtype)

        heads = max(_query_heads(params), _query_heads(dparams))
        super().__init__(step, state, rows=b, heads=heads, device=dev,
                         stream=torch.cuda.Stream(device=dev), warm=warm)

    def set_budget(self, max_emit) -> None:
        """Queue the copy of the host's per-slot budget ``max_emit``
        (numpy int32 [B]) into :attr:`max_emit`."""
        self._max_emit_host.numpy()[:] = max_emit
        self.max_emit.copy_(self._max_emit_host, non_blocking=True)

    def run(self, max_emit) -> torch.Tensor:
        """One speculative window under the budget ``max_emit``; returns
        :attr:`packed` (on the device: reading it is the caller's one
        sync)."""
        self.set_budget(max_emit)
        self.replay()
        return self.packed
