"""A decode step as a captured CUDA graph: the port's counterpart of the
reference's compiled decode entries (``_jitted`` in the reference
package's ``serving/engine.py``, which compiles ``decode_multi`` and
``decode_multi_paged`` into one XLA program per power-of-two window).

What is captured is ONE greedy step written in place on an engine's own
tensors: the argmax of the carried logits, the model's decode step, the
position advance, and the token written into a static ``[B]`` buffer.
A window of ``k`` steps is ``k`` replays, each followed by a copy of the
token into a ``[B, max_steps]`` buffer, and then the engine's one
``[B, k]`` readback.  One graph serves every window length, where the
reference compiles one program per power-of-two window.  Two engines
capture one:

- :meth:`DecodeGraph.paged`: ``decode_step_paged_into`` on the paged
  engine's pool, tables, positions and logits.  Its batch is always its
  ``slots``, so it captures once per engine, at its first window or in
  ``warmup()``.
- :meth:`DecodeGraph.padded`: ``decode_step_into`` on one padded batch's
  dense cache (or SSM state) and logits, with positions of its own.  A
  ``BatchEngine`` allocates that cache in each batch's prefill, so it
  captures once per batch, and the graph is dropped with the batch.

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
  the engine's one readback.
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
    family without attention (the SSM family launches no decode
    kernel)."""
    attn = params["blocks"].get("attn")
    return 0 if attn is None else attn["wq"].shape[2]


class DecodeGraph:
    """One decode step, warmed and captured at construction.

    ``step(state, tok)`` runs one greedy step in place on ``state`` and
    writes its token into ``tok``; the capture is of ``step(state,
    self.tok)``.  The warm-up step runs on ``warm``; with ``warm=None``
    (live) it runs on ``state`` itself, so it is the first step of the
    window being run, and its token is already in ``toks[:, 0]``.
    Both run on ``stream``, a side stream of ``device``: an engine that
    captures again and again passes the same one, so that cuBLAS's
    handle and workspace for it are made once.  ``step`` is kept, and
    with it what it closes over (the weights, the cache or the pages),
    whose addresses the graph replays on.  ``capture_s`` is the host time
    the capture took (the capture and the graph's instantiation, not the
    warm-up step)."""

    def __init__(self, step: Callable[[State, torch.Tensor], None],
                 state: State, *, rows: int, heads: int, max_steps: int,
                 device: torch.device, stream: torch.cuda.Stream,
                 warm: Optional[State] = None):
        self.step, self.state = step, state
        self.tok = torch.zeros(rows, dtype=torch.int32, device=device)
        self.toks = torch.zeros((rows, max(max_steps, 1)), dtype=torch.int32,
                                device=device)
        current = torch.cuda.current_stream(device)
        self.graph = torch.cuda.CUDAGraph()
        with decode_kernel.private_split_counters(device, rows * heads) \
                as counters:
            self.counters = counters
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                step(state if warm is None else warm, self.tok)
                current.wait_stream(stream)
                t0 = time.perf_counter()
                before = _launches()
                self.graph.capture_begin()
                try:
                    step(state, self.tok)
                finally:
                    self.graph.capture_end()
                    after = _launches()
                    for fn, n in before.items():
                        fn.launches = n
                self.capture_s = time.perf_counter() - t0
        self.delta = {fn: after[fn] - n for fn, n in before.items()
                      if after[fn] != n}
        if warm is None:
            self.toks[:, 0].copy_(self.tok)

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

    def replay(self) -> None:
        """One decode step on the captured state; each wrapper counts the
        launches the step makes."""
        self.graph.replay()
        for fn, n in self.delta.items():
            fn.launches += n

    def window(self, k: int, start: int = 0) -> torch.Tensor:
        """Steps ``start`` .. ``k - 1`` of a ``k``-step window, one replay
        each; returns the window's tokens ``[B, k]`` (on the device:
        reading them is the caller's one sync)."""
        for i in range(start, k):
            self.replay()
            self.toks[:, i].copy_(self.tok)
        return self.toks[:, :k]
