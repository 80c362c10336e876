"""The paged engine's decode step as a captured CUDA graph: the port's
counterpart of the reference's compiled decode entries (``_jitted`` in
the reference package's ``serving/engine.py``, which compiles
``decode_multi_paged`` into one XLA program per power-of-two window).

What is captured is ONE greedy step of
:func:`repro_torch.models.transformer.decode_multi_paged` on the
engine's own tensors: the argmax of the carried logits,
``decode_step_paged``, the position advance where the slot is active,
and the token written into a static ``[B]`` buffer.  The engine's batch
is always its ``slots``, so one graph per engine serves every window: a
window of ``k`` steps is ``k`` replays, each followed by a copy of the
token into a ``[B, max_gen]`` buffer, and then the engine's one
``[B, k]`` readback.  A graph binds one engine's tensors, so graphs are
per engine, where the reference's compiled programs are shared by every
engine of a (config, dtype).

Where a capture can go wrong, and what is done about it here:

- *Addresses.*  A graph replays on the addresses it captured.  The step
  writes the logits, the positions and the pages in place, and the
  engine never rebinds ``logits``, ``positions``, ``tables``,
  ``active_mask`` or ``pages`` (every other writer updates them in
  place too).
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
- *Host reads.*  A host read inside the step would make the capture
  fail; the step has none, and a replayed window reads nothing until
  the engine's one readback.
- *Launch counts.*  The kernels' wrappers count launches in Python,
  which does not run under replay.  Each wrapper's count grows by the
  launches it made while the step was captured; that growth is taken
  back (a capture launches nothing) and added again at every replay.

There is no eager fallback: a capture that fails raises."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as scan_ops
from repro_torch.models import model as M

_WRAPPERS = decode_ops.KERNELS + flash_ops.KERNELS + scan_ops.KERNELS


def _launches() -> Dict[object, int]:
    return {fn: fn.launches for fn in _WRAPPERS}


def decode_step_into(params, cfg, pages, state: Dict[str, torch.Tensor],
                     tok_out: torch.Tensor, *, act_dtype: torch.dtype
                     ) -> None:
    """One step of ``decode_multi_paged`` written in place: argmax the
    carried ``state["logits"]``, run ``decode_step_paged`` on
    ``state["positions"]`` and ``state["tables"]``, write the new logits
    into ``state["logits"]``, advance ``state["positions"]`` where
    ``state["active"]``, and write the step's token into ``tok_out``."""
    logits, positions = state["logits"], state["positions"]
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)
    new_logits, _ = M.decode_step_paged(
        params, cfg, pages, {"tokens": tok, "positions": positions,
                             "block_tables": state["tables"]},
        act_dtype=act_dtype)
    logits.copy_(new_logits)
    positions.add_(state["active"].to(positions.dtype))
    tok_out.copy_(tok)


class DecodeGraph:
    """One engine's decode step, warmed and captured at construction.

    ``live=True`` (the lazy capture at an engine's first window, as jit
    compiles at the first call): the warm-up step is the first step of
    the window the engine is running, on its own state, and its token is
    already in ``toks[:, 0]``.  ``live=False`` (``warmup()``): the
    warm-up step runs on an idle copy of the state (null tables,
    position 0, no slot active), which writes only into the null block
    of the pool."""

    def __init__(self, engine, *, live: bool):
        self._model = (engine.params, engine.cfg, engine.pages, engine.dtype)
        b = engine.slots
        dev = engine.logits.device
        self.tok = torch.zeros(b, dtype=torch.int32, device=dev)
        self.toks = torch.zeros((b, max(engine.max_gen, 1)),
                                dtype=torch.int32, device=dev)
        self.state = {"logits": engine.logits, "positions": engine.positions,
                      "tables": engine.tables, "active": engine.active_mask}
        if live:
            warm = self.state
        else:
            warm = {"logits": engine.logits.clone(),
                    "positions": torch.zeros_like(engine.positions),
                    "tables": engine._null_row[None, :].repeat(b, 1),
                    "active": torch.zeros_like(engine.active_mask)}
        hq = engine.params["blocks"]["attn"]["wq"].shape[2]
        stream = torch.cuda.Stream(device=dev)
        self.graph = torch.cuda.CUDAGraph()
        with decode_kernel.private_split_counters(dev, b * hq) as counters:
            self.counters = counters
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self._step(warm)
            torch.cuda.current_stream(dev).wait_stream(stream)
            before = _launches()
            try:
                with torch.cuda.graph(self.graph, stream=stream):
                    self._step(self.state)
            finally:
                after = _launches()
                for fn, n in before.items():
                    fn.launches = n
        self.delta = {fn: after[fn] - n for fn, n in before.items()
                      if after[fn] != n}
        if live:
            self.toks[:, 0].copy_(self.tok)

    def _step(self, state: Dict[str, torch.Tensor]) -> None:
        params, cfg, pages, dtype = self._model
        decode_step_into(params, cfg, pages, state, self.tok,
                         act_dtype=dtype)

    def replay(self) -> None:
        """One decode step on the engine's state; each wrapper counts the
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

