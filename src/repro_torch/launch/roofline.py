"""Roofline terms of a step of the port, counted on stand-in tensors (the
reference package's ``launch/roofline.py``, which parses XLA's optimized
HLO; eager PyTorch has none, so the step itself is run on tensors that
hold no data).

Three terms per (arch x shape x mesh), in seconds, for one rank's
program (the port computes the replicated model on every rank:
``partitioning.constrain`` is the identity):

  compute    = FLOPs / peak FLOP/s
  memory     = bytes / HBM bandwidth
  collective = collective bytes / (links * link bandwidth)

:func:`count_costs` runs a function on ``meta`` tensors under one
dispatch mode of its own around ``torch.utils.flop_counter``'s, and
counts by the reference's conventions:

- FLOPs: ``FlopCounterMode``'s (the matrix products; each hand-written
  kernel is one registered op with its own formula, ``kernels/*/ops.py``).
- Bytes: each op's results plus its operands, as XLA's "bytes accessed"
  counts an op; a view or alias moves nothing (0); an in-place copy, an
  index write or a scatter moves twice the slice it writes (the
  reference's dynamic-update-slice and scatter rules); an allocation
  without a write (``empty``) moves nothing.  This is an upper bound:
  every intermediate round-trips memory.
- Collectives: each collective op's result bytes, under the reference's
  five keys.
- ``peak_bytes``: the high-water mark of the live storages, the
  arguments' included (a storage leaves the count when it is freed).

The arguments are ``meta`` tensors: shapes and dtypes, no data, so
nothing is allocated on any device and no CUDA context is made.  Meta,
not fake CUDA, tensors (``FakeTensorMode``): on a CPU-only build of
PyTorch the autograd engine aborts the process on a fake CUDA tensor
(it asks for a CUDA stream), and the counts must not depend on the
build; meta tensors need no fake mode, which only slowed a trace on
the host.  The kernel wrappers send a meta tensor to their registered
op (``kernels.device_route``), whose fake implementation gives the
shapes.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict

import torch
import torch.utils.flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU datasheet): dense bf16
# tensor-core peak, HBM3 bandwidth, and fourth-generation NVLink, 18
# links of 50 GB/s (900 GB/s a card, both directions).
PEAK_FLOPS = 989e12          # bf16, dense
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 50e9               # bytes/s per NVLink link
NVLINK_LINKS = 18

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_NAMES = (("reduce_scatter", "reduce-scatter"),
                     ("allreduce", "all-reduce"),
                     ("all_reduce", "all-reduce"),
                     ("allgather", "all-gather"),
                     ("all_gather", "all-gather"),
                     ("alltoall", "all-to-all"),
                     ("all_to_all", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"),
                     ("broadcast", "collective-permute"),
                     ("p2p", "collective-permute"))
# writes of a slice, by the argument that holds the written values (the
# destination for copy_): twice their bytes (read the source, write it)
_SLICE_WRITES = {"copy": 0, "slice_scatter": 1, "select_scatter": 1,
                 "index_put": 2, "_index_put_impl": 2, "index_copy": 3,
                 "index_add": 3, "scatter": 3, "scatter_add": 3,
                 "scatter_reduce": 3, "masked_scatter": 2}
# ops that move no data although the schema does not call them views
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_unsafe_view"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    leaves, _ = tree_flatten(tree)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def _collective(func) -> str:
    if func.namespace not in ("c10d", "_c10d_functional"):
        return ""
    name = func.__name__
    for key, kind in _COLLECTIVE_NAMES:
        if key in name:
            return kind
    return ""


class _Counter(TorchDispatchMode):
    """Bytes, collective bytes and live storages of every op it sees."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collective = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._seen: "weakref.WeakSet" = weakref.WeakSet()

    def _free(self, n: int) -> None:
        self.live -= n

    def track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def _op_bytes(self, func, args, kwargs, outs) -> int:
        base = func._schema.name.split("::")[-1]
        if func.is_view or base in _FREE or not outs:
            return 0
        written = _SLICE_WRITES.get(base.rstrip("_"))
        if written is not None:
            vals = (list(args) + list(kwargs.values()))[written]
            return 2 * sum(map(_nbytes, _tensors(vals)))
        return (sum(map(_nbytes, _tensors((args, kwargs))))
                + sum(map(_nbytes, outs)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self.bytes += self._op_bytes(func, args, kwargs, outs)
        kind = _collective(func)
        if kind:
            self.collective[kind] += sum(map(_nbytes, outs))
        self.track(outs)
        return out


def _stand_in(x):
    if not isinstance(x, torch.Tensor) or x.device.type == "meta":
        return x
    return torch.empty_like(x, device="meta").requires_grad_(
        x.requires_grad)


def count_costs(fn: Callable, *args, **kw) -> Dict[str, Any]:
    """Run ``fn(*args, **kw)`` on ``meta`` stand-ins of its tensor
    arguments (a tensor on another device is replaced by one of its
    shape, dtype and ``requires_grad``) and count {"flops", "bytes",
    "collective_by_op", "peak_bytes"} by the conventions of the module's
    docstring.  Nothing is allocated."""
    counter = _Counter()
    args, kw = tree_map(_stand_in, (args, kw))
    counter.track(_tensors((args, kw)))
    with counter, torch.utils.flop_counter.FlopCounterMode(
            display=False) as flops:
        fn(*args, **kw)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes),
            "collective_by_op": counter.collective,
            "peak_bytes": float(counter.peak)}


@dataclasses.dataclass
class Roofline:
    flops: float                # per device
    hbm_bytes: float            # per device
    coll_bytes: float           # per device
    coll_by_op: Dict[str, int]
    peak_mem_bytes: float       # live storages' high-water mark, per device

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (NVLINK_LINKS * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "collective_by_op": self.coll_by_op,
            "peak_mem_gib": round(self.peak_mem_bytes / 2**30, 3),
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def analyze(fn: Callable, *args, **kw) -> Roofline:
    """:class:`Roofline` of ``fn(*args, **kw)`` (:func:`count_costs`)."""
    c = count_costs(fn, *args, **kw)
    coll = c["collective_by_op"]
    return Roofline(flops=c["flops"], hbm_bytes=c["bytes"],
                    coll_bytes=float(sum(coll.values())), coll_by_op=coll,
                    peak_mem_bytes=c["peak_bytes"])
