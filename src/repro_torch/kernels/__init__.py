"""Hand-written Hopper kernels of the port and their plain versions.

Every kernel launch is one registered torch op, ``repro_torch::<name>``
(:func:`register_op`), with three parts: a ``"CUDA"`` implementation
(the ctypes launch of ``*/kernel.py``), a fake implementation (the
outputs' shapes and dtypes, no data: what fake and meta tensors run) and
a flop formula for ``torch.utils.flop_counter`` (the matrix products of
the function the reference's model computes at that call).  So a dry
run (``launch/roofline.py``) sees each kernel as one op at its
boundary, as XLA sees a custom call.  No CPU implementation is
registered: the wrappers send CPU tensors to the plain versions before
they reach an op.  Each CUDA implementation is marked ``@hot_path``, so
the hot-path lint's closure reaches the launchers through it, as it did
through the wrappers' direct calls."""
from __future__ import annotations

from typing import Callable

import torch
import torch.utils.flop_counter

_LIB = torch.library.Library("repro_torch", "FRAGMENT")


def device_route(t: torch.Tensor) -> str:
    """Where a wrapper sends ``t``: ``"cuda"`` to the kernel's op (on a
    ``meta`` tensor the op's fake implementation: shapes only, as the
    dry run traces), ``"cpu"`` to the plain version; any other device
    raises."""
    if t.device.type in ("cuda", "meta"):
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"the kernels run on cuda or cpu, not {t.device}")


def register_op(name: str, schema: str, cuda: Callable, fake: Callable,
                flops: Callable):
    """Define ``repro_torch::<name><schema>`` with ``cuda`` as its CUDA
    implementation, ``fake`` as its fake (and meta) implementation and
    ``flops(*shapes, out_shape=...)`` as its flop formula (tensor
    arguments arrive as shapes); returns the op.  A second import of the
    package in one process (``scripts/chip_tools.py`` ``use_tree``)
    keeps the definition and replaces the implementations."""
    if not hasattr(torch.ops.repro_torch, name):
        _LIB.define(name + schema)
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    op = getattr(torch.ops.repro_torch, name)
    torch.utils.flop_counter.register_flop_formula(op)(flops)
    return op


# Shared by the ctypes launchers (``*/kernel.py``).

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda(name: str, t: torch.Tensor, *, dtype=None, dim=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``dim`` dimensions (either may be None)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if dim is not None and t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dtype_code(q: torch.Tensor) -> int:
    """The kernels' dtype code for ``q`` (0 = f32, 1 = bf16)."""
    code = _DTYPE_CODE.get(q.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernels take "
                         f"{sorted(map(str, _DTYPE_CODE))}")
    return code


def raise_on(rc: int, name: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if rc:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
