"""Hand-written Hopper kernels of the port and their plain versions."""
from __future__ import annotations

import torch


def device_route(t: torch.Tensor) -> str:
    """Where a wrapper sends ``t``: ``"cuda"`` to the kernel, ``"cpu"`` to
    the plain version; any other device raises."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"the kernels run on cuda or cpu, not {t.device}")


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
