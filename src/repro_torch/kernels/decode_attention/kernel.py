"""Hand-written Hopper kernels for paged attention, launched through
ctypes (sources: ``repro_torch/csrc/paged_decode_attention.cu`` and
``repro_torch/csrc/paged_prefix_prefill_attention.cu``).

``paged_decode_attention_kernel`` replaces the TPU kernel of the same name
in ``src/repro/kernels/decode_attention/kernel.py`` (body
``_paged_kernel``); ``paged_prefix_prefill_attention_kernel`` replaces
its namesake there (body ``_prefix_prefill_kernel``).  Both are bound by
the bytes they read: each block walks only the pages its row's length
covers, so the bytes follow the real context, not the table width (the
sources say more).

These functions take CUDA tensors only; they validate device, dtype,
shape and contiguity, allocate the output, launch on the current stream
and raise if the launch is refused.  They do not synchronise.
``ops.py`` picks between them and the plain versions in ``ref.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(name: str, t: torch.Tensor, *, dtype=None, dim=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if dim is not None and t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _float_code(q: torch.Tensor) -> int:
    code = _DTYPE_CODE.get(q.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernels take "
                         f"{sorted(map(str, _DTYPE_CODE))}")
    return code


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def paged_decode_attention_kernel(q, k_pages, v_pages, block_tables,
                                  lengths) -> torch.Tensor:
    """q: [B, Hq, D]; pages: [num_blocks, bt, Hkv, D]; block_tables:
    [B, max_blocks] int32; lengths: [B] int32 -> [B, Hq, D]."""
    code = _float_code(q)
    _check("q", q, dim=3)
    _check("k_pages", k_pages, dtype=q.dtype, dim=4)
    _check("v_pages", v_pages, dtype=q.dtype, dim=4)
    _check("block_tables", block_tables, dtype=torch.int32, dim=2)
    _check("lengths", lengths, dtype=torch.int32, dim=1)
    b, hq, d = q.shape
    _, bt, hkv, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d or hq % hkv \
            or block_tables.shape[0] != b or lengths.shape[0] != b:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, tables "
            f"{tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = load_library().repro_paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, hq, hkv, d, bt, block_tables.shape[1], code,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "paged_decode_attention")
    return out


def paged_prefix_prefill_attention_kernel(q, k_suf, v_suf, k_pages, v_pages,
                                          block_tables, prefix_lens,
                                          suffix_lens) -> torch.Tensor:
    """q: [B, S, Hq, D]; k_suf, v_suf: [B, S, Hkv, D]; pages:
    [num_blocks, bt, Hkv, D]; block_tables: [B, M] int32; prefix_lens,
    suffix_lens: [B] int32 -> [B, S, Hq, D]."""
    code = _float_code(q)
    _check("q", q, dim=4)
    _check("k_suf", k_suf, dtype=q.dtype, dim=4)
    _check("v_suf", v_suf, dtype=q.dtype, dim=4)
    _check("k_pages", k_pages, dtype=q.dtype, dim=4)
    _check("v_pages", v_pages, dtype=q.dtype, dim=4)
    _check("block_tables", block_tables, dtype=torch.int32, dim=2)
    _check("prefix_lens", prefix_lens, dtype=torch.int32, dim=1)
    _check("suffix_lens", suffix_lens, dtype=torch.int32, dim=1)
    b, s, hq, d = q.shape
    _, bt, hkv, dk = k_pages.shape
    if (k_suf.shape != (b, s, hkv, d) or v_suf.shape != k_suf.shape
            or v_pages.shape != k_pages.shape or dk != d or hq % hkv
            or block_tables.shape[0] != b or prefix_lens.shape[0] != b
            or suffix_lens.shape[0] != b):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k_suf "
            f"{tuple(k_suf.shape)}, pages {tuple(k_pages.shape)}, tables "
            f"{tuple(block_tables.shape)}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = load_library().repro_paged_prefix_prefill_attention(
            q.data_ptr(), k_suf.data_ptr(), v_suf.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            prefix_lens.data_ptr(), suffix_lens.data_ptr(), out.data_ptr(),
            b, s, hq, hkv, d, bt, block_tables.shape[1], code,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "paged_prefix_prefill_attention")
    return out
