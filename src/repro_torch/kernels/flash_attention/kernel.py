"""Hand-written Hopper kernel for dense GQA prefill attention, launched
through ctypes (source: ``repro_torch/csrc/flash_attention.cu``).

``flash_attention_kernel`` replaces the TPU kernel of the same name in
``src/repro/kernels/flash_attention/kernel.py`` (body ``_kernel``).  Each
block loops over keys only from the sliding window's edge to the causal
frontier of its query tile, so the work follows the unmasked region.  In
bf16 (the serves) it runs on the tensor cores: K/V tiles by TMA into a
shared-memory ring, S = Q.K^T and O += P.V by wgmma with the softmax and O
in registers, bound at the serving shapes by the bytes of q, k, v and out;
head sizes 32, 64 and 128.  In f32 it is a scalar kernel on the CUDA
cores, which keeps true f32 products (the source says more).

Takes CUDA tensors only; validates device, dtype, shape and contiguity,
allocates the output, launches on the current stream and raises if the
launch is refused.  It does not synchronise."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import check_cuda, dtype_code, raise_on
from repro_torch.kernels.build import load_library

BF16_HEAD_SIZES = (32, 64, 128)   # the tensor-core kernel's D values


def flash_attention_kernel(q, k, v, *, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] (Sq == Sk) -> [B, S, Hq, D]."""
    code = dtype_code(q)
    if q.dtype == torch.bfloat16 and q.shape[-1] not in BF16_HEAD_SIZES:
        raise ValueError(f"bf16 prefill head size {q.shape[-1]} not in "
                         f"{BF16_HEAD_SIZES}")
    check_cuda("q", q, dim=4)
    check_cuda("k", k, dtype=q.dtype, dim=4)
    check_cuda("v", v, dtype=q.dtype, dim=4)
    b, s, hq, d = q.shape
    if (k.shape[:2] != (b, s) or k.shape[3] != d or v.shape != k.shape
            or hq % k.shape[2]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (the kernel "
                         f"takes Sq == Sk)")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary "
                                 f"(TMA and 16-byte loads)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = load_library().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            hq, k.shape[2], d, int(causal), window or 0, code,
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(rc, "flash_attention")
    return out
