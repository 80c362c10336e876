"""Hand-written Hopper kernels for dense GQA prefill attention and its
gradient, launched through ctypes (sources: ``repro_torch/csrc/
flash_attention.cu``, ``flash_attention_bwd.cu``).

``flash_attention_kernel`` replaces the TPU kernel of the same name in
``src/repro/kernels/flash_attention/kernel.py`` (body ``_kernel``).  Each
block loops over keys only from the sliding window's edge to the causal
frontier of its query tile, or to the key bound ``kv_len``, so the work
follows the unmasked region; in full (non-causal, unwindowed) mode the
queries and keys may be of different lengths (cross attention).  Both
dtypes run on the tensor cores: bf16 (the serves) with K/V tiles by TMA
into a shared-memory ring and S = Q.K^T and O += P.V by wgmma, f32 by
mma.sync in 3xTF32 (f32 accuracy); the softmax and O stay in registers.
Either can also write each query row's log-sum-exp for the backward.

``flash_attention_bwd_kernel`` is that forward's gradient, dQ, dK and
dV from the forward's log-sum-exp, in the same two dtypes on the same
mma.sync tile step; it replaces no TPU kernel (the JAX package
differentiates plain ``jnp``).

Head sizes 32, 64 and 128.  Takes CUDA tensors only; validates device,
dtype, shape, contiguity and 16-byte alignment, allocates the outputs,
launches on the current stream and raises if the launch is refused.  It
does not synchronise."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import check_cuda, dtype_code, raise_on
from repro_torch.kernels.build import load_library

HEAD_SIZES = (32, 64, 128)   # the kernels' D values, both dtypes


def _check_head(d: int) -> None:
    """Raise for a head size without a kernel instance, before any check
    of the device (a call on any device learns it)."""
    if d not in HEAD_SIZES:
        raise ValueError(f"flash head size {d} not in {HEAD_SIZES}")


def _check_aligned(**tensors) -> None:
    """Raise for a tensor off a 16-byte boundary (cp.async and TMA)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(cp.async and TMA)")


def check_modes(sq: int, sk: int, causal: bool, window: Optional[int],
                kv_len: Optional[int]) -> int:
    """The key bound a call runs with (``kv_len``, or ``sk``); raises a
    ``ValueError`` for a mode the kernel does not take: a causal or
    window mask with Sq != Sk (query i sits at position i), a window
    below 1, or a bound outside [1, Sk]."""
    if (causal or window is not None) and sq != sk:
        raise ValueError(f"a causal or window mask needs Sq == Sk (query i "
                         f"at position i), got Sq {sq}, Sk {sk}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    bound = sk if kv_len is None else int(kv_len)
    if not 1 <= bound <= sk:
        raise ValueError(f"kv_len {kv_len} outside [1, Sk = {sk}]")
    return bound


def flash_attention_kernel(q, k, v, *, causal: bool = True,
                           window: Optional[int] = None,
                           kv_len: Optional[int] = None,
                           with_lse: bool = False):
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D].  Keys
    at or past ``kv_len`` (default Sk) are masked and never read; Sq !=
    Sk only in full mode (:func:`check_modes`).  ``with_lse`` returns
    (out, lse [B, Sq, Hq] f32): each query row's log-sum-exp of its
    scaled scores (+inf for a row with no visible key), which
    :func:`flash_attention_bwd_kernel` reads."""
    code = dtype_code(q)
    _check_head(q.shape[-1])
    check_cuda("q", q, dim=4)
    check_cuda("k", k, dtype=q.dtype, dim=4)
    check_cuda("v", v, dtype=q.dtype, dim=4)
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    if (k.shape[0] != b or k.shape[3] != d or v.shape != k.shape
            or hq % k.shape[2]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    bound = check_modes(sq, sk, causal, window, kv_len)
    _check_aligned(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        rc = load_library().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, sq, sk, hq,
            k.shape[2], d, int(causal), window or 0, bound, code,
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(rc, "flash_attention")
    return (out, lse) if with_lse else out


def flash_attention_bwd_kernel(q, k, v, out, dout, lse, *,
                               causal: bool = True,
                               window: Optional[int] = None,
                               kv_len: Optional[int] = None):
    """The gradient of :func:`flash_attention_kernel`: q, out, dout [B,
    Sq, Hq, D]; k, v [B, Sk, Hkv, D], all f32 or all bf16; lse [B, Sq,
    Hq] f32 from the forward's ``with_lse`` launch with the same mask ->
    (dq, dk, dv) in the inputs' dtype, dk and dv summed over each KV
    head's query heads and zero for the keys at or past ``kv_len``.  Two
    CUDA launches a call: each row's rowsum(dout * out) into a scratch,
    then one grid of dQ blocks and dK/dV blocks."""
    code = dtype_code(q)
    _check_head(q.shape[-1])
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        check_cuda(name, t, dtype=q.dtype, dim=4)
    check_cuda("lse", lse, dtype=torch.float32, dim=3)
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    if (k.shape[0] != b or k.shape[3] != d or v.shape != k.shape
            or hq % k.shape[2] or out.shape != q.shape
            or dout.shape != q.shape or lse.shape != (b, sq, hq)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {tuple(lse.shape)}")
    bound = check_modes(sq, sk, causal, window, kv_len)
    _check_aligned(q=q, k=k, v=v, out=out, dout=dout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        rc = load_library().repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, k.shape[2], d,
            int(causal), window or 0, bound, code,
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(rc, "flash_attention_bwd")
    return dq, dk, dv
