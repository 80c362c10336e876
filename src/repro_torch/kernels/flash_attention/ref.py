"""Plain PyTorch versions of the flash-attention prefill kernel and of its
backward: a port of the reference package's oracle (``src/repro/kernels/
flash_attention/ref.py``), and the FlashAttention-2 gradient formulas
from the forward's log-sum-exp.  They are the CPU path of ``ops.py`` and
the yardsticks the kernels are held against."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _up(x: torch.Tensor) -> torch.Tensor:
    """f32 for bf16 and f32 inputs, as the kernels compute; f64 stays
    f64 (a plain run given f64 inputs is f64 throughout)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: Optional[int], kv_len: Optional[int]):
    """(scaled scores [B, Hkv, G, Sq, Sk] (f32, f64 for f64 inputs) with
    hidden keys at ``NEG_INF``, the mask [Sq, Sk], the keys' liveness
    [1, Sk, 1, 1])."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    dev = q.device
    qf = _up(q).reshape(b, sq, hkv, hq // hkv, d) * d ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, _up(k))
    q_pos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=dev)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    if kv_len is not None:
        mask &= k_pos < kv_len
    live = (torch.arange(sk, device=dev) < (sk if kv_len is None else kv_len)
            )[None, :, None, None]
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask, live


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        kv_len: Optional[int] = None,
                        with_lse: bool = False):
    """Exact softmax attention.  q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D]
    -> [B, Sq, Hq, D].  Query i sits at position i + Sk - Sq; ``causal``
    hides later keys, ``window`` keys at or beyond ``window`` positions
    back, and ``kv_len`` keys at or past ``kv_len`` (the reference's
    ``seq_k`` mask with K cut to ``kv_len``).  The end-aligned query
    position matters only to the causal and window masks; without them
    (the kernel's only mode with Sq != Sk) every query sees the same
    keys.  The values at or past ``kv_len`` are zeroed before the product,
    as the kernel never reads them, so whatever they hold (NaN included)
    cannot reach the output.  ``with_lse`` also returns each query row's
    log-sum-exp of its scaled scores, lse [B, Sq, Hq], as the f32 kernel
    writes it for the backward.  bf16 and f32 inputs compute in f32, f64
    inputs in f64."""
    b, sq, hq, d = q.shape
    s, _, live = _scores(q, k, causal, window, kv_len)
    p = torch.softmax(s, dim=-1)
    vf = torch.where(live, _up(v), torch.zeros_like(_up(v)))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    out = o.reshape(b, sq, hq, d).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)                  # [B, Hkv, G, Sq]
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, hq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            kv_len: Optional[int] = None):
    """The backward kernel's formulas (in f32; f64 for f64 inputs): with
    P = exp(scores - lse) on the visible keys (0 elsewhere), delta =
    rowsum(dout * out), dP = dout . V^T and dS = P * (dP - delta),
    returns (dq = scale * dS . K, dk = scale * dS^T . Q, dv = P^T .
    dout), dk and dv summed over each KV head's G query heads.  K and V at or past ``kv_len`` are zeroed
    first, as the kernel stages them, so those keys get dk = dv = 0
    whatever they hold."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    s, mask, live = _scores(q, k, causal, window, kv_len)
    lse4 = lse.to(s.dtype).reshape(b, sq, hkv, g).permute(0, 2, 3, 1)
    p = torch.where(mask, torch.exp(s - lse4[..., None]),
                    torch.zeros_like(s))
    zeros = torch.zeros_like(_up(k))
    kf = torch.where(live, _up(k), zeros)
    vf = torch.where(live, _up(v), zeros)
    dof = _up(dout).reshape(b, sq, hkv, g, d)
    delta = (dof * _up(out).reshape(b, sq, hkv, g, d)).sum(-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    scale = d ** -0.5
    qs = _up(q).reshape(b, sq, hkv, g, d) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qs)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dq.reshape(b, sq, hq, d), dk, dv
