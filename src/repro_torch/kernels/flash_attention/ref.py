"""Plain PyTorch version of the flash-attention prefill kernel: a port of
the reference package's oracle (``src/repro/kernels/flash_attention/
ref.py``).  It is the CPU path of ``ops.py`` and the yardstick the kernel
is held against."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Exact softmax attention.  q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D]
    -> [B, Sq, Hq, D].  Query i sits at position i + Sk - Sq; ``causal``
    hides later keys, ``window`` keys at or beyond ``window`` positions
    back, and ``kv_len`` keys at or past ``kv_len`` (the reference's
    ``seq_k`` mask with K cut to ``kv_len``).  The end-aligned query
    position matters only to the causal and window masks; without them
    (the kernel's only mode with Sq != Sk) every query sees the same
    keys.  The values at or past ``kv_len`` are zeroed before the product,
    as the kernel never reads them, so whatever they hold (NaN included)
    cannot reach the output."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    dev = q.device
    qf = q.float().reshape(b, sq, hkv, g, d) * d ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    q_pos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=dev)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    if kv_len is not None:
        mask &= k_pos < kv_len
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    vf = v.float()
    if kv_len is not None:
        live = (torch.arange(sk, device=dev) < kv_len)[None, :, None, None]
        vf = torch.where(live, vf, torch.zeros_like(vf))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(b, sq, hq, d).to(q.dtype)
