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
                        window: Optional[int] = None) -> torch.Tensor:
    """Exact softmax attention.  q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D]
    -> [B, Sq, Hq, D].  Query i sits at position i + Sk - Sq; ``causal``
    hides later keys, ``window`` keys at or beyond ``window`` positions
    back."""
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
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)
