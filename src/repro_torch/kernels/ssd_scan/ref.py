"""Plain PyTorch versions of the Mamba2 SSD scan:

- :func:`ssd_scan_ref`, the naive per-token recurrence (a port of the
  reference package's oracle, ``src/repro/kernels/ssd_scan/ref.py``), an
  algorithm independent of the chunked kernel;
- :func:`ssd_chunked_ref`, the chunked SSD form the reference model runs
  (``ssd_chunked`` in ``src/repro/models/ssm.py``): the CPU path of
  ``ops.ssd_scan`` and the yardstick the CUDA kernel is held against.

Both compute in f32 and return ``(y [B, S, H, P], final state
[B, H, P, N])``."""
from __future__ import annotations

from typing import Tuple

import torch


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, H, P]; dt: [B, S, H] (> 0); a: [H] (< 0); b, c: [B, S, N].

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t b_t^T;  y_t = h_t c_t."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    x, dt, b, c, a = (t.float() for t in (x, dt, b, c, a))
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                          # [B, H]
        upd = (dt[:, t, :, None, None] * x[:, t, :, :, None]
               * b[:, t, None, None, :])                         # [B,H,P,N]
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1), state


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan: intra-chunk dual (attention-like) term,
    chunk states, and the inter-chunk recurrence.  x: [B, S, H, P]; dt:
    [B, S, H] (post-softplus); a: [H] (< 0); b, c: [B, S, N] (one group,
    shared by every head).  As in the reference, ``chunk`` shrinks until
    it divides S."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    while s % chunk:
        chunk -= 1
    nc = s // chunk
    xc = x.float().reshape(bsz, nc, chunk, h, p)
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    bc = b.float().reshape(bsz, nc, chunk, n)
    cc = c.float().reshape(bsz, nc, chunk, n)

    cum = torch.cumsum(dtc * a.float(), dim=2)             # [B,Nc,L,H]
    tot = cum[:, :, -1, :]                                 # [B,Nc,H]

    # intra-chunk dual term; the decay is selected, never multiplied by
    # a mask, so exp(li - lj) above the diagonal cannot leak inf * 0
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,Nc,Li,Lj,H]
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  torch.full_like(diff, -1e30)))
    cb = torch.einsum("bzin,bzjn->bzij", cc, bc)           # [B,Nc,Li,Lj]
    w = cb[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bzijh,bzjhp->bzihp", w, xc)

    # chunk states and the inter-chunk recurrence
    decay_out = torch.exp(tot[:, :, None, :] - cum)        # [B,Nc,L,H]
    xdt = xc * (dtc * decay_out)[..., None]
    chunk_states = torch.einsum("bzln,bzlhp->bzhpn", bc, xdt)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    states_in = []
    for z in range(nc):
        states_in.append(state)
        state = state * torch.exp(tot[:, z])[:, :, None, None] \
            + chunk_states[:, z]
    states_in = torch.stack(states_in, dim=1)              # [B,Nc,H,P,N]
    y_inter = (torch.einsum("bzln,bzhpn->bzlhp", cc, states_in)
               * torch.exp(cum)[..., None])
    return (y_intra + y_inter).reshape(bsz, s, h, p), state
