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

from typing import Optional, Tuple

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


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                     dstate: Optional[torch.Tensor], chunk: int
                     ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's formulas: the gradient of
    :func:`ssd_chunked_ref` (y, final state) with respect to (x, dt, a,
    b, c), given dy [B, S, H, P] and ``dstate`` [B, H, P, N] (None: the
    final state is dropped).  Returns (dx [B, S, H, P], ddt [B, S, H], da
    [H], db [B, S, N], dc [B, S, N]) in f32 (f64 for f64 inputs).

    As the kernel, it keeps the chunk C = min(chunk, S) and zero-fills
    the last chunk's rows past S (dt = 0, x = b = c = dy = 0): such a row
    leaves the decay at 1 and adds nothing, so this is the function of
    ``ssd_chunked_ref``, which shrinks the chunk until it divides S
    instead.  For one (row, head) and chunk, with cum_i = sum_{t<=i} dt_t
    a, tot = cum_last, G = C.B^T, L_ij = exp(cum_i - cum_j) (i >= j, else
    0), u_j = exp(tot - cum_j) dt_j, the incoming state S_in and the
    outgoing state's gradient dS (``dstate`` or zero for the last chunk),
    the chunks are walked in reverse:

    - inter term (y_i += exp(cum_i) S_in c_i): dc_i += exp(cum_i) S_in^T
      dy_i, dcum_i += exp(cum_i) dy_i . (S_in c_i), and the incoming
      state's gradient dS_in = exp(tot) dS + sum_i exp(cum_i) dy_i c_i^T
      becomes the previous chunk's dS;
    - state update (S_out = exp(tot) S_in + sum_j u_j x_j b_j^T): dx_j
      += u_j dS b_j, db_j += u_j dS^T x_j, du_j = x_j . dS b_j, which
      gives ddt_j += du_j exp(tot - cum_j), dcum_j -= du_j u_j and dtot
      += du_j u_j; dtot also gets exp(tot) <dS, S_in>;
    - intra term (y_i += sum_{j<=i} G_ij L_ij dt_j x_j): dW_ij = dy_i .
      x_j, dx_j += sum_i W_ij dy_i, dG_ij = dW_ij L_ij dt_j, dc_i +=
      sum_j dG_ij b_j, db_j += sum_i dG_ij c_i, R_ij = dW_ij G_ij L_ij:
      ddt_j += sum_i R_ij, dcum_i += sum_j R_ij dt_j, dcum_j -= sum_i
      R_ij dt_j;
    - finish: dtot joins dcum of the chunk's last row, a reverse cumsum
      turns dcum into d(dt a) = ds, ddt += ds a and da = sum ds dt.

    db and dc sum over the heads (B and C are one group shared by every
    head), da over the rows and positions.  L is selected, never a
    product with a zero mask, so the gradient above the diagonal is
    exactly zero."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    cl = min(chunk, s)
    nc = -(-s // cl)
    pad = nc * cl - s

    def chunks(t, *tail):
        t = torch.nn.functional.pad(t.to(f), (0, 0) * len(tail) + (0, pad))
        return t.reshape(bsz, nc, cl, *tail)

    xc, dyc = chunks(x, h, p), chunks(dy, h, p)
    dtc, bc, cc = chunks(dt, h), chunks(b, n), chunks(c, n)
    a = a.to(f)
    cum = torch.cumsum(dtc * a, dim=2)                     # [B,Nc,C,H]
    tot = cum[:, :, -1, :]                                 # [B,Nc,H]
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    u = torch.exp(tot[:, :, None, :] - cum) * dtc          # [B,Nc,C,H]

    # the forward's incoming state of every chunk
    chunk_states = torch.einsum("bzjn,bzjhp->bzhpn", bc, xc * u[..., None])
    state = torch.zeros((bsz, h, p, n), dtype=f, device=x.device)
    states_in = []
    for z in range(nc):
        states_in.append(state)
        state = state * torch.exp(tot[:, z])[:, :, None, None] \
            + chunk_states[:, z]

    dx, ddt, dcum = (torch.zeros_like(t) for t in (xc, dtc, cum))
    db, dc = torch.zeros_like(bc), torch.zeros_like(cc)
    ds_carry = (torch.zeros((bsz, h, p, n), dtype=f, device=x.device)
                if dstate is None else dstate.to(f))
    for z in reversed(range(nc)):
        xz, dyz, bz, cz = xc[:, z], dyc[:, z], bc[:, z], cc[:, z]
        dtz, cumz, uz = dtc[:, z], cum[:, z], u[:, z]
        s_in, d_out = states_in[z], ds_carry
        e_cum, e_tot = torch.exp(cumz), torch.exp(tot[:, z])
        # inter term and the incoming state's gradient
        sc = torch.einsum("bhpn,bin->bihp", s_in, cz)
        dcum[:, z] += e_cum * torch.einsum("bihp,bihp->bih", dyz, sc)
        dc[:, z] += torch.einsum("bih,bihp,bhpn->bin", e_cum, dyz, s_in)
        ds_carry = (e_tot[:, :, None, None] * d_out
                    + torch.einsum("bih,bihp,bin->bhpn", e_cum, dyz, cz))
        # state update
        v = torch.einsum("bhpn,bjn->bjhp", d_out, bz)
        dx[:, z] += uz[..., None] * v
        db[:, z] += torch.einsum("bjh,bhpn,bjhp->bjn", uz, d_out, xz)
        du = torch.einsum("bjhp,bjhp->bjh", xz, v)
        ddt[:, z] += du * torch.exp(tot[:, z, None, :] - cumz)
        dcum[:, z] -= du * uz
        dtot = (e_tot * torch.einsum("bhpn,bhpn->bh", d_out, s_in)
                + (du * uz).sum(1))
        # intra term
        diff = cumz[:, :, None, :] - cumz[:, None, :, :]   # [B,Ci,Cj,H]
        lz = torch.exp(torch.where(mask, diff, torch.full_like(
            diff, float("-inf"))))
        g = torch.einsum("bin,bjn->bij", cz, bz)[..., None]
        dw = torch.einsum("bihp,bjhp->bijh", dyz, xz)
        w = g * lz * dtz[:, None, :, :]
        dx[:, z] += torch.einsum("bijh,bihp->bjhp", w, dyz)
        dg = dw * lz * dtz[:, None, :, :]
        dc[:, z] += torch.einsum("bijh,bjn->bin", dg, bz)
        db[:, z] += torch.einsum("bijh,bin->bjn", dg, cz)
        r = dw * g * lz
        ddt[:, z] += r.sum(1)
        q = r * dtz[:, None, :, :]
        dcum[:, z] += q.sum(2) - q.sum(1)
        dcum[:, z, -1] += dtot
    ds = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = ddt + ds * a
    da = (ds * dtc).sum((0, 1, 2))

    def unchunk(t, *tail):
        return t.reshape(bsz, nc * cl, *tail)[:, :s]

    return (unchunk(dx, h, p), unchunk(ddt, h), da, unchunk(db, n),
            unchunk(dc, n))
