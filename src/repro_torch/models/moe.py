"""Mixture-of-experts FFN (the reference package's ``models/moe.py``):
Switch-style capacity dispatch (:func:`moe_forward`) and the dropless
sorted form (:func:`moe_forward_ragged`), with the shared experts.

Both follow the reference's arithmetic step by step, which matters
because the capacity couples the tokens of a group:

- the router runs in f32 whatever the activations' dtype (its weights
  stay f32: ``transformer.KEEP_F32``);
- the ``T = B * S`` tokens are flattened row-major into ``G`` groups of
  ``Tg`` (``_num_groups``), and each (group, expert) keeps at most
  ``cap`` assignments, ranked over the flattened (token, k) order: a
  token's output depends on every token before it in its group, pad rows
  and idle slots included;
- the dispatch and combine weights are built in bf16 (so an f32 run
  combines with bf16-rounded gate values), then cast to the activations'
  dtype.

Nothing here reads a tensor back to the host: group counts and the
capacity come from static shapes, the one-hots are comparisons with an
``arange``, and the ragged form's grouped products run at a static shape
(each expert's rows padded to ``T``, the most one expert can receive, as
a token picks an expert at most once), so both capture into a CUDA
graph.  The padded grouped product does ``E / K`` times the ragged
form's arithmetic; it is not on the serving path (``cfg.moe_ragged`` is
off in every config of the repo).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import swiglu


def _num_groups(t: int, target: int) -> int:
    """Largest G with T % G == 0 and T/G <= target (Tg ~ target)."""
    g = max(1, math.ceil(t / target))
    while t % g:
        g += 1
    return g


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``F.one_hot`` without its host read of the largest index (on the
    CPU it checks the values against ``n``): an index outside
    ``[0, n)`` gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(p: Dict, xt: torch.Tensor, m: MoEConfig):
    """f32 router over ``xt`` [..., d]: (probs [..., E], top-k gates
    renormalised to sum 1 [..., K], expert ids [..., K])."""
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    gate_vals, idx = torch.topk(probs, m.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, idx


def _aux(probs: torch.Tensor, sel: torch.Tensor, m: MoEConfig
         ) -> torch.Tensor:
    """Switch load-balance loss: E * sum_e(frac_tokens_e * mean_prob_e);
    ``sel`` [..., K, E] is the top-k one-hot, ``probs`` [..., E]."""
    lead = tuple(range(probs.dim() - 1))
    frac = sel.sum(-2).mean(dim=lead)
    mean_p = probs.mean(dim=lead)
    return m.num_experts * torch.sum(frac * mean_p) * m.router_aux_coef


def _with_shared(p: Dict, x: torch.Tensor, y: torch.Tensor,
                 m: MoEConfig) -> torch.Tensor:
    """``y`` plus the shared (always-on) experts' SwiGLU of ``x``."""
    if not m.num_shared:
        return y
    sh = p["shared"]
    return y + swiglu(x, sh["gate"], sh["up"], sh["down"])


def moe_forward(p: Dict, x: torch.Tensor, m: MoEConfig,
                group_size: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux load-balance loss, f32 scalar).
    ``p``: ``router [d, E]`` (f32), ``gate``/``up [E, d, f]``, ``down
    [E, f, d]`` and, with shared experts, ``shared`` {gate, up, down}."""
    bsz, s, d = x.shape
    t = bsz * s
    e, k = m.num_experts, m.top_k
    g = _num_groups(t, group_size)
    tg = t // g
    cap = max(1, math.ceil(tg * k / e * m.capacity_factor))

    xt = x.reshape(g, tg, d)
    probs, gate_vals, idx = _route(p, xt, m)                   # [G,Tg,*]
    sel = _one_hot(idx, e, torch.float32)                      # [G,Tg,K,E]
    # rank of each (token, k) in its expert's buffer, over the flattened
    # (Tg, K) order of its group; past ``cap`` it is dropped
    flat = sel.reshape(g, tg * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, tg, k, e)
    sel_ok = ((pos < cap) & (sel > 0)).float() * sel
    sel_e = sel_ok.sum(2)                                      # [G,Tg,E]
    pos_e = (pos * sel_ok).sum(2).long()
    gate_e = (gate_vals[..., None] * sel_ok).sum(2)
    pos_oh = _one_hot(pos_e, cap, torch.bfloat16)              # [G,Tg,E,C]
    dispatch = (sel_e.to(torch.bfloat16)[..., None] * pos_oh).to(x.dtype)
    combine = (gate_e.to(torch.bfloat16)[..., None] * pos_oh).to(x.dtype)

    # einsum("gtec,gtd->gecd"), then the experts' products over all
    # groups' buffers at once: [E, G*C, d]
    xe = torch.bmm(dispatch.reshape(g, tg, e * cap).transpose(1, 2), xt)
    xe = xe.view(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    h = F.silu(torch.bmm(xe, p["gate"])) * torch.bmm(xe, p["up"])
    ye = torch.bmm(h, p["down"])
    ye = ye.view(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    y = torch.bmm(combine.reshape(g, tg, e * cap), ye)         # [G,Tg,d]
    return _with_shared(p, x, y.reshape(bsz, s, d), m), _aux(probs, sel, m)


def moe_forward_ragged(p: Dict, x: torch.Tensor, m: MoEConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless MoE: every routed (token, k) computed once, sorted by
    expert.  x: [B, S, d] -> (y, aux); equal to :func:`moe_forward` with
    a capacity no group reaches.  The reference's ``ragged_dot`` becomes
    one batched product over per-expert buffers of ``T`` rows, filled at
    (expert, rank within the expert's sorted run)."""
    bsz, s, d = x.shape
    t = bsz * s
    e, k = m.num_experts, m.top_k
    xt = x.reshape(t, d)
    probs, gate_vals, idx = _route(p, xt, m)                   # [T, *]

    flat_ids = idx.reshape(t * k)
    order = torch.argsort(flat_ids, stable=True)
    inv = torch.argsort(order)
    xr = xt.repeat_interleave(k, dim=0)[order]                 # [T*K, d]
    sizes = _one_hot(flat_ids, e, torch.int64).sum(0)          # [E]
    ids = flat_ids[order]
    rank = (torch.arange(t * k, device=x.device)
            - (torch.cumsum(sizes, 0) - sizes)[ids])
    buf = xr.new_zeros(e, t, d)
    buf[ids, rank] = xr
    h = F.silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    yr = torch.bmm(h, p["down"])[ids, rank]                    # [T*K, d]
    yr = yr[inv] * gate_vals.reshape(t * k, 1).to(yr.dtype)
    y = yr.reshape(t, k, d).sum(dim=1).reshape(bsz, s, d)
    return (_with_shared(p, x, y, m),
            _aux(probs, _one_hot(idx, e, torch.float32), m))
