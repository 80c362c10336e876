"""Multi-head latent attention of the MLA family (deepseek-v3; the
reference package's ``models/mla.py``).

The cache holds each token's compressed latent, ``c_kv [B, S, R]``
(``R = kv_lora_rank``), and its head-shared rotary key, ``k_rope [B,
S, Dr]``, not per-head K and V.  Prefill expands K and V from the
latent one KV chunk at a time inside an online-softmax loop
(:func:`mla_prefill`); decode takes the *absorbed* path
(:func:`mla_decode`): the query is projected into the latent space, so
no ``[S, H, D]`` key or value is formed against the cache.

The reference computes both in plain ``jnp`` (it has no kernel for
MLA), so this port computes them in plain PyTorch.  Two of its choices
carry over as they are: the norms of the query and KV latents use
``rms_norm``'s own eps of 1e-5 whatever ``cfg.norm_eps`` is, and MLA
has no sliding window.  Decode reads nothing on the host (its slot
writes are indexed, its mask a comparison with an ``arange``), so a
CUDA graph can capture it."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models.layers import apply_rope, rms_norm

NEG_INF = -1e30


def _pick_chunk(s: int, target: int = 1024) -> int:
    """The largest divisor of ``s`` that is at most ``target``."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _scale(m: MLAConfig) -> float:
    return (m.qk_nope_dim + m.qk_rope_dim) ** -0.5


def _queries(p: Dict, x: torch.Tensor, m: MLAConfig, num_heads: int,
             positions: torch.Tensor, theta: float):
    """x [B, S, d] -> (q_nope [B, S, H, Dn], q_rope [B, S, H, Dr]),
    the rope part rotated at ``positions`` [..., S]."""
    b, s, _ = x.shape
    q_lat = rms_norm(x @ p["q_a"], p["q_a_norm"])
    q = (q_lat @ p["q_b"].reshape(m.q_lora_rank, -1)).view(
        b, s, num_heads, -1)
    q_nope = q[..., :m.qk_nope_dim]
    q_rope = apply_rope(q[..., m.qk_nope_dim:], positions, theta)
    return q_nope, q_rope


def mla_latents(p: Dict, x: torch.Tensor, m: MLAConfig,
                positions: torch.Tensor, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache entries of ``x`` [B, S, d]: c_kv [B, S, R] (normed) and
    k_rope [B, S, Dr] (rotated as one head, shared by all)."""
    kv = x @ p["kv_a"]
    r = m.kv_lora_rank
    c_kv = rms_norm(kv[..., :r], p["kv_a_norm"])
    k_rope = apply_rope(kv[..., None, r:], positions, theta)[..., 0, :]
    return c_kv, k_rope


def _expand(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bkr,rhd->bkhd") as one matmul, in ``c``'s dtype."""
    b, k, r = c.shape
    return (c @ w.reshape(r, -1)).view(b, k, w.shape[1], w.shape[2])


def mla_prefill(p: Dict, x: torch.Tensor, m: MLAConfig, num_heads: int,
                positions: torch.Tensor, theta: float, chunk: int = 1024
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal MLA over a whole sequence: x [B, S, d], positions [S].
    Returns (out [B, S, d], (c_kv, k_rope)).

    K and V are expanded from the latent per KV chunk of
    ``_pick_chunk(S, chunk)`` keys, in the activations' dtype, then cast
    to f32 for the scores and the online softmax, so memory grows with
    ``S * chunk``, not ``S * S``.  The query is scaled by ``(Dn + Dr) **
    -0.5``; the mask is ``q_pos >= k_pos`` alone (no padding mask, no
    window), as in the reference."""
    b, s, _ = x.shape
    scale = _scale(m)
    q_nope, q_rope = _queries(p, x, m, num_heads, positions, theta)
    c_kv, k_rope = mla_latents(p, x, m, positions, theta)
    ck = _pick_chunk(s, chunk)
    # [B, H, S, *] layouts: the scores of a chunk are [B, H, S, ck]
    qn = (q_nope.float() * scale).transpose(1, 2)
    qr = (q_rope.float() * scale).transpose(1, 2)
    acc = x.new_zeros((b, num_heads, s, m.v_head_dim), dtype=torch.float32)
    mx = torch.full((b, num_heads, s), NEG_INF, dtype=torch.float32,
                    device=x.device)
    l = torch.zeros((b, num_heads, s), dtype=torch.float32, device=x.device)
    q_pos = positions
    for i in range(s // ck):
        c_blk = c_kv[:, i * ck:(i + 1) * ck]
        r_blk = k_rope[:, i * ck:(i + 1) * ck]
        k_nope = _expand(c_blk, p["k_b"]).float().permute(0, 2, 3, 1)
        v_blk = _expand(c_blk, p["v_b"]).float().transpose(1, 2)
        sc = qn @ k_nope + qr @ r_blk.float().transpose(1, 2)[:, None]
        k_pos = i * ck + torch.arange(ck, device=x.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        sc = sc.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(mx, sc.amax(-1))
        pr = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(mx - m_new)
        l = l * alpha + pr.sum(-1)
        acc = acc * alpha[..., None] + pr @ v_blk
        mx = m_new
    o = (acc / torch.clamp(l[..., None], min=1e-30)).transpose(1, 2)
    out = o.to(x.dtype).reshape(b, s, -1) @ p["out"].reshape(
        num_heads * m.v_head_dim, -1)
    return out, (c_kv, k_rope)


def absorbed_attention(q_nope: torch.Tensor, q_rope: torch.Tensor,
                       c_kv: torch.Tensor, k_rope: torch.Tensor,
                       k_b: torch.Tensor, v_b: torch.Tensor,
                       valid: torch.Tensor, scale: float) -> torch.Tensor:
    """One query per row against the latent cache, in f32: q_nope [B,
    H, Dn], q_rope [B, H, Dr], c_kv [B, S, R], k_rope [B, S, Dr], valid
    [B] (slots ``< valid`` are read) -> o [B, H, Dv].  The query is
    absorbed into the latent space (``q_nope @ k_b``) and the value read
    out of it (``@ v_b``), with ``k_b`` and ``v_b`` cast to f32, as the
    reference casts them whatever the activations' dtype."""
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope.float(), k_b.float()) * scale
    qr = q_rope.float() * scale
    ckv = c_kv.float()
    sc = q_lat @ ckv.transpose(1, 2) + qr @ k_rope.float().transpose(1, 2)
    s = c_kv.shape[1]
    mask = torch.arange(s, device=sc.device)[None, :] < valid[:, None]
    sc = sc.masked_fill(~mask[:, None, :], NEG_INF)
    o_lat = torch.softmax(sc, dim=-1) @ ckv                     # [B, H, R]
    return torch.einsum("bhr,rhd->bhd", o_lat, v_b.float())


def mla_decode(p: Dict, x: torch.Tensor, m: MLAConfig, num_heads: int,
               cache: Tuple[torch.Tensor, torch.Tensor],
               positions: torch.Tensor, theta: float) -> torch.Tensor:
    """The absorbed one-token MLA: x [B, 1, d], one layer's cache (c_kv
    [B, S, R], k_rope [B, S, Dr]), positions [B] (the new token's
    absolute position).  The new latents are written in place at slot
    ``positions % S`` (a ring when the cache is shorter than the
    sequence), then the first ``min(positions + 1, S)`` slots are read.
    Returns out [B, 1, d]; the output projection runs in ``x``'s
    dtype."""
    b = x.shape[0]
    q_nope, q_rope = _queries(p, x, m, num_heads, positions[:, None], theta)
    c_new, r_new = mla_latents(p, x, m, positions[:, None], theta)
    c_kv, k_rope = cache
    s = c_kv.shape[1]
    rows = torch.arange(b, device=x.device)
    slot = (positions % s).long()
    c_kv[rows, slot] = c_new[:, 0].to(c_kv.dtype)
    k_rope[rows, slot] = r_new[:, 0].to(k_rope.dtype)
    valid = torch.clamp(positions + 1, max=s)
    o = absorbed_attention(q_nope[:, 0], q_rope[:, 0], c_kv, k_rope,
                           p["k_b"], p["v_b"], valid, _scale(m))
    out = o.to(x.dtype).reshape(b, -1) @ p["out"].reshape(
        num_heads * m.v_head_dim, -1)
    return out[:, None]
