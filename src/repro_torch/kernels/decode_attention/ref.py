"""Plain PyTorch versions of the dense (float or int8 cache) and paged
decode attention kernels:
a port of the reference package's oracles
(``src/repro/kernels/decode_attention/ref.py``).  They are the CPU path
of ``ops.py`` and the yardstick every kernel is held against."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, Hq, D]; caches: [B, S, Hkv, D]; lengths: [B] -> [B, Hq, D].

    Slots at or past ``lengths[b]`` are masked out of the scores and
    their values zeroed, so garbage there (NaN included) never reaches
    the output, as in the kernel."""
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d) * d ** -0.5
    sc = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    vf = torch.where(valid[:, :, None, None], v_cache.float(),
                     torch.zeros((), device=q.device))
    o = torch.einsum("bhgk,bkhd->bhgd", p, vf)
    return o.reshape(b, hq, d).to(q.dtype)


def decode_attention_int8_ref(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """The int8-cache variant: caches int8 [B, S, Hkv, D], scales [B, S,
    Hkv] (bf16 in the model's cache).  Dequantised in f32 (value * scale,
    as the TPU kernel does), then :func:`decode_attention_ref`'s
    arithmetic, masked values zeroed."""
    k = k_cache.float() * k_scale.float()[..., None]
    v = v_cache.float() * v_scale.float()[..., None]
    return decode_attention_ref(q, k, v, lengths)


def decode_attention_partial_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 lengths: torch.Tensor):
    """One shard's online-softmax partial, the reference's ``local``
    body of ``gqa_decode_attention_cp`` before its merge: q [B, Hq, D];
    caches [B, S, Hkv, D]; lengths [B] valid slots of the shard ->
    (o f32 [B, Hq, D] = sum_k exp(s_k - m) v_k, m f32 [B, Hq] = max_k
    s_k in natural log, l f32 [B, Hq] = sum_k exp(s_k - m)).  A row
    with no valid slot gives m = -inf, l = 0, o = 0 (no NaN); masked
    slots' values are zeroed, as in :func:`decode_attention_ref`."""
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d) * d ** -0.5
    sc = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]
    sc = torch.where(valid, sc, torch.full_like(sc, float("-inf")))
    m = sc.amax(dim=-1)
    p = torch.where(valid, torch.exp(sc - m[..., None]),
                    torch.zeros((), device=q.device))
    vf = torch.where(valid[:, 0, 0, :, None, None], v_cache.float(),
                     torch.zeros((), device=q.device))
    o = torch.einsum("bhgk,bkhd->bhgd", p, vf)
    return o.reshape(b, hq, d), m.reshape(b, hq), p.sum(-1).reshape(b, hq)


def decode_attention_int8_partial_ref(q, k_cache, v_cache, k_scale,
                                      v_scale, lengths):
    """:func:`decode_attention_partial_ref` on an int8 shard, dequantised
    in f32 as :func:`decode_attention_int8_ref` does."""
    k = k_cache.float() * k_scale.float()[..., None]
    v = v_cache.float() * v_scale.float()[..., None]
    return decode_attention_partial_ref(q, k, v, lengths)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Gather pages [num_blocks, bt, Hkv, D] through ``block_tables``
    [B, max_blocks] into a dense [B, max_blocks * bt, Hkv, D] view and
    run the dense oracle; positions past ``lengths`` (whole pad-table
    pages included) are masked."""
    b, hq, d = q.shape
    hkv = k_pages.shape[2]
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, -1, hkv, d)
    v = v_pages[tables].reshape(b, -1, hkv, d)
    return decode_attention_ref(q, k, v, lengths)


def paged_prefix_prefill_attention_ref(
        q: torch.Tensor, k_suf: torch.Tensor, v_suf: torch.Tensor,
        k_pages: torch.Tensor, v_pages: torch.Tensor,
        block_tables: torch.Tensor, prefix_lens: torch.Tensor,
        suffix_lens: torch.Tensor) -> torch.Tensor:
    """Suffix prefill against cached prefix pages.

    q, k_suf, v_suf: [B, S, H*, D], the suffix tokens already rope'd at
    ``prefix_lens[b] + i``; ``block_tables`` [B, M] gathers the prefix
    pages into a dense view of capacity P = M * bt.  Query i attends key
    j iff ``j < prefix_lens[b]`` (prefix part) or ``j - P <= i`` and
    ``j - P < suffix_lens[b]`` (suffix part).  Returns [B, S, Hq, D]."""
    b, s, hq, d = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    dev = q.device
    tables = block_tables.long()
    kp = k_pages[tables].reshape(b, -1, hkv, d)
    vp = v_pages[tables].reshape(b, -1, hkv, d)
    p_cap = kp.shape[1]
    k_cat = torch.cat([kp, k_suf], dim=1).float()
    v_cat = torch.cat([vp, v_suf], dim=1).float()
    q_idx = torch.arange(s, device=dev)
    kv_idx = torch.arange(p_cap + s, device=dev)
    in_prefix = kv_idx < p_cap
    prefix_ok = kv_idx[None, :] < prefix_lens[:, None]              # [B, K]
    suffix_ok = ((kv_idx[None, None, :] - p_cap <= q_idx[None, :, None])
                 & (kv_idx[None, :] - p_cap
                    < suffix_lens[:, None])[:, None, :])            # [B, S, K]
    mask = torch.where(in_prefix[None, None, :], prefix_ok[:, None, :],
                       suffix_ok)                                   # [B, S, K]
    qf = (q.float() * d ** -0.5).reshape(b, s, hkv, g, d)
    sc = torch.einsum("bqhgd,bkhd->bqhgk", qf, k_cat)
    sc = torch.where(mask[:, :, None, None, :], sc,
                     torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v_cat)
    return o.reshape(b, s, hq, d).to(q.dtype)
