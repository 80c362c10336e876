"""GQA attention of the dense serving path (the reference package's
``models/attention.py``): prefill over a right-padded prompt batch and
one-token decode against a dense, possibly ring-buffered, KV cache.

The reference computes both contractions in jnp and keeps its Pallas
kernels beside them; here both route to the hand-written kernels through
their ops (the CUDA kernel on the card, the plain version on the CPU).
The context-parallel decode, :func:`gqa_decode_attention_cp`, runs each
rank's sequence shard through the decode kernel's partial mode and
merges the partials with ``torch.distributed`` collectives."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.analysis.sanitizer import count_sync, hot_path
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_int8_partial,
    decode_attention_partial)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.partitioning import mesh_shape


def gqa_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D], with
    query i at position i.  Keys at or past ``kv_len`` are masked (the
    encoder's pad frames, the cross attention's pad rows).  A causal or
    window mask needs Sq == Sk; full mode (cross attention) takes any
    Sk, as the reference's signature does (without its ``q_offset``,
    which no caller passes)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           kv_len=kv_len)


def gqa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, 1, Hq, D]; caches: [B, S, Hkv, D]; lengths: [B] valid cache
    entries per request (the padded batch's waiting slots beyond it are
    masked, and never read by the kernel) -> [B, 1, Hq, D].  A wrapped
    ring buffer is valid in full (``lengths == S``)."""
    return decode_attention(q[:, 0], k_cache, v_cache, lengths)[:, None]


def batch_spec(mesh, b: int, batch_axes=("data",)):
    """The reference's ``bspec``: the mesh axes of ``batch_axes`` (a name
    or a tuple of names; those the mesh has) over which a batch of
    ``b`` rows is sharded, where their product divides ``b``; else None
    (every rank holds every row).  The one decision of which rows a
    rank holds: :func:`batch_block` and ``model.shard_cache`` read it."""
    names = (batch_axes,) if isinstance(batch_axes, str) \
        else tuple(batch_axes or ())
    dims = mesh_shape(mesh)
    axes = tuple(a for a in names if a in dims)
    if axes and b % math.prod(dims[a] for a in axes) == 0:
        return axes
    return None


def batch_block(mesh, b: int, batch_axes=("data",)):
    """(first row, rows) of this rank's block of a batch of ``b`` rows
    under :func:`batch_spec`: row-major over its axes, as
    ``partitioning.shard_local`` cuts a dimension."""
    axes = batch_spec(mesh, b, batch_axes)
    if axes is None:
        return 0, b
    dims = mesh_shape(mesh)
    n, idx = 1, 0
    for a in axes:
        idx = idx * dims[a] + mesh.get_local_rank(a)
        n *= dims[a]
    return idx * (b // n), b // n


@hot_path
def gqa_decode_attention_cp(q: torch.Tensor, k_shard: torch.Tensor,
                            v_shard: torch.Tensor, lengths: torch.Tensor,
                            *, mesh, batch_axes=("data",),
                            seq_axis: str = "model",
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Context-parallel flash-decode (the reference's ``shard_map`` form,
    ``src/repro/models/attention.py:83``), by hand on a
    :class:`~repro_torch.launch.mesh.Mesh`.

    q: [B, 1, Hq, D] and lengths: [B] (valid cache entries, global), the
    same on every rank; k_shard, v_shard: this rank's block of the
    [B, S, Hkv, D] cache (``partitioning.shard_local``), global rows
    ``[r * S/n, (r + 1) * S/n)`` of the ``n`` ranks along ``seq_axis``,
    and this rank's rows of the batch where the batch is sharded
    (:func:`batch_block`); with ``k_scale``/``v_scale`` ([B, S/n, Hkv]
    bf16 blocks) the shard is an int8 cache.  Returns [B, 1, Hq, D] in
    q's dtype, every row, on every rank.

    The shard's valid count is ``clamp(lengths - r * S/n, 0, S/n)``;
    the decode kernel's partial mode (the plain version on the CPU)
    gives the shard's f32 max (natural log), sum of exponentials and
    unnormalised output, an empty shard m = -inf, l = 0, o = 0.  They
    merge over the ``seq_axis`` group with one all-reduce MAX and two
    all-reduce SUMs, the reference's ``pmax`` and two ``psum``s; a
    batch sharded over the data axes is then summed back into every
    row over their group (each rank contributes its rows, zeros
    elsewhere).  On a gloo group, a collective on CUDA tensors stages
    them through the host and blocks it: three host syncs a call (one
    more a data axis with a sharded batch) that the reference's
    on-device ``psum`` does not make, each counted at this function's
    site in the sanitizer's ledger."""
    b, _, hq, d = q.shape
    r = mesh.get_local_rank(seq_axis)
    local_s = k_shard.shape[1]
    b0, bl = batch_block(mesh, b, batch_axes)
    if k_shard.shape[0] != bl:
        raise ValueError(f"the shard holds {k_shard.shape[0]} rows; this "
                         f"rank's block of the batch is {bl}")
    ql = q[b0:b0 + bl, 0]
    valid = torch.clamp(lengths[b0:b0 + bl] - r * local_s, 0, local_s)
    if k_scale is None:
        o, m, l = decode_attention_partial(ql, k_shard, v_shard, valid)
    else:
        o, m, l = decode_attention_int8_partial(ql, k_shard, v_shard,
                                                k_scale, v_scale, valid)
    group = mesh.get_group(seq_axis)
    # on a gloo group each all_reduce of CUDA tensors stages them through
    # the host and blocks it: counted here, each, in the sanitizer's
    # ledger (not in an engine's host_syncs); the lint has no rule for
    # collectives
    staged = q.is_cuda and dist.get_backend(group) == "gloo"
    m_all = m.clone()
    dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
    if staged:
        count_sync()  # hotlint: sync(uncounted: gloo's host-staged MAX)
    # an empty shard (m = -inf) weighs 0, also where every shard is empty
    corr = torch.where(m == float("-inf"), torch.zeros_like(m),
                       torch.exp(m - m_all))
    l_all = l * corr
    dist.all_reduce(l_all, group=group)
    if staged:
        count_sync()  # hotlint: sync(uncounted: gloo's host-staged SUM)
    o_all = o * corr[..., None]
    dist.all_reduce(o_all, group=group)
    if staged:
        count_sync()  # hotlint: sync(uncounted: gloo's host-staged SUM)
    out = (o_all / torch.clamp(l_all[..., None], min=1e-30)).to(q.dtype)
    if bl != b:
        full = out.new_zeros((b, hq, d))
        full[b0:b0 + bl] = out
        for axis in batch_spec(mesh, b, batch_axes):
            dist.all_reduce(full, group=mesh.get_group(axis))
            if staged:
                count_sync()  # hotlint: sync(uncounted: gloo's SUM)
        out = full
    return out[:, None]
