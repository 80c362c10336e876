"""Device-keyed decode (float or int8 cache) and paged attention: the
hand-written CUDA kernel for CUDA tensors, the plain PyTorch version for
CPU tensors, and nothing else.

There is no fallback: a CUDA tensor launches the kernel or raises, and a
tensor on any other device raises.  Each wrapper counts its kernel
launches in ``.launches`` (and its plain-version calls in
``.plain_calls``), plain ints a run can reset and read to show that its
main path went through the kernel."""
from __future__ import annotations

import torch

from repro_torch.analysis.sanitizer import hot_path
from repro_torch.kernels import device_route
from repro_torch.kernels.decode_attention import kernel, ref


@hot_path
def decode_attention(q, k_cache, v_cache, lengths):
    """q: [B, Hq, D]; caches: [B, S, Hkv, D]; lengths: [B] valid slots per
    row (slots at or past it are never read) -> [B, Hq, D]."""
    if device_route(q) == "cpu":
        decode_attention.plain_calls += 1
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths)
    out = kernel.decode_attention_kernel(
        q.contiguous(), k_cache, v_cache,
        lengths.to(torch.int32).contiguous())
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.plain_calls = 0


@hot_path
def decode_attention_int8(q, k_cache, v_cache, k_scale, v_scale, lengths):
    """q: [B, Hq, D]; caches: int8 [B, S, Hkv, D]; scales: [B, S, Hkv]
    (bf16); lengths: [B] valid slots per row (slots and scales at or past
    it are never read) -> [B, Hq, D]."""
    if device_route(q) == "cpu":
        decode_attention_int8.plain_calls += 1
        return ref.decode_attention_int8_ref(q, k_cache, v_cache, k_scale,
                                             v_scale, lengths)
    out = kernel.decode_attention_int8_kernel(
        q.contiguous(), k_cache, v_cache, k_scale, v_scale,
        lengths.to(torch.int32).contiguous())
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
decode_attention_int8.plain_calls = 0


@hot_path
def decode_attention_partial(q, k_cache, v_cache, lengths):
    """The context-parallel shard's partial: q [B, Hq, D]; caches [B, S,
    Hkv, D] (a rank's shard); lengths [B] valid slots of the shard ->
    (o [B, Hq, D] unnormalised, m [B, Hq] in natural log, l [B, Hq]),
    all f32 (``ref.decode_attention_partial_ref``)."""
    if device_route(q) == "cpu":
        decode_attention_partial.plain_calls += 1
        return ref.decode_attention_partial_ref(q, k_cache, v_cache, lengths)
    out = kernel.decode_attention_partial_kernel(
        q.contiguous(), k_cache, v_cache,
        lengths.to(torch.int32).contiguous())
    decode_attention_partial.launches += 1
    return out


decode_attention_partial.launches = 0
decode_attention_partial.plain_calls = 0


@hot_path
def decode_attention_int8_partial(q, k_cache, v_cache, k_scale, v_scale,
                                  lengths):
    """:func:`decode_attention_partial` on an int8 shard with bf16
    scales [B, S, Hkv]."""
    if device_route(q) == "cpu":
        decode_attention_int8_partial.plain_calls += 1
        return ref.decode_attention_int8_partial_ref(
            q, k_cache, v_cache, k_scale, v_scale, lengths)
    out = kernel.decode_attention_int8_partial_kernel(
        q.contiguous(), k_cache, v_cache, k_scale, v_scale,
        lengths.to(torch.int32).contiguous())
    decode_attention_int8_partial.launches += 1
    return out


decode_attention_int8_partial.launches = 0
decode_attention_int8_partial.plain_calls = 0


@hot_path
def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           splits=None):
    """q: [B, Hq, D]; pages: [num_blocks, bt, Hkv, D]; block_tables:
    [B, max_blocks] (pad entries must be valid ids for the plain version,
    which gathers them; the kernel never reads an entry or a page past
    ``lengths``); lengths: [B] -> [B, Hq, D].  ``splits`` fixes the
    kernel's split count (else planned from the shapes); the plain
    version has none."""
    if device_route(q) == "cpu":
        paged_decode_attention.plain_calls += 1
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, lengths)
    out = kernel.paged_decode_attention_kernel(
        q.contiguous(), k_pages, v_pages,
        block_tables.to(torch.int32).contiguous(),
        lengths.to(torch.int32).contiguous(), splits=splits)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.plain_calls = 0


@hot_path
def paged_prefix_prefill_attention(q, k_suf, v_suf, k_pages, v_pages,
                                   block_tables, prefix_lens, suffix_lens):
    """Suffix-prefill attention against cached prefix pages; per-row
    ``prefix_lens`` may be 0 (a radix miss), and a wave with no cached
    prefix passes a width-1 null ``block_tables``.  q, k_suf, v_suf:
    [B, S, H*, D] -> [B, S, Hq, D]."""
    if device_route(q) == "cpu":
        paged_prefix_prefill_attention.plain_calls += 1
        return ref.paged_prefix_prefill_attention_ref(
            q, k_suf, v_suf, k_pages, v_pages, block_tables, prefix_lens,
            suffix_lens)
    out = kernel.paged_prefix_prefill_attention_kernel(
        q.contiguous(), k_suf.contiguous(), v_suf.contiguous(), k_pages,
        v_pages, block_tables.to(torch.int32).contiguous(),
        prefix_lens.to(torch.int32).contiguous(),
        suffix_lens.to(torch.int32).contiguous())
    paged_prefix_prefill_attention.launches += 1
    return out


paged_prefix_prefill_attention.launches = 0
paged_prefix_prefill_attention.plain_calls = 0

KERNELS = (decode_attention, decode_attention_int8, paged_decode_attention,
           paged_prefix_prefill_attention, decode_attention_partial,
           decode_attention_int8_partial)


def reset_counts() -> None:
    """Zero every wrapper's launch and plain-version counts."""
    for fn in KERNELS:
        fn.launches = 0
        fn.plain_calls = 0
