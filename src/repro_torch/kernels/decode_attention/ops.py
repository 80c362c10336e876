"""Device-keyed decode (float or int8 cache) and paged attention: the
hand-written CUDA kernel for CUDA tensors, the plain PyTorch version for
CPU tensors, and nothing else.

There is no fallback: a CUDA tensor launches the kernel or raises, and a
tensor on any other device raises (a ``meta`` tensor, which holds no
data, gets the op's output shapes: the dry run).  Each launch is one
registered op, ``repro_torch::<wrapper name>``
(:func:`repro_torch.kernels.register_op`), whose CUDA implementation
counts the launch in the wrapper's ``.launches`` (the wrapper counts its
plain-version calls in ``.plain_calls``), plain ints a run can reset and
read to show that its main path went through the kernel.

Each op's flop formula counts the two products of the reference's plain
decode over every slot of the cache or the block table (``src/repro/
models/attention.py`` ``gqa_decode_attention``, ``src/repro/kernels/
decode_attention/ref.py``): 4 B Hq S D, whatever the lengths."""
from __future__ import annotations

import torch

from repro_torch.analysis.sanitizer import hot_path
from repro_torch.kernels import device_route, register_op
from repro_torch.kernels.decode_attention import kernel, ref


def _decode_flops(q, k, *_, **__) -> int:
    """q [B, Hq, D] against [B, S, Hkv, D]: QK^T and PV over all S."""
    b, hq, d = q
    return 4 * b * hq * k[1] * d


def _paged_flops(q, k_pages, v_pages, tables, *_, **__) -> int:
    """As :func:`_decode_flops` over the tables' M x bt slots."""
    b, hq, d = q
    return 4 * b * hq * tables[1] * k_pages[1] * d


def _prefix_flops(q, k_suf, v_suf, k_pages, v_pages, tables, *_,
                  **__) -> int:
    """Each of S suffix queries against the M x bt prefix slots and the
    S suffix keys (the reference's concatenated view)."""
    b, s, hq, d = q
    return 4 * b * s * hq * (tables[1] * k_pages[1] + s) * d


def _like_q(q, *_, **__) -> torch.Tensor:
    return torch.empty_like(q)


def _partial_fake(q, *_, **__):
    b, hq, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (q.new_empty((b, hq, d), **f32), q.new_empty((b, hq), **f32),
            q.new_empty((b, hq), **f32))


@hot_path
def _dense_cuda(q, k_cache, v_cache, lengths):
    out = kernel.decode_attention_kernel(q, k_cache, v_cache, lengths)
    decode_attention.launches += 1
    return out


@hot_path
def _int8_cuda(q, k_cache, v_cache, k_scale, v_scale, lengths):
    out = kernel.decode_attention_int8_kernel(q, k_cache, v_cache, k_scale,
                                              v_scale, lengths)
    decode_attention_int8.launches += 1
    return out


@hot_path
def _partial_cuda(q, k_cache, v_cache, lengths):
    out = kernel.decode_attention_partial_kernel(q, k_cache, v_cache,
                                                 lengths)
    decode_attention_partial.launches += 1
    return out


@hot_path
def _int8_partial_cuda(q, k_cache, v_cache, k_scale, v_scale, lengths):
    out = kernel.decode_attention_int8_partial_kernel(
        q, k_cache, v_cache, k_scale, v_scale, lengths)
    decode_attention_int8_partial.launches += 1
    return out


@hot_path
def _paged_cuda(q, k_pages, v_pages, block_tables, lengths, splits=None):
    out = kernel.paged_decode_attention_kernel(
        q, k_pages, v_pages, block_tables, lengths, splits=splits)
    paged_decode_attention.launches += 1
    return out


@hot_path
def _prefix_cuda(q, k_suf, v_suf, k_pages, v_pages, block_tables,
                 prefix_lens, suffix_lens):
    out = kernel.paged_prefix_prefill_attention_kernel(
        q, k_suf, v_suf, k_pages, v_pages, block_tables, prefix_lens,
        suffix_lens)
    paged_prefix_prefill_attention.launches += 1
    return out


_DENSE = "(Tensor q, Tensor k_cache, Tensor v_cache, Tensor lengths)"
_INT8 = ("(Tensor q, Tensor k_cache, Tensor v_cache, Tensor k_scale, "
         "Tensor v_scale, Tensor lengths)")
_PARTIAL = " -> (Tensor, Tensor, Tensor)"
_DECODE_OP = register_op("decode_attention", _DENSE + " -> Tensor",
                         _dense_cuda, _like_q, _decode_flops).default
_INT8_OP = register_op("decode_attention_int8", _INT8 + " -> Tensor",
                       _int8_cuda, _like_q, _decode_flops).default
_PARTIAL_OP = register_op("decode_attention_partial", _DENSE + _PARTIAL,
                          _partial_cuda, _partial_fake,
                          _decode_flops).default
_INT8_PARTIAL_OP = register_op("decode_attention_int8_partial",
                               _INT8 + _PARTIAL, _int8_partial_cuda,
                               _partial_fake, _decode_flops).default
_PAGED_OP = register_op(
    "paged_decode_attention",
    "(Tensor q, Tensor k_pages, Tensor v_pages, Tensor block_tables, "
    "Tensor lengths, int? splits=None) -> Tensor",
    _paged_cuda, _like_q, _paged_flops).default
_PREFIX_OP = register_op(
    "paged_prefix_prefill_attention",
    "(Tensor q, Tensor k_suf, Tensor v_suf, Tensor k_pages, "
    "Tensor v_pages, Tensor block_tables, Tensor prefix_lens, "
    "Tensor suffix_lens) -> Tensor",
    _prefix_cuda, _like_q, _prefix_flops).default


@hot_path
def decode_attention(q, k_cache, v_cache, lengths):
    """q: [B, Hq, D]; caches: [B, S, Hkv, D]; lengths: [B] valid slots per
    row (slots at or past it are never read) -> [B, Hq, D]."""
    if device_route(q) == "cpu":
        decode_attention.plain_calls += 1
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths)
    return _DECODE_OP(q.contiguous(), k_cache, v_cache,
                      lengths.to(torch.int32).contiguous())


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
    return _INT8_OP(q.contiguous(), k_cache, v_cache, k_scale, v_scale,
                    lengths.to(torch.int32).contiguous())


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
    return _PARTIAL_OP(q.contiguous(), k_cache, v_cache,
                       lengths.to(torch.int32).contiguous())


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
    return _INT8_PARTIAL_OP(q.contiguous(), k_cache, v_cache, k_scale,
                            v_scale, lengths.to(torch.int32).contiguous())


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
    return _PAGED_OP(q.contiguous(), k_pages, v_pages,
                     block_tables.to(torch.int32).contiguous(),
                     lengths.to(torch.int32).contiguous(), splits)


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
    return _PREFIX_OP(q.contiguous(), k_suf.contiguous(),
                      v_suf.contiguous(), k_pages, v_pages,
                      block_tables.to(torch.int32).contiguous(),
                      prefix_lens.to(torch.int32).contiguous(),
                      suffix_lens.to(torch.int32).contiguous())


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
