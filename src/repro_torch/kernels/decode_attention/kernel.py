"""Hand-written Hopper kernels for decode and paged attention, launched
through ctypes (sources: ``repro_torch/csrc/decode_split.cuh``, the
split-KV decode kernel, included by ``decode_attention.cu`` for the dense
and int8 caches and by ``paged_decode_attention.cu`` for the page pool;
``repro_torch/csrc/paged_prefix_prefill_attention.cu``).

Each replaces the TPU kernel of the same name in
``src/repro/kernels/decode_attention/kernel.py``:
``decode_attention_kernel`` (body ``_kernel``),
``decode_attention_int8_kernel`` (body ``_kernel_i8``),
``paged_decode_attention_kernel`` (body ``_paged_kernel``) and
``paged_prefix_prefill_attention_kernel`` (body
``_prefix_prefill_kernel``).  The dense decode kernel's partial mode
(:func:`decode_attention_partial_kernel` and its int8 form) is the
context-parallel decode's shard, which the reference computes in plain
``jnp`` (no TPU kernel).  All four are bound by the bytes they read:
each block walks only the cache rows or pages its row's length covers, so
the bytes follow the real context, not the cache or table width (the
sources say more).

The three decode kernels are one split-KV streaming kernel
(flash-decoding), templated on where a token's row lives (a contiguous
cache, or a page named by the block table): :func:`plan_splits` cuts the
KV axis into enough splits, from shapes alone, that B x Hkv x splits
blocks fill the card; each split finds its slice of ``[0, lengths[b])``
on the device, and when there is more than one, the last split block of
each (row, KV head) to finish merges the splits' f32 partials (an atomic
counter per pair, left at zero by every launch, says which block is
last).  The host never reads ``lengths`` or a block table (device
tensors: reading one would be a host sync on the hot path).  The split
counters of eager launches are one buffer per device: launches that
follow one another on a stream share it, and it is replaced by a larger
one (the old one freed) when a launch needs more.  So launches that can
run at once (two streams), or that a CUDA graph has captured, must not
share a buffer that may be freed: a capture takes a buffer of its own
from :func:`private_split_counters` and keeps it alive with the graph.
Head sizes 32, 64 and 128.

Prefix prefill in bf16 runs on the tensor cores (wgmma over 64-key K/V
tiles gathered through the block table; head sizes 32, 64 and 128); in
f32 it is a scalar kernel that keeps true f32 products.  The route is the
dtype's, never a fallback.

These functions take CUDA tensors only; they validate device, dtype,
shape and contiguity, allocate the output (and the split scratch),
launch on the current stream and raise if the launch is refused.  They
do not synchronise.  ``ops.py`` picks between them and the plain
versions in ``ref.py``."""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator, List, Optional, Tuple

import torch

from repro_torch.kernels import check_cuda, dtype_code, raise_on
from repro_torch.kernels.build import load_library

DECODE_HEAD_SIZES = (32, 64, 128)   # the split kernel's D template values
#                                     (and the bf16 prefix prefill's)
MAX_HEADS_PER_BLOCK = 8             # query heads one block keeps (G > 8:
#                                     chunks of 8 across the grid)
MIN_SPLIT_ROWS = 32                 # fewer cache rows a split is not worth
MAX_SPLITS = 64


def plan_splits(b: int, s: int, hkv: int, sms: int) -> int:
    """Splits of the KV axis for a decode launch of ``b`` rows, ``s``
    cache slots and ``hkv`` blocks per row (KV heads times head chunks),
    on a card of ``sms`` SMs: one when ``b * hkv`` already gives two
    blocks per SM, else enough for two per SM, at most one per
    ``MIN_SPLIT_ROWS`` slots.  Shapes only: never the lengths."""
    blocks = b * hkv
    if blocks >= 2 * sms:
        return 1
    want = -(-2 * sms // blocks)
    return max(1, min(want, -(-s // MIN_SPLIT_ROWS), MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS = {}   # device -> int32 zeros; every launch leaves them zero
_PRIVATE: List[torch.Tensor] = []   # innermost private_split_counters


@contextlib.contextmanager
def private_split_counters(device: torch.device, n: int
                           ) -> Iterator[torch.Tensor]:
    """Inside the block, every decode launch takes its split counters
    from one buffer of its own, at least ``n`` zeroed int32 counters on
    ``device``, allocated here (before any capture begins, so that its
    zeros are real) and never replaced: a launch that needs more raises.
    A CUDA graph captured inside the block keeps the yielded buffer
    alive as long as the graph lives."""
    buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    _PRIVATE.append(buf)
    try:
        yield buf
    finally:
        _PRIVATE.pop()


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 split counters on ``device``: the
    private buffer of the enclosing :func:`private_split_counters`, else
    the device's shared buffer, kept for the process (the kernel resets
    each counter it uses, so launches that follow one another on a
    stream share them)."""
    if _PRIVATE:
        buf = _PRIVATE[-1]
        if buf.device != device or buf.numel() < n:
            raise ValueError(
                f"the private split counters ({buf.numel()} on "
                f"{buf.device}) do not cover a launch that needs {n} on "
                f"{device}")
        return buf
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _split_plan(q, slots: int, hkv: int, sms: int,
                splits: Optional[int] = None, output: bool = True
                ) -> Tuple[int, Optional[torch.Tensor],
                           Optional[torch.Tensor], Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    b, hq, d = q.shape
    if d not in DECODE_HEAD_SIZES:
        raise ValueError(f"decode head size {d} not in "
                         f"{DECODE_HEAD_SIZES}")
    chunks = -(-(hq // hkv) // MAX_HEADS_PER_BLOCK)
    if splits is None:
        splits = plan_splits(b, slots, hkv * chunks, sms)
    elif not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits {splits} not in [1, {MAX_SPLITS}]")
    out = torch.empty_like(q) if output else None
    if splits == 1:
        return splits, out, None, None, None
    part_o = torch.empty((b, hq, splits, d), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((b, hq, splits, 2), dtype=torch.float32,
                          device=q.device)
    return (splits, out, part_o, part_ml,
            _split_counters(q.device, b * hkv * chunks))


def decode_plan(q, k_cache, lengths, sms: int, output: bool = True
                ) -> Tuple[int, Optional[torch.Tensor],
                           Optional[torch.Tensor], Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    """The host side of a dense decode launch, on any device: check the
    shapes and head size, choose the splits and allocate the output
    (None with ``output=False``: the partial mode writes its own f32
    outputs) and the split scratch (f32 partial outputs [B, Hq, splits,
    D], (max, sum) pairs [B, Hq, splits, 2] and the zeroed split
    counters; None for one split).  Reads no tensor's values."""
    b, hq, d = q.shape
    _, s, hkv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or hq % hkv \
            or lengths.shape != (b,):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, cache "
            f"{tuple(k_cache.shape)}, lengths {tuple(lengths.shape)}")
    return _split_plan(q, s, hkv, sms, output=output)


def paged_decode_plan(q, k_pages, block_tables, lengths, sms: int,
                      splits: Optional[int] = None
                      ) -> Tuple[int, torch.Tensor, Optional[torch.Tensor],
                                 Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """As :func:`decode_plan`, for a page pool [num_blocks, bt, Hkv, D]
    and block tables [B, max_blocks]: a request has max_blocks * bt
    slots; ``splits``, when given, replaces the planned count.  Reads no
    tensor's values (neither the tables nor the lengths)."""
    b, hq, d = q.shape
    _, bt, hkv, dk = k_pages.shape
    if dk != d or hq % hkv or block_tables.dim() != 2 \
            or block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}, tables {tuple(block_tables.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    return _split_plan(q, block_tables.shape[1] * bt, hkv, sms, splits)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_dense(q, k_cache, v_cache, lengths) -> int:
    """Validate a dense decode launch's tensors; returns q's dtype code."""
    code = dtype_code(q)
    check_cuda("q", q, dim=3)
    check_cuda("k_cache", k_cache, dtype=q.dtype, dim=4)
    check_cuda("v_cache", v_cache, dtype=q.dtype, dim=4)
    check_cuda("lengths", lengths, dtype=torch.int32, dim=1)
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"shape mismatch: caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)}")
    return code


def _check_int8(q, k_cache, v_cache, k_scale, v_scale, lengths) -> int:
    """Validate an int8-cache decode launch's tensors; returns q's dtype
    code."""
    code = dtype_code(q)
    check_cuda("q", q, dim=3)
    check_cuda("k_cache", k_cache, dtype=torch.int8, dim=4)
    check_cuda("v_cache", v_cache, dtype=torch.int8, dim=4)
    check_cuda("k_scale", k_scale, dtype=torch.bfloat16, dim=3)
    check_cuda("v_scale", v_scale, dtype=torch.bfloat16, dim=3)
    check_cuda("lengths", lengths, dtype=torch.int32, dim=1)
    if (v_cache.shape != k_cache.shape
            or k_scale.shape != k_cache.shape[:3]
            or v_scale.shape != k_scale.shape):
        raise ValueError(
            f"shape mismatch: caches {tuple(k_cache.shape)}/"
            f"{tuple(v_cache.shape)}, scales {tuple(k_scale.shape)}/"
            f"{tuple(v_scale.shape)}")
    return code


def decode_attention_kernel(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """q: [B, Hq, D]; caches: [B, S, Hkv, D] (one layer of the model's
    cache, a contiguous slice); lengths: [B] int32 -> [B, Hq, D]."""
    code = _check_dense(q, k_cache, v_cache, lengths)
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    splits, out, part_o, part_ml, counters = decode_plan(
        q, k_cache, lengths, _sm_count(q.device.index))
    with torch.cuda.device(q.device):
        rc = load_library().repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, s, hq, hkv, d, code,
            torch.cuda.current_stream(q.device).cuda_stream, splits,
            _ptr(part_o), _ptr(part_ml), _ptr(counters))
    raise_on(rc, "decode_attention")
    return out


def decode_attention_int8_kernel(q, k_cache, v_cache, k_scale, v_scale,
                                 lengths) -> torch.Tensor:
    """q: [B, Hq, D] (f32 or bf16); caches: int8 [B, S, Hkv, D]; scales:
    bf16 [B, S, Hkv] (slices of the model's int8 cache); lengths: [B]
    int32 -> [B, Hq, D] in q's dtype."""
    code = _check_int8(q, k_cache, v_cache, k_scale, v_scale, lengths)
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    splits, out, part_o, part_ml, counters = decode_plan(
        q, k_cache, lengths, _sm_count(q.device.index))
    with torch.cuda.device(q.device):
        rc = load_library().repro_decode_attention_int8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, s, hq, hkv, d, code,
            torch.cuda.current_stream(q.device).cuda_stream, splits,
            _ptr(part_o), _ptr(part_ml), _ptr(counters))
    raise_on(rc, "decode_attention_int8")
    return out


def _partial_outputs(q) -> Tuple[torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """The partial mode's f32 outputs: o [B, Hq, D], m and l [B, Hq]."""
    b, hq, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((b, hq, d), **f32), torch.empty((b, hq), **f32),
            torch.empty((b, hq), **f32))


def decode_attention_partial_kernel(q, k_cache, v_cache, lengths
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """The context-parallel shard's partial: q [B, Hq, D]; caches [B, S,
    Hkv, D] (this rank's shard); lengths [B] int32 (valid slots of the
    shard) -> (o f32 [B, Hq, D] unnormalised, m f32 [B, Hq] the scores'
    max in natural log (-inf with no valid slot), l f32 [B, Hq] the sum
    of exp(score - m))."""
    code = _check_dense(q, k_cache, v_cache, lengths)
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    splits, _, part_o, part_ml, counters = decode_plan(
        q, k_cache, lengths, _sm_count(q.device.index), output=False)
    o, m, l = _partial_outputs(q)
    with torch.cuda.device(q.device):
        rc = load_library().repro_decode_attention_partial(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(), b,
            s, hq, hkv, d, code,
            torch.cuda.current_stream(q.device).cuda_stream, splits,
            _ptr(part_o), _ptr(part_ml), _ptr(counters))
    raise_on(rc, "decode_attention_partial")
    return o, m, l


def decode_attention_int8_partial_kernel(q, k_cache, v_cache, k_scale,
                                         v_scale, lengths
                                         ) -> Tuple[torch.Tensor,
                                                    torch.Tensor,
                                                    torch.Tensor]:
    """:func:`decode_attention_partial_kernel` on an int8 shard: caches
    int8 [B, S, Hkv, D], scales bf16 [B, S, Hkv]."""
    code = _check_int8(q, k_cache, v_cache, k_scale, v_scale, lengths)
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    splits, _, part_o, part_ml, counters = decode_plan(
        q, k_cache, lengths, _sm_count(q.device.index), output=False)
    o, m, l = _partial_outputs(q)
    with torch.cuda.device(q.device):
        rc = load_library().repro_decode_attention_int8_partial(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), b, s, hq, hkv, d,
            code, torch.cuda.current_stream(q.device).cuda_stream, splits,
            _ptr(part_o), _ptr(part_ml), _ptr(counters))
    raise_on(rc, "decode_attention_int8_partial")
    return o, m, l


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(16-byte cp.async loads)")


def paged_decode_attention_kernel(q, k_pages, v_pages, block_tables,
                                  lengths, *, splits: Optional[int] = None
                                  ) -> torch.Tensor:
    """q: [B, Hq, D]; pages: [num_blocks, bt, Hkv, D]; block_tables:
    [B, max_blocks] int32; lengths: [B] int32 -> [B, Hq, D].  ``splits``:
    the KV axis's split count, planned from the shapes when None (one
    split gives a row the same arithmetic whatever the batch)."""
    code = dtype_code(q)
    check_cuda("q", q, dim=3)
    check_cuda("k_pages", k_pages, dtype=q.dtype, dim=4)
    check_cuda("v_pages", v_pages, dtype=q.dtype, dim=4)
    check_cuda("block_tables", block_tables, dtype=torch.int32, dim=2)
    check_cuda("lengths", lengths, dtype=torch.int32, dim=1)
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"shape mismatch: pages {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}")
    _check_aligned(k_pages=k_pages, v_pages=v_pages)
    b, hq, d = q.shape
    _, bt, hkv, _ = k_pages.shape
    splits, out, part_o, part_ml, counters = paged_decode_plan(
        q, k_pages, block_tables, lengths, _sm_count(q.device.index),
        splits)
    with torch.cuda.device(q.device):
        rc = load_library().repro_paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, hq, hkv, d, bt, block_tables.shape[1], code,
            torch.cuda.current_stream(q.device).cuda_stream, splits,
            _ptr(part_o), _ptr(part_ml), _ptr(counters))
    raise_on(rc, "paged_decode_attention")
    return out


def paged_prefix_prefill_attention_kernel(q, k_suf, v_suf, k_pages, v_pages,
                                          block_tables, prefix_lens,
                                          suffix_lens) -> torch.Tensor:
    """q: [B, S, Hq, D]; k_suf, v_suf: [B, S, Hkv, D]; pages:
    [num_blocks, bt, Hkv, D]; block_tables: [B, M] int32; prefix_lens,
    suffix_lens: [B] int32 -> [B, S, Hq, D]."""
    code = dtype_code(q)
    if q.dtype == torch.bfloat16 and q.shape[-1] not in DECODE_HEAD_SIZES:
        raise ValueError(f"bf16 prefix prefill head size {q.shape[-1]} not "
                         f"in {DECODE_HEAD_SIZES}")
    check_cuda("q", q, dim=4)
    check_cuda("k_suf", k_suf, dtype=q.dtype, dim=4)
    check_cuda("v_suf", v_suf, dtype=q.dtype, dim=4)
    check_cuda("k_pages", k_pages, dtype=q.dtype, dim=4)
    check_cuda("v_pages", v_pages, dtype=q.dtype, dim=4)
    check_cuda("block_tables", block_tables, dtype=torch.int32, dim=2)
    check_cuda("prefix_lens", prefix_lens, dtype=torch.int32, dim=1)
    check_cuda("suffix_lens", suffix_lens, dtype=torch.int32, dim=1)
    b, s, hq, d = q.shape
    _, bt, hkv, dk = k_pages.shape
    if (k_suf.shape != (b, s, hkv, d) or v_suf.shape != k_suf.shape
            or v_pages.shape != k_pages.shape or dk != d or hq % hkv
            or block_tables.shape[0] != b or prefix_lens.shape[0] != b
            or suffix_lens.shape[0] != b):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k_suf "
            f"{tuple(k_suf.shape)}, pages {tuple(k_pages.shape)}, tables "
            f"{tuple(block_tables.shape)}")
    if q.dtype == torch.bfloat16:
        _check_aligned(q=q, k_suf=k_suf, v_suf=v_suf, k_pages=k_pages,
                       v_pages=v_pages)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = load_library().repro_paged_prefix_prefill_attention(
            q.data_ptr(), k_suf.data_ptr(), v_suf.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            prefix_lens.data_ptr(), suffix_lens.data_ptr(), out.data_ptr(),
            b, s, hq, hkv, d, bt, block_tables.shape[1], code,
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(rc, "paged_prefix_prefill_attention")
    return out
