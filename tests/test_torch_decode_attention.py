"""Dense and paged decode attention in the PyTorch port against the JAX
reference.

On the CPU the port's wrappers run their plain PyTorch versions; these
are held, at 2e-4 in f32, against the JAX oracles (``ref.py``) and the
JAX Pallas kernels in interpret mode, on the shapes of the reference's
own kernel tests, poison cases included.  The hand-written CUDA kernels
themselves are compared with the plain versions by the ``cuda``-marked
tests, which run only where a card is present (``chip_smoke.py`` makes
the same comparison at the serving shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as jax_kernel
from repro.kernels.decode_attention import ops as jax_ops
from repro.kernels.decode_attention import ref as jax_ref
from repro_torch.kernels.decode_attention import ops, ref

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

TOL = 2e-4


def _decode_setup(bt, hq, hkv, d, lengths, seed=0):
    """Random pool + disjoint per-request tables covering ``lengths``;
    block 0 is the shared null/pad block."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    mb = max(-(-ln // bt) for ln in lengths)
    nb = sum(-(-ln // bt) for ln in lengths) + 1
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kp = rng.normal(size=(nb, bt, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(nb, bt, hkv, d)).astype(np.float32)
    tables = np.zeros((b, mb), np.int32)
    nxt = 1
    for i, ln in enumerate(lengths):
        for j in range(-(-ln // bt)):
            tables[i, j] = nxt
            nxt += 1
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _prefill_setup(bt, hq, hkv, d, s, plens, slens, seed=0):
    rng = np.random.default_rng(seed)
    b = len(plens)
    mb = max(max(-(-p // bt) for p in plens), 1)
    nb = b * mb + 1
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    ks = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    vs = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    kp = rng.normal(size=(nb, bt, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(nb, bt, hkv, d)).astype(np.float32)
    tables = np.zeros((b, mb), np.int32)
    nxt = 1
    for i, p in enumerate(plens):
        for j in range(-(-p // bt)):
            tables[i, j] = nxt
            nxt += 1
    return (q, ks, vs, kp, vp, tables, np.asarray(plens, np.int32),
            np.asarray(slens, np.int32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


DECODE_SHAPES = [(16, 4, 4, 64, (48, 17, 5)),      # non-multiples
                 (16, 4, 2, 64, (64, 33, 16)),
                 (8, 8, 1, 32, (40, 23, 9)),
                 (32, 6, 2, 64, (96, 1, 50)),
                 (16, 4, 2, 64, (15, 16, 17)),      # around a page
                 (32, 4, 1, 32, (31, 32, 33, 15))]  # bt 32

# (bt, hq, hkv, d, s, plens, slens)
PREFILL_SHAPES = [(8, 4, 2, 32, 16, (16, 8, 0), (16, 5, 12)),
                  (16, 4, 4, 64, 24, (32, 16, 16), (24, 24, 1)),
                  (8, 8, 1, 32, 8, (24, 0), (8, 3)),
                  # G = 3 packing, S * G = 120 (two 64-row tiles), prefix
                  # lengths off the 64-key tile (two prefix tiles at 130)
                  (16, 6, 2, 32, 40, (70, 0, 130), (40, 17, 33))]


@pytest.mark.parametrize("bt,hq,hkv,d,lengths", DECODE_SHAPES)
def test_paged_decode_plain_matches_jax(bt, hq, hkv, d, lengths):
    args = _decode_setup(bt, hq, hkv, d, lengths)
    out = ops.paged_decode_attention(*_t(args)).numpy()
    want_ref = np.asarray(jax_ref.paged_decode_attention_ref(*_j(args)))
    want_pallas = np.asarray(jax_kernel.paged_decode_attention_kernel(
        *_j(args), interpret=True))
    np.testing.assert_allclose(out, want_ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, want_pallas, atol=TOL, rtol=TOL)


def test_paged_decode_plain_masks_foreign_pages():
    """Poisoning (a) positions past a request's length inside its last
    block and (b) every block not in its table leaves its output alone
    (the reference's test_paged_decode_attention_masks_foreign_pages)."""
    q, kp, vp, tables, lens = _decode_setup(16, 4, 2, 32, (23, 40))
    assert tables.tolist() == [[1, 2, 0], [3, 4, 5]]
    out1 = ops.paged_decode_attention(*_t((q, kp, vp, tables, lens)))
    kp2, vp2 = kp.copy(), vp.copy()
    for a in (kp2, vp2):
        a[0] = 1e4
        a[2, 7:] = -1e4
        a[3:] = 1e4
    out2 = ops.paged_decode_attention(*_t((q, kp2, vp2, tables, lens)))
    torch.testing.assert_close(out1[0], out2[0], atol=1e-5, rtol=0)
    want = np.asarray(jax_kernel.paged_decode_attention_kernel(
        *_j((q, kp2, vp2, tables, lens)), interpret=True))
    np.testing.assert_allclose(out2[0].numpy(), want[0], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bt,hq,hkv,d,s,plens,slens", PREFILL_SHAPES)
def test_prefix_prefill_plain_matches_jax(bt, hq, hkv, d, s, plens, slens):
    args = _prefill_setup(bt, hq, hkv, d, s, plens, slens)
    out = ops.paged_prefix_prefill_attention(*_t(args)).numpy()
    want_ref = np.asarray(
        jax_ref.paged_prefix_prefill_attention_ref(*_j(args)))
    want_pallas = np.asarray(
        jax_kernel.paged_prefix_prefill_attention_kernel(*_j(args),
                                                         interpret=True))
    np.testing.assert_allclose(out, want_ref, atol=TOL, rtol=TOL)
    for i, sn in enumerate(slens):     # the Pallas kernel leaves rows past
        np.testing.assert_allclose(    # suffix_len undefined
            out[i, :sn], want_pallas[i, :sn], atol=TOL, rtol=TOL)


def test_prefix_prefill_plain_masks_foreign_pages():
    """Poisoning blocks outside a request's table and its own positions
    past prefix_len leaves its output alone (the reference's
    test_prefix_prefill_kernel_masks_foreign_pages)."""
    args = list(_prefill_setup(8, 4, 2, 32, 8, (12, 20), (8, 5)))
    assert args[5].tolist() == [[1, 2, 0], [3, 4, 5]]
    out1 = ops.paged_prefix_prefill_attention(*_t(args))
    kp2, vp2 = args[3].copy(), args[4].copy()
    for a in (kp2, vp2):
        a[0] = 1e4
        a[2, 4:] = -1e4
        a[3] = 1e4
    args2 = args[:3] + [kp2, vp2] + args[5:]
    out2 = ops.paged_prefix_prefill_attention(*_t(args2))
    torch.testing.assert_close(out1[0], out2[0], atol=1e-5, rtol=0)
    want = np.asarray(jax_kernel.paged_prefix_prefill_attention_kernel(
        *_j(args2), interpret=True))
    np.testing.assert_allclose(out2[0].numpy(), want[0], atol=TOL, rtol=TOL)


def test_paged_decode_plain_matches_dense_oracle():
    """Identity tables over a contiguous pool give the dense oracle's
    answer: paging changes layout, not math."""
    rng = np.random.default_rng(1)
    b, s, hq, hkv, d, bt = 2, 64, 4, 2, 32, 16
    q = torch.from_numpy(rng.normal(size=(b, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    lengths = torch.tensor([50, 29], dtype=torch.int32)
    tables = torch.arange(b * (s // bt), dtype=torch.int32).reshape(b, -1)
    dense = ref.decode_attention_ref(q, k, v, lengths)
    paged = ref.paged_decode_attention_ref(
        q, k.reshape(-1, bt, hkv, d), v.reshape(-1, bt, hkv, d), tables,
        lengths)
    torch.testing.assert_close(dense, paged, atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 5e-2)])
def test_cuda_kernels_match_plain_versions(dtype, tol):
    """The hand-written kernels against their plain versions on the card,
    on the reference's kernel-test shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for bt, hq, hkv, d, lengths in DECODE_SHAPES:
        args = [a.to("cuda") for a in _t(_decode_setup(bt, hq, hkv, d,
                                                      lengths))]
        args[:3] = [a.to(dtype) for a in args[:3]]
        n0 = ops.paged_decode_attention.launches
        out = ops.paged_decode_attention(*args)
        assert ops.paged_decode_attention.launches == n0 + 1
        want = ref.paged_decode_attention_ref(*args)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=0)
    for bt, hq, hkv, d, s, plens, slens in PREFILL_SHAPES:
        args = [a.to("cuda") for a in _t(_prefill_setup(bt, hq, hkv, d, s,
                                                       plens, slens))]
        args[:5] = [a.to(dtype) for a in args[:5]]
        out = ops.paged_prefix_prefill_attention(*args)
        want = ref.paged_prefix_prefill_attention_ref(*args)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=0)


# ---------------------------------------------------------------------------
# dense decode (the padded-batch path's decode_attention)
# ---------------------------------------------------------------------------

DENSE_SHAPES = [(256, 4, 4, 64), (640, 8, 2, 64), (512, 4, 1, 128)]
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-4),
          "bf16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


def _dense_setup(s, hq, hkv, d, lengths, seed=0):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    return (rng.normal(size=(b, hq, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s,hq,hkv,d", DENSE_SHAPES)
def test_dense_decode_plain_matches_jax(s, hq, hkv, d, dtype):
    """The reference's test_decode_attention shapes and lengths
    ``(s, 13, s // 2)``: the plain version against the JAX oracle and the
    JAX kernel (interpret mode, through its ops wrapper)."""
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v, lens = _dense_setup(s, hq, hkv, d, (s, 13, s // 2))
    out = ops.decode_attention(*(torch.from_numpy(a).to(tdt)
                                 for a in (q, k, v)),
                               torch.from_numpy(lens)).float().numpy()
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)] + [jnp.asarray(lens)]
    want_ref = np.asarray(jax_ref.decode_attention_ref(*jargs), np.float32)
    want_pallas = np.asarray(jax_ops.decode_attention(*jargs, block_k=128),
                             np.float32)
    np.testing.assert_allclose(out, want_ref, atol=tol, rtol=0)
    np.testing.assert_allclose(out, want_pallas, atol=tol, rtol=0)


def test_dense_decode_plain_masks_waiting_tokens():
    """Invalid (waiting / pad) cache slots never reach the output (the
    reference's test_decode_attention_masks_waiting_tokens): large values
    there leave the output as the JAX kernel gives it, and NaN there
    leaves it unchanged."""
    q, k, v, lens = (torch.from_numpy(a)
                     for a in _dense_setup(128, 2, 2, 32, (40, 64)))
    out1 = ops.decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[0, 40:], v2[0, 40:] = 1e4, -1e4
    k2[1, 64:], v2[1, 64:] = -1e4, 1e4
    out2 = ops.decode_attention(q, k2, v2, lens)
    torch.testing.assert_close(out1, out2, atol=1e-5, rtol=0)
    want = np.asarray(jax_kernel.decode_attention_kernel(
        *(jnp.asarray(t.numpy()) for t in (q, k2, v2, lens)), block_k=32,
        interpret=True))
    np.testing.assert_allclose(out2.numpy(), want, atol=TOL, rtol=TOL)
    k3, v3 = k.clone(), v.clone()
    k3[0, 40:], v3[0, 40:] = float("nan"), float("nan")
    k3[1, 64:], v3[1, 64:] = float("nan"), float("nan")
    out3 = ops.decode_attention(q, k3, v3, lens)
    torch.testing.assert_close(out1, out3, atol=1e-5, rtol=0)


def test_dense_decode_counts_plain_calls_not_launches():
    ops.reset_counts()
    q, k, v, lens = (torch.from_numpy(a)
                     for a in _dense_setup(16, 4, 2, 16, (3, 16)))
    ops.decode_attention(q, k, v, lens)
    assert ops.decode_attention.launches == 0
    assert ops.decode_attention.plain_calls == 1
    assert ops.decode_attention in ops.KERNELS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_dense_decode_kernel_matches_plain_version(dtype):
    """The hand-written dense decode kernel against its plain version on
    the card, then with NaN written past the lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt, _, tol = DTYPES[dtype]
    for s, hq, hkv, d in DENSE_SHAPES:
        q, k, v, lens = [torch.from_numpy(a).to("cuda") for a in
                         _dense_setup(s, hq, hkv, d, (s, 13, s // 2))]
        q, k, v = q.to(tdt), k.to(tdt), v.to(tdt)
        n0 = ops.decode_attention.launches
        out = ops.decode_attention(q, k, v, lens)
        assert ops.decode_attention.launches == n0 + 1
        want = ref.decode_attention_ref(q, k, v, lens)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=0)
        for i, n in enumerate(lens.tolist()):
            k[i, n:], v[i, n:] = float("nan"), float("nan")
        torch.testing.assert_close(ops.decode_attention(q, k, v, lens), out,
                                   atol=0, rtol=0)


# internvl2-26b's padded decode: 48 query heads over 8 KV heads of 128
# (G 6) on BatchEngine's _bucket(bl + bg + 256) cache (1,024 slots at bl
# 256, bg 64), the rows at 256 patches + their prompt + steps taken
INTERNVL2_DECODES = [(20, 1024, (257, 300, 512, 575, 319) * 4),
                     (1, 512, (290,))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,lens", INTERNVL2_DECODES,
                         ids=["rows20", "rows1"])
def test_cuda_dense_decode_at_internvl2_heads(b, s, lens, dtype):
    """The dense decode kernel at Hq 48 / Hkv 8, D 128 against its plain
    version (2e-4 in f32, TF32 off; 5e-2 in bf16), then with NaN
    written past the lengths, which changes nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt, _, tol = DTYPES[dtype]
    assert len(lens) == b
    q, k, v, ln = [torch.from_numpy(a).to("cuda") for a in
                   _dense_setup(s, 48, 8, 128, lens, seed=5)]
    q, k, v = q.to(tdt), k.to(tdt), v.to(tdt)
    n0 = ops.decode_attention.launches
    out = ops.decode_attention(q, k, v, ln)
    assert ops.decode_attention.launches == n0 + 1
    want = ref.decode_attention_ref(q, k, v, ln)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    for i, n in enumerate(lens):
        k[i, n:], v[i, n:] = float("nan"), float("nan")
    torch.testing.assert_close(ops.decode_attention(q, k, v, ln), out,
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the split-KV decode kernel's host side and edges
# ---------------------------------------------------------------------------

H100_SMS = 132


@pytest.mark.parametrize("b,s,hkv", [(1, 512, 32), (1, 2112, 32),
                                     (1, 512, 8), (3, 512, 32),
                                     (4, 640, 2), (1, 128, 1)])
def test_plan_splits_fills_the_card_at_small_batch(b, s, hkv):
    """At small B x Hkv the splits give every SM a block, without cutting
    the cache below MIN_SPLIT_ROWS slots a split."""
    from repro_torch.kernels.decode_attention import kernel
    splits = kernel.plan_splits(b, s, hkv, H100_SMS)
    assert 1 < splits <= kernel.MAX_SPLITS
    assert splits <= -(-s // kernel.MIN_SPLIT_ROWS)
    if -(-s // kernel.MIN_SPLIT_ROWS) * b * hkv >= H100_SMS:
        assert b * hkv * splits >= H100_SMS


@pytest.mark.parametrize("b,s,hkv", [(20, 512, 32), (16, 2112, 32),
                                     (9, 512, 32), (33, 512, 8)])
def test_plan_splits_is_one_at_large_batch(b, s, hkv):
    """B x Hkv >= 2 x SMs already fills the card: one split, no merge."""
    from repro_torch.kernels.decode_attention import kernel
    assert b * hkv >= 2 * H100_SMS
    assert kernel.plan_splits(b, s, hkv, H100_SMS) == 1


def test_decode_plan_reads_no_device_value():
    """The wrapper's host side (shape checks, split plan, output and
    scratch allocation) reads no tensor value: none is counted on CPU
    tensors, and it runs on meta tensors, which hold no values at all.
    So on the card it adds no host sync to a decode step."""
    from repro_torch.analysis.sanitizer import count_host_reads
    from repro_torch.kernels.decode_attention import kernel
    for b, hq, hkv in ((1, 32, 32), (20, 32, 32), (2, 40, 8)):
        q = torch.zeros(b, hq, 128, dtype=torch.bfloat16)
        k = torch.zeros(b, 512, hkv, 128, dtype=torch.bfloat16)
        lens = torch.full((b,), 300, dtype=torch.int32)
        with count_host_reads() as counts:
            splits, out, part_o, part_ml, counters = kernel.decode_plan(
                q, k, lens, H100_SMS)
        assert counts["reads"] == 0
        assert out.shape == q.shape and out.dtype == q.dtype
        assert splits == kernel.plan_splits(b, 512, hkv, H100_SMS)
        if splits > 1:
            assert part_o.shape == (b, hq, splits, 128)
            assert part_ml.shape == (b, hq, splits, 2)
            assert counters.dtype == torch.int32
            assert counters.numel() >= b * hkv and not counters.any()
        else:
            assert part_o is None and part_ml is None and counters is None
        meta = [t.to("meta") for t in (q, k, lens)]
        assert kernel.decode_plan(*meta, H100_SMS)[0] == splits
    with count_host_reads() as counts:         # the counter does count
        int(lens.max())
    assert counts["reads"] == 1


def test_decode_plan_refuses_other_head_sizes():
    from repro_torch.kernels.decode_attention import kernel
    q = torch.zeros(2, 4, 96)
    k = torch.zeros(2, 64, 2, 96)
    with pytest.raises(ValueError, match="head size"):
        kernel.decode_plan(q, k, torch.zeros(2, dtype=torch.int32),
                           H100_SMS)


def test_paged_decode_plan_reads_no_device_value():
    """The paged wrapper's host side reads neither the lengths nor the
    block tables (on the card either would be a host sync a decode step),
    and plans its splits from the tables' capacity, max_blocks x bt."""
    from repro_torch.analysis.sanitizer import count_host_reads
    from repro_torch.kernels.decode_attention import kernel
    for b, hq, hkv, bt, mb in ((1, 32, 32, 16, 40), (32, 32, 32, 16, 40),
                               (2, 40, 8, 8, 100), (3, 24, 2, 32, 20)):
        q = torch.zeros(b, hq, 128, dtype=torch.bfloat16)
        pages = torch.zeros(64, bt, hkv, 128, dtype=torch.bfloat16)
        tables = torch.zeros(b, mb, dtype=torch.int32)
        lens = torch.full((b,), 300, dtype=torch.int32)
        with count_host_reads() as counts:
            splits, out, part_o, part_ml, counters = \
                kernel.paged_decode_plan(q, pages, tables, lens, H100_SMS)
        assert counts["reads"] == 0
        assert out.shape == q.shape and out.dtype == q.dtype
        chunks = -(-(hq // hkv) // kernel.MAX_HEADS_PER_BLOCK)
        assert splits == kernel.plan_splits(b, mb * bt, hkv * chunks,
                                            H100_SMS)
        if splits > 1:
            assert part_o.shape == (b, hq, splits, 128)
            assert part_ml.shape == (b, hq, splits, 2)
            assert counters.numel() >= b * hkv * chunks
            assert not counters.any()
        else:
            assert part_o is None and part_ml is None and counters is None
        meta = [t.to("meta") for t in (q, pages, tables, lens)]
        assert kernel.paged_decode_plan(*meta, H100_SMS)[0] == splits


def test_paged_decode_plan_takes_a_fixed_split_count():
    """``splits`` replaces the planned count (one split: a row's
    arithmetic that does not depend on the batch, for
    ``batch_invariant``), with no scratch for one split; a count outside
    [1, MAX_SPLITS] is refused before a launch."""
    from repro_torch.kernels.decode_attention import kernel
    q = torch.zeros(1, 32, 128, dtype=torch.bfloat16)
    pages = torch.zeros(64, 16, 32, 128, dtype=torch.bfloat16)
    tables = torch.zeros(1, 40, dtype=torch.int32)
    lens = torch.full((1,), 300, dtype=torch.int32)
    assert kernel.paged_decode_plan(q, pages, tables, lens, H100_SMS)[0] > 1
    splits, _, part_o, part_ml, counters = kernel.paged_decode_plan(
        q, pages, tables, lens, H100_SMS, 1)
    assert splits == 1 and part_o is None and part_ml is None \
        and counters is None
    assert kernel.paged_decode_plan(q, pages, tables, lens, H100_SMS,
                                    3)[3].shape == (1, 32, 3, 2)
    for bad in (0, kernel.MAX_SPLITS + 1):
        with pytest.raises(ValueError, match="splits"):
            kernel.paged_decode_plan(q, pages, tables, lens, H100_SMS, bad)


def test_paged_kernels_refuse_other_head_sizes():
    """Paged decode (f32 and bf16) and bf16 prefix prefill take D in
    {32, 64, 128} and refuse any other before a launch; f32 prefix
    prefill, the scalar kernel, takes any D."""
    from repro_torch.kernels.decode_attention import kernel
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head size"):
            kernel.paged_decode_plan(
                torch.zeros(2, 4, 96, dtype=dt),
                torch.zeros(8, 16, 2, 96, dtype=dt),
                torch.zeros(2, 3, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32), H100_SMS)
    args = [torch.zeros(2, 8, 4, 96), torch.zeros(2, 8, 2, 96),
            torch.zeros(2, 8, 2, 96), torch.zeros(8, 16, 2, 96),
            torch.zeros(8, 16, 2, 96), torch.zeros(2, 1, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            torch.full((2,), 8, dtype=torch.int32)]
    bf16 = [a.to(torch.bfloat16) if a.is_floating_point() else a
            for a in args]
    with pytest.raises(ValueError, match="head size"):
        kernel.paged_prefix_prefill_attention_kernel(*bf16)
    with pytest.raises(ValueError, match="CUDA tensor"):   # past the D check
        kernel.paged_prefix_prefill_attention_kernel(*args)


# (name, s, hq, hkv, d, lengths): B = len(lengths)
SPLIT_CASES = [
    ("b1 many splits", 512, 8, 1, 128, (300,)),
    ("b1 g2", 512, 4, 2, 64, (512,)),
    ("b1 len 0", 512, 4, 4, 64, (0,)),
    ("b1 len 1", 640, 3, 1, 32, (1,)),
    ("split edges g3", 512, 6, 2, 64, (15, 16, 17, 31, 32, 33, 64, 0)),
    ("split edges g8", 256, 16, 2, 128, (1, 8, 9, 255, 256, 128)),
    ("g12 head chunks", 256, 24, 2, 64, (200, 37)),
    ("one split", 128, 132, 132, 32, (128, 1, 64)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_cuda_split_decode_edges(case, dtype):
    """The split-KV kernel (dense and int8 caches) at lengths on tile and
    split boundaries, 0, 1 and S, at B = 1 (many splits) and at
    B x Hkv >= 264 (one split), for G in {1, 2, 3, 8, 12}: against the
    plain versions, then with NaN (int8: extremes, NaN and inf scales)
    written past the lengths, which must change nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.models.transformer import _quant_i8
    torch.backends.cuda.matmul.allow_tf32 = False
    _, s, hq, hkv, d, lengths = case
    tdt, _, tol = DTYPES[dtype]
    b = len(lengths)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunks = -(-(hq // hkv) // kernel.MAX_HEADS_PER_BLOCK)
    splits = kernel.plan_splits(b, s, hkv * chunks, sms)
    assert (splits == 1) == (b * hkv * chunks >= 2 * sms)
    q, k, v, lens = [torch.from_numpy(a).to("cuda") for a in
                     _dense_setup(s, hq, hkv, d, lengths, seed=3)]
    q, k, v = q.to(tdt), k.to(tdt), v.to(tdt)
    out = ops.decode_attention(q, k, v, lens)
    want = ref.decode_attention_ref(q, k, v, lens)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    (kq, ks), (vq, vs) = _quant_i8(k.float()), _quant_i8(v.float())
    out8 = ops.decode_attention_int8(q, kq, vq, ks, vs, lens)
    want8 = ref.decode_attention_int8_ref(q, kq, vq, ks, vs, lens)
    torch.testing.assert_close(out8.float(), want8.float(), atol=tol,
                               rtol=0)
    for i, n in enumerate(lengths):
        k[i, n:], v[i, n:] = float("nan"), float("nan")
        kq[i, n:], vq[i, n:] = 127, -128
        ks[i, n:], vs[i, n:] = float("nan"), float("inf")
    torch.testing.assert_close(ops.decode_attention(q, k, v, lens), out,
                               atol=0, rtol=0)
    torch.testing.assert_close(
        ops.decode_attention_int8(q, kq, vq, ks, vs, lens), out8, atol=0,
        rtol=0)


# ---------------------------------------------------------------------------
# the paged kernels' edges on the card
# ---------------------------------------------------------------------------

# (name, bt, hq, hkv, d, lengths): B = len(lengths)
PAGED_SPLIT_CASES = [
    ("b1 splits g8 d128", 16, 8, 1, 128, (700,)),
    ("b2 splits g2 d64 bt8", 8, 4, 2, 64, (641, 900)),
    ("b1 splits mha d32 bt32", 32, 4, 4, 32, (1000,)),
    ("g12 chunks d32 bt32", 32, 24, 2, 32, (15, 16, 17, 33, 64, 1)),
    ("page edges mha d128", 16, 32, 32, 128, (15, 16, 17, 31, 32, 33)),
    ("len 0 g3 d64", 16, 6, 2, 64, (0, 5, 48)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", PAGED_SPLIT_CASES,
                         ids=[c[0] for c in PAGED_SPLIT_CASES])
def test_cuda_paged_decode_edges(case, dtype):
    """The split-KV paged decode kernel with splits > 1 (B 1-2, lengths
    640+), G > 8 in head chunks, D 32/64/128 and bt 8/16/32, against its
    plain version; then NaN in the pad page every short table points at,
    in the last page past each length and in a page no table names must
    change the output by exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.decode_attention import kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    _, bt, hq, hkv, d, lengths = case
    tdt, _, tol = DTYPES[dtype]
    q, kp, vp, tables, lens = [torch.from_numpy(a).to("cuda") for a in
                               _decode_setup(bt, hq, hkv, d, lengths,
                                             seed=4)]
    kp = torch.cat([kp, torch.zeros_like(kp[:1])])      # a page of no table
    vp = torch.cat([vp, torch.zeros_like(vp[:1])])
    q, kp, vp = q.to(tdt), kp.to(tdt), vp.to(tdt)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = kernel.paged_decode_plan(q, kp, tables, lens, sms)[0]
    if max(lengths) >= 640:
        assert splits > 1
    n0 = ops.paged_decode_attention.launches
    out = ops.paged_decode_attention(q, kp, vp, tables, lens)
    assert ops.paged_decode_attention.launches == n0 + 1
    want = ref.paged_decode_attention_ref(q, kp, vp, tables, lens)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    for pool in (kp, vp):
        pool[0] = float("nan")
        pool[-1] = float("nan")
        for i, n in enumerate(lengths):
            if n % bt:
                pool[tables[i, (n - 1) // bt], n % bt:] = float("nan")
    torch.testing.assert_close(
        ops.paged_decode_attention(q, kp, vp, tables, lens), out, atol=0,
        rtol=0)


# (name, bt, hq, hkv, d, s, plens, slens)
PREFILL_EDGE_CASES = [
    ("radix miss null table d128", 16, 4, 4, 128, 40, (0, 0, 0),
     (40, 13, 1)),
    ("g3 two row tiles d64", 16, 6, 2, 64, 40, (70, 0, 130), (40, 17, 33)),
    ("s 100 ragged d32 bt8", 8, 2, 2, 32, 100, (9, 64, 0), (100, 65, 7)),
    ("served mha d128", 16, 32, 32, 128, 8, (48, 48, 0, 49), (8, 1, 8, 7)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", PREFILL_EDGE_CASES,
                         ids=[c[0] for c in PREFILL_EDGE_CASES])
def test_cuda_prefix_prefill_edges(case, dtype):
    """Prefix prefill (bf16 on the tensor cores, f32 scalar) at a radix
    miss with a width-1 null table, ragged suffixes, S > 64 and two row
    tiles of G = 3, against its plain version; then NaN in the pad page,
    in each row's last prefix page past prefix_lens and in the suffix K/V
    past suffix_lens must change the output by exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, bt, hq, hkv, d, s, plens, slens = case
    tdt, _, tol = DTYPES[dtype]
    args = [torch.from_numpy(a).to("cuda") for a in
            _prefill_setup(bt, hq, hkv, d, s, plens, slens, seed=5)]
    args[:5] = [a.to(tdt) for a in args[:5]]
    n0 = ops.paged_prefix_prefill_attention.launches
    out = ops.paged_prefix_prefill_attention(*args)
    assert ops.paged_prefix_prefill_attention.launches == n0 + 1
    want = ref.paged_prefix_prefill_attention_ref(*args)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    _, ks, vs, kp, vp, tables, _, _ = args
    for pool in (kp, vp):
        pool[0] = float("nan")
        for i, p in enumerate(plens):
            if p % bt:
                pool[tables[i, (p - 1) // bt], p % bt:] = float("nan")
    for x in (ks, vs):
        for i, n in enumerate(slens):
            x[i, n:] = float("nan")
    torch.testing.assert_close(ops.paged_prefix_prefill_attention(*args),
                               out, atol=0, rtol=0)
