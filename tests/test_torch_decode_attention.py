"""Paged attention in the PyTorch port against the JAX reference.

On the CPU the port's wrappers run their plain PyTorch versions; these
are held, at 2e-4 in f32, against the JAX oracles (``ref.py``) and the
JAX Pallas kernels in interpret mode, on the shapes of the reference's
own kernel tests, poison cases included.  The hand-written CUDA kernels
themselves are compared with the plain versions by the ``cuda``-marked
test, which runs only where a card is present (``chip_smoke.py`` makes
the same comparison at the serving shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as jax_kernel
from repro.kernels.decode_attention import ref as jax_ref
from repro_torch.kernels.decode_attention import ops, ref

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
                 (32, 6, 2, 64, (96, 1, 50))]

PREFILL_SHAPES = [(8, 4, 2, 32, 16, (16, 8, 0), (16, 5, 12)),
                  (16, 4, 4, 64, 24, (32, 16, 16), (24, 24, 1)),
                  (8, 8, 1, 32, 8, (24, 0), (8, 3))]


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
