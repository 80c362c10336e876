"""The Mamba2 SSD scan in the PyTorch port against the JAX reference.

On the CPU the port's ``ops.ssd_scan`` runs the plain chunked version
(``ssd_chunked_ref``, a copy of the reference model's ``ssd_chunked``);
the naive recurrence ``ssd_scan_ref`` is the independent oracle.  Both
are held against the JAX oracle and the JAX Pallas kernel in interpret
mode at the reference's 5e-3 (``test_kernels.py::test_ssd_scan``, on its
three shapes, and a ragged S = 200), and the chunked version against JAX
``ssd_chunked`` at 2e-4, absolute and relative (f32, the same algorithm;
outputs reach ~100, so the relative part carries the large values).  The
hand-written CUDA kernel is compared with the plain versions by the
``cuda``-marked test, which runs only where a card is present
(``chip_smoke.py`` makes the same comparison at mamba2-780m's shapes).
The kernel computes its products on the tensor cores in 3xTF32; a CPU
emulation of that split at mamba2-780m's widths records why: 3xTF32
meets the chunked tolerance, one tf32 product does not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_kernel as jax_kernel
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ref
from repro.models.ssm import ssd_chunked as jax_chunked
from repro_torch.kernels.ssd_scan import kernel, ops, ref

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

ORACLE_TOL = 5e-3      # the reference's test_ssd_scan
CHUNKED_TOL = 2e-4     # f32, same algorithm

# test_kernels.py::test_ssd_scan's shapes (S, H, P, N, chunk), then a
# ragged S that no power-of-two chunk divides
SHAPES = [(128, 2, 32, 16, 32), (256, 3, 32, 16, 64), (192, 2, 64, 32, 64),
          (200, 3, 32, 16, 64)]


def _inputs(b, s, h, p, n, seed=0):
    """x, b, c unit normal; dt = softplus(normal) > 0; a = -exp(normal)
    < 0: the reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = (-np.exp(rng.normal(size=(h,)))).astype(np.float32)
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a, bb, cc


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("s,h,p,n,chunk", SHAPES)
def test_plain_scans_match_jax_oracle_and_kernel(s, h, p, n, chunk):
    args = _inputs(2, s, h, p, n)
    targs = [torch.from_numpy(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    want = [jax_ref(*jargs), jax_kernel(*jargs, chunk=chunk, interpret=True)]
    got = [ref.ssd_scan_ref(*targs), ref.ssd_chunked_ref(*targs, chunk),
           ops.ssd_scan(*targs, chunk)]
    for gy, gs in got:
        assert gy.shape == (2, s, h, p) and gs.shape == (2, h, p, n)
        for wy, ws in want:
            assert _max_err(gy, wy) < ORACLE_TOL
            assert _max_err(gs, ws) < ORACLE_TOL


@pytest.mark.parametrize("s,h,p,n,chunk", SHAPES)
def test_chunked_plain_matches_jax_ssd_chunked(s, h, p, n, chunk):
    """The CPU route runs the reference model's own algorithm, so the
    SSM model compares like with like."""
    args = _inputs(2, s, h, p, n, seed=1)
    y, st = ref.ssd_chunked_ref(*(torch.from_numpy(a) for a in args), chunk)
    wy, ws = jax_chunked(*(jnp.asarray(a) for a in args), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=CHUNKED_TOL,
                               rtol=CHUNKED_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(ws), atol=CHUNKED_TOL,
                               rtol=CHUNKED_TOL)


def test_chunked_plain_with_chunk_longer_than_sequence():
    """A prompt bucket shorter than the chunk (S 8, chunk 32, as the
    reduced mamba2 meets it): one chunk of S rows."""
    args = [torch.from_numpy(a) for a in _inputs(3, 8, 4, 32, 16, seed=2)]
    y, st = ref.ssd_chunked_ref(*args, 32)
    wy, ws = ref.ssd_scan_ref(*args)
    assert _max_err(y, wy) < ORACLE_TOL and _max_err(st, ws) < ORACLE_TOL


def test_wrapper_counts_plain_calls_not_launches_on_the_cpu():
    ops.reset_counts()
    args = [torch.from_numpy(a) for a in _inputs(1, 16, 2, 32, 16)]
    ops.ssd_scan(*args, 8)
    assert (ops.ssd_scan.launches, ops.ssd_scan.plain_calls) == (0, 1)
    assert ops.ssd_scan in ops.KERNELS


def test_kernel_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(1, 16, 2, 32, 16)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.ssd_scan_kernel(*args, chunk=8)


def _tf32(t):
    """Round f32 to tf32 (10-bit mantissa) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 does: add half of the dropped 13 bits' unit
    to the magnitude and clear them."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b with tf32 operands: one product (``passes`` 1), or 3xTF32
    (``passes`` 3) as the kernel sums it, lo.hi + hi.lo + hi.hi in f32."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _chunked_tf32(x, dt, a, b, c, chunk, passes):
    """The kernel's chunked algorithm with every product's operands in
    tf32 (``passes`` 1 or 3): G = C.B^T per (row, chunk), y = exp(cum)
    (C.state^T) + (G o decay o dt) . X and state = exp(tot) state +
    (X o dt exp(tot - cum))^T . B per head.  S must be a multiple of
    ``chunk``."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(bsz, nc, chunk, h).permute(0, 1, 3, 2)  # [B,Nc,H,L]
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)
    cum = torch.cumsum(dtc * a[:, None], dim=-1)
    tot = cum[..., -1:]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    diff = cum[..., :, None] - cum[..., None, :]
    decay = torch.exp(torch.where(mask, diff, torch.full_like(diff, -1e30)))
    g = _mm_tf32(cc, bc.transpose(-1, -2), passes)        # [B,Nc,L,L]
    w = g[:, :, None] * decay * dtc[..., None, :]         # [B,Nc,H,L,L]
    y_intra = _mm_tf32(w, xc, passes)                     # [B,Nc,H,L,P]
    xdt = xc * (dtc * torch.exp(tot - cum))[..., None]
    state = torch.zeros((bsz, h, p, n))
    ys = []
    for z in range(nc):
        inter = _mm_tf32(cc[:, z, None], state.transpose(-1, -2), passes)
        ys.append(y_intra[:, z] + inter * torch.exp(cum[:, z])[..., None])
        state = (state * torch.exp(tot[:, z])[..., None]
                 + _mm_tf32(xdt[:, z].transpose(-1, -2), bc[:, z, None],
                            passes))
    y = torch.stack(ys, 1).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    return y, state


@pytest.mark.parametrize("passes,meets", [(3, True), (1, False)])
def test_tf32_split_precision_at_mamba2_widths(passes, meets):
    """Why the kernel splits every operand: at mamba2-780m's widths (H 48,
    P 64, N 128, chunk 128; B 1, S 256) the chunked algorithm with 3xTF32
    products stays within CHUNKED_TOL of the output's scale of the f32
    chunked version, and with one tf32 product does not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [torch.from_numpy(a) for a in _inputs(1, 256, 48, 64, 128,
                                                 seed=3)]
    want = ref.ssd_chunked_ref(*args, 128)
    got = _chunked_tf32(*args, 128, passes)
    scale = max(w.abs().max().item() for w in want)
    err = max(_max_err(g, w) for g, w in zip(got, want))
    assert (err < CHUNKED_TOL * scale) == meets, (err, scale)


def test_widths_the_tensor_core_tiles_take():
    """Every config's widths (P 64, N 128, chunk 128), the reduced
    model's (P 32, N 16, chunk 32) and the test shapes are taken; wider
    ones raise before any launch."""
    for p, n, s, chunk in [(64, 128, 256, 128), (32, 16, 8, 32),
                           (64, 32, 192, 64), (64, 128, 1, 128),
                           (48, 100, 300, 50), (64, 128, 64, 4096)]:
        assert kernel.check_widths(p, n, s, chunk) == min(chunk, s)
    for p, n, s, chunk in [(128, 128, 256, 128), (64, 256, 256, 128),
                           (64, 128, 256, 256), (64, 128, 0, 128),
                           (64, 128, 256, 0)]:
        with pytest.raises(ValueError):
            kernel.check_widths(p, n, s, chunk)
    assert kernel.scratch_shape(20, 256, 128) == (20, 2, 128, 128)
    assert kernel.scratch_shape(2, 200, 128) == (2, 2, 128, 128)
    assert kernel.scratch_shape(3, 8, 32) == (3, 1, 16, 16)


def test_p_tile_splits_p_only_where_blocks_are_few():
    """On 132 SMs mamba2-780m's 48 heads take 32-wide P slices at B 1
    (96 blocks) and 64-wide from B 2; P 32 is one slice."""
    assert [kernel.p_tile_for(b, 48, 64, 132) for b in (1, 2, 3, 4, 20)
            ] == [32, 64, 64, 64, 64]
    assert kernel.p_tile_for(20, 48, 32, 132) == 32


# the cuda test's shapes (B, S, H, P, N, chunk, p_tile): the reference's,
# S below the chunk, then mamba2-780m's widths at B 1 and 8 with S 256,
# 200 and 1, each P tile, and P slices with a ragged edge (P 48, 40)
CUDA_SHAPES = ([(2,) + sh + (None,) for sh in SHAPES + [(8, 4, 32, 16, 32)]]
               + [(b, s, 48, 64, 128, 128, pt) for b in (1, 8)
                  for s in (256, 200, 1) for pt in (32, 64)]
               + [(2, 200, 3, 48, 128, 128, 32), (2, 72, 2, 40, 24, 64, 32),
                  (1, 40, 2, 33, 18, 16, 64)])


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_versions():
    """The hand-written scan against both plain versions on the card, on
    the reference's shapes, a ragged S, S below the chunk, mamba2-780m's
    widths and ragged P slices: against the chunked one at 2e-4 of the
    output's scale (3xTF32 on the tensor cores; the cumulative
    log-decay and the dot products are summed in another order), against
    the recurrence at the reference's 5e-3.  The C.B^T scratch is held
    against c @ b^T on its lower triangle at 2e-4 of its scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for bsz, s, h, p, n, chunk, pt in CUDA_SHAPES:
        args = [torch.from_numpy(a).cuda()
                for a in _inputs(bsz, s, h, p, n)]
        n0 = ops.ssd_scan.launches
        y, st = ops.ssd_scan(*args, chunk)
        assert ops.ssd_scan.launches == n0 + 1
        scratch = torch.full(kernel.scratch_shape(bsz, s, chunk),
                             float("nan"), device="cuda")
        ky, kst = kernel.ssd_scan_kernel(*args, chunk=chunk, p_tile=pt,
                                         scratch=scratch)
        for (wy, ws), tol in ((ref.ssd_chunked_ref(*args, chunk), None),
                              (ref.ssd_scan_ref(*args), ORACLE_TOL)):
            for got, want in ((y, wy), (st, ws), (ky, wy), (kst, ws)):
                lim = tol or CHUNKED_TOL * max(1.0, want.abs().max().item())
                assert (got - want).abs().max().item() < lim, (bsz, s, p)
        c = min(chunk, s)
        bb, cc = args[3], args[4]
        for z in range(-(-s // c)):
            m = min(c, s - z * c)
            rows = slice(z * c, z * c + m)
            want = torch.tril(cc[:, rows] @ bb[:, rows].transpose(1, 2))
            got = torch.tril(scratch[:, z, :m, :m])
            lim = CHUNKED_TOL * max(1.0, want.abs().max().item())
            assert (got - want).abs().max().item() < lim, (bsz, s, z)


# hymba-1.5b's SSM heads (H 25, P 64, N 16, chunk 128), which the wrapper
# runs on the N <= 32 instance: (B, S), S a multiple of the chunk, ragged,
# and the 4,096-token prompt (32 chunks)
HYMBA_SCANS = [(2, 256), (3, 200), (2, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("p_tile", kernel.P_TILES)
@pytest.mark.parametrize("bsz,s", HYMBA_SCANS)
def test_cuda_scan_at_hymba_widths(bsz, s, p_tile):
    """The scan at H 25, P 64, N 16, chunk 128 against the chunked plain
    version at 2e-4 of the output's scale, at both P slices, and against
    the recurrence at the reference's 5e-3 where S is short; through the
    wrapper too, which counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [torch.from_numpy(a).cuda()
            for a in _inputs(bsz, s, 25, 64, 16, seed=5)]
    n0 = ops.ssd_scan.launches
    outs = [ops.ssd_scan(*args, 128),
            kernel.ssd_scan_kernel(*args, chunk=128, p_tile=p_tile)]
    assert ops.ssd_scan.launches == n0 + 1
    wants = [(ref.ssd_chunked_ref(*args, 128), None)]
    if s <= 256:
        wants.append((ref.ssd_scan_ref(*args), ORACLE_TOL))
    for (wy, ws), tol in wants:
        for y, st in outs:
            for got, want in ((y, wy), (st, ws)):
                assert torch.isfinite(got).all()
                lim = tol or CHUNKED_TOL * max(1.0, want.abs().max().item())
                assert (got - want).abs().max().item() < lim, (bsz, s)
