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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_kernel as jax_kernel
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ref
from repro.models.ssm import ssd_chunked as jax_chunked
from repro_torch.kernels.ssd_scan import kernel, ops, ref

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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_versions():
    """The hand-written scan against both plain versions on the card, on
    the reference's shapes, a ragged S and S below the chunk: against
    the chunked one at 2e-4 of the output's scale (f32; the cumulative
    log-decay and the dot products are summed in another order), against
    the recurrence at the reference's 5e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for s, h, p, n, chunk in SHAPES + [(8, 4, 32, 16, 32)]:
        args = [torch.from_numpy(a).cuda() for a in _inputs(2, s, h, p, n)]
        n0 = ops.ssd_scan.launches
        y, st = ops.ssd_scan(*args, chunk)
        assert ops.ssd_scan.launches == n0 + 1
        for (wy, ws), tol in ((ref.ssd_chunked_ref(*args, chunk), None),
                              (ref.ssd_scan_ref(*args), ORACLE_TOL)):
            for got, want in ((y, wy), (st, ws)):
                lim = tol or CHUNKED_TOL * max(1.0, want.abs().max().item())
                assert (got - want).abs().max().item() < lim
