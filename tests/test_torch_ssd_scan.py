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
meets the chunked tolerance, one tf32 product does not.  The same holds
for the backward kernel's algorithm at mamba2-780m's and hymba-1.5b's
widths, emulated with its products in tf32 (``_bwd_tf32``).

The gradient: ``ssd_scan_bwd_ref`` (the backward kernel's formulas,
written out chunk by chunk) against autograd of ``ssd_chunked_ref`` and
``jax.vjp`` of the reference's ``ssd_chunked`` at 2e-4 of each output's
largest magnitude, on shapes that span several chunks (S 256 with chunk
128, a ragged S 200 with chunk 64), S below the chunk, mamba2-780m's and
hymba-1.5b's widths, with the final state's gradient dropped and given;
on the CPU a call that needs a gradient runs the plain scan under
autograd.  On the card (``cuda``-marked) the backward kernel against
the plain version at both models' widths, a ragged S and several
chunks, two launches bit-equal, the forward's stored chunk states, the
autograd wrapper launching the forward and the backward once each, and
widths the kernel does not take raising before any launch.
"""
import jax
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
    dy = torch.zeros_like(args[0])
    states = torch.zeros(kernel.states_shape(1, 16, 2, 32, 16, 8))
    cb = torch.zeros(kernel.scratch_shape(1, 16, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.ssd_scan_bwd_kernel(*args, dy, states, cb, chunk=8)


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

# (B, S, H, P, N, chunk): S 256 over two chunks of 128, a ragged S 200
# over chunks of 64, S below the chunk, mamba2-780m's widths (P 64, N
# 128) and hymba-1.5b's (P 64, N 16) over two chunks of 128
BWD_SHAPES = [(2, 256, 3, 32, 16, 128), (2, 200, 3, 32, 16, 64),
              (2, 40, 2, 32, 16, 64), (1, 256, 4, 64, 128, 128),
              (2, 256, 5, 64, 16, 128)]
BWD_NAMES = ("dx", "ddt", "da", "db", "dc")


def _bwd_inputs(b, s, h, p, n, seed=0):
    """The scan's inputs, then dy and a final-state gradient, unit
    normal."""
    rng = np.random.default_rng(seed + 100)
    return (_inputs(b, s, h, p, n, seed),
            rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.normal(size=(b, h, p, n)).astype(np.float32))


def _held(got, want, tol=CHUNKED_TOL):
    """Each output's largest error over that output's largest magnitude,
    all within ``tol``."""
    for name, g, w in zip(BWD_NAMES, got, want):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = max(np.abs(w).max(), 1e-30)
        assert _max_err(g, w) <= tol * scale, (name, _max_err(g, w), scale)


@pytest.mark.parametrize("given", [False, True], ids=["dropped", "dstate"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", BWD_SHAPES)
def test_bwd_ref_matches_autograd_and_jax_vjp(b, s, h, p, n, chunk, given):
    """``ssd_scan_bwd_ref`` against torch autograd of ``ssd_chunked_ref``
    (which cuts the chunk until it divides S: 50 at S 200) and against
    ``jax.vjp`` of the reference's ``ssd_chunked`` on the same numpy
    inputs, each output at 2e-4 of its largest magnitude."""
    args, dy, ds = _bwd_inputs(b, s, h, p, n)
    targs = [torch.from_numpy(a) for a in args]
    tdy, tds = torch.from_numpy(dy), torch.from_numpy(ds)
    got = ref.ssd_scan_bwd_ref(*targs, tdy, tds if given else None, chunk)
    leaves = [t.clone().requires_grad_() for t in targs]
    y, st = ref.ssd_chunked_ref(*leaves, chunk)
    want = torch.autograd.grad((y, st), leaves,
                               (tdy, tds if given else torch.zeros_like(st)))
    _held(got, want)
    _, vjp = jax.vjp(lambda *a: jax_chunked(*a, chunk),
                     *(jnp.asarray(a) for a in args))
    jwant = vjp((jnp.asarray(dy),
                 jnp.asarray(ds if given else np.zeros_like(ds))))
    _held(got, jwant)


def test_cpu_gradient_runs_the_plain_scan_under_autograd():
    """A CPU call whose inputs need a gradient: one plain call, no launch
    of either kernel, and autograd's gradient equals the plain
    backward's."""
    ops.reset_counts()
    args, dy, _ = _bwd_inputs(1, 48, 2, 32, 16)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, _ = ops.ssd_scan(*leaves, 16)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    assert (ops.ssd_scan.plain_calls, ops.ssd_scan.launches,
            ops.ssd_scan_bwd.launches) == (1, 0, 0)
    assert ops.ssd_scan_bwd in ops.KERNELS
    want = ref.ssd_scan_bwd_ref(*(t.detach() for t in leaves),
                                torch.from_numpy(dy), None, 16)
    _held(got, want)


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


def _bwd_tf32(x, dt, a, b, c, dy, chunk, passes):
    """The backward kernel's algorithm with every product's operands in
    tf32 (``passes`` 1 or 3), the final state's gradient dropped: per
    chunk, walked in reverse, the incoming state's gradient dS_in =
    exp(tot) dS + (exp(cum) o DY)^T . C; per head dx = u o (B . dS^T) +
    (dt o (G o L))^T . DY with du = rowsum(X o B . dS^T), dW^T = X . DY^T
    on the triangle, dy . S_in c = rowsum(DY o C . S_in^T); db = sum_h
    (u o X_h) . dS_h + (sum_h dG_h)^T . C and dc = sum_h (exp(cum) o
    DY_h) . S_in_h + (sum_h dG_h) . B, the heads' dG summed before its
    two products.  G = C.B^T in 3xTF32 (the forward's scratch).  S must
    be a multiple of ``chunk``; returns (dx, ddt, da, db, dc)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    mm = lambda u, v: _mm_tf32(u, v, passes)
    xc = x.reshape(bsz, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    yc = dy.reshape(bsz, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(bsz, nc, chunk, h).permute(0, 1, 3, 2)  # [B,Nc,H,L]
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)
    cum = torch.cumsum(dtc * a[:, None], dim=-1)
    tot = cum[..., -1:]
    ecum, dec = torch.exp(cum), torch.exp(tot - cum)
    u = dec * dtc
    upper = torch.triu(torch.ones((chunk, chunk), dtype=torch.bool))
    diff = cum[..., None, :] - cum[..., :, None]          # [j, i]: i - j
    lt = torch.exp(torch.where(upper, diff, torch.full_like(diff, -1e30)))
    gt = _mm_tf32(cc, bc.transpose(-1, -2), 3).transpose(-1, -2)  # G^T
    # the forward's incoming states, in f32
    states = [torch.zeros((bsz, h, p, n))]
    for z in range(nc - 1):
        upd = torch.einsum("bhl,bhlp,bln->bhpn", u[:, z], xc[:, z], bc[:, z])
        states.append(states[-1] * torch.exp(tot[:, z])[..., None] + upd)
    dxs, ddts, dbs, dcs, das = [], [], [], [], []
    d_s = torch.zeros((bsz, h, p, n))
    for z in reversed(range(nc)):
        xz, yz, dtz, bz, cz = xc[:, z], yc[:, z], dtc[:, z], bc[:, z], cc[:, z]
        s_in = states[z]
        v = mm(bz[:, None], d_s.transpose(-1, -2))          # [B,H,L,P]
        du = (xz * v).sum(-1)
        dwt = mm(xz, yz.transpose(-1, -2)) * upper          # [B,H,j,i]
        w_t = gt[:, z, None] * lt[:, z] * dtz[..., :, None]
        dx = u[:, z, ..., None] * v + mm(w_t, yz)
        r_t = dwt * gt[:, z, None] * lt[:, z]
        dgs = (dwt * lt[:, z] * dtz[..., :, None]).sum(1)   # [B,j,i]
        yy = mm(cz[:, None], s_in.transpose(-1, -2))
        dyy = (yz * yy).sum(-1)
        dtot = (torch.exp(tot[:, z, :, 0]) * (d_s * s_in).sum((-1, -2))
                + (du * u[:, z]).sum(-1))
        dcum = (ecum[:, z] * dyy - du * u[:, z]
                + (r_t * dtz[..., None]).sum(-2) - dtz * r_t.sum(-1))
        dcum[..., -1] += dtot
        ds = torch.flip(torch.cumsum(torch.flip(dcum.double(), [-1]), -1),
                        [-1])
        ddts.append(du * dec[:, z] + r_t.sum(-1) + a[:, None] * ds.float())
        das.append((ds * dtz.double()).sum((0, 2)))
        dxs.append(dx)
        flat = lambda t: t.permute(0, 2, 1, 3).reshape(bsz, chunk, h * p)
        dbs.append(mm(flat(u[:, z, ..., None] * xz),
                      d_s.reshape(bsz, h * p, n)) + mm(dgs, cz))
        dcs.append(mm(flat(ecum[:, z, ..., None] * yz),
                      s_in.reshape(bsz, h * p, n))
                   + mm(dgs.transpose(-1, -2), bz))
        d_s = (d_s * torch.exp(tot[:, z])[..., None]
               + mm((ecum[:, z, ..., None] * yz).transpose(-1, -2),
                    cz[:, None]))
    order = lambda ts: torch.stack(ts[::-1], 1)
    dx = order(dxs).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    ddt = order(ddts).permute(0, 1, 3, 2).reshape(bsz, s, h)
    da = torch.stack(das).sum(0).float()
    return (dx, ddt, da, order(dbs).reshape(bsz, s, n),
            order(dcs).reshape(bsz, s, n))


def _bwd_held(got, args, dy):
    """Whether each output meets the backward kernel's hold (as
    :func:`_hold_bwd`: 2e-4 of its largest magnitude of the plain f32
    version, or no farther from the f64 run than the plain f32 version
    is), the final state's gradient dropped; {output: held}."""
    want = ref.ssd_scan_bwd_ref(*args, dy, None, 128)
    exact = ref.ssd_scan_bwd_ref(*(t.double() for t in args), dy.double(),
                                 None, 128)
    out = {}
    for name, g, w, e in zip(BWD_NAMES, got, want, exact):
        scale = max(w.abs().max().item(), 1e-30)
        out[name] = ((g - w).abs().max().item() <= CHUNKED_TOL * scale
                     or ((g.double() - e).abs().max().item()
                         <= (w.double() - e).abs().max().item()))
    return out


@pytest.mark.parametrize("passes,meets", [(3, True), (1, False)])
@pytest.mark.parametrize("h,n", [(48, 128), (25, 16)],
                         ids=["mamba2-780m", "hymba-1.5b"])
def test_bwd_tf32_split_precision_at_training_widths(h, n, passes, meets):
    """Why the backward kernel splits every operand: at mamba2-780m's
    (H 48, P 64, N 128) and hymba-1.5b's (H 25, N 16) widths, B 1, S 256,
    chunk 128, the kernel's algorithm with 3xTF32 products meets the
    hold of every output (:func:`_bwd_held`), and with one tf32 product
    does not (each of the five outputs misses it at both widths)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args, dy, _ = _bwd_inputs(1, 256, h, 64, n, seed=4)
    args = [torch.from_numpy(t) for t in args]
    dy = torch.from_numpy(dy)
    held = _bwd_held(_bwd_tf32(*args, dy, 128, passes), args, dy)
    assert all(held.values()) == meets, held


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


def test_head_group_keeps_the_chunk_kernel_to_one_block_an_sm():
    """On 132 SMs the backward's chunk kernel takes 6 of mamba2-780m's 48
    heads a block at the training call (B 8, two chunks: 128 blocks) and
    4 of hymba-1.5b's 25 (112); one head where rows and chunks alone
    fill fewer SMs, all of them where they fill more; each group size
    leaves at most one block an SM, and one head fewer would not; the
    scratch has one dG partial a group."""
    assert kernel.head_group_for(8, 2, 48, 132) == 6
    assert kernel.head_group_for(8, 2, 25, 132) == 4
    assert kernel.head_group_for(2, 4, 3, 132) == 1
    assert kernel.head_group_for(70, 2, 48, 132) == 48
    for bsz, nc, h in [(8, 2, 48), (8, 2, 25), (2, 2, 48), (3, 2, 25),
                       (1, 1, 2), (20, 2, 48), (2, 32, 25)]:
        grp = kernel.head_group_for(bsz, nc, h, 132)
        assert 1 <= grp <= h
        assert bsz * nc * -(-h // grp) <= 132
        if grp > 1:
            assert bsz * nc * -(-h // (grp - 1)) > 132
    shapes = kernel.bwd_scratch_shapes(8, 256, 48, 64, 128, 128, 6)
    assert shapes == [(8, 2, 48, 64, 128), (8, 2, 8, 128, 128),
                      (8, 256, 48), (8, 256, 48), (8, 2, 48)]


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


# the backward's card shapes (B, S, H, P, N, chunk): mamba2-780m's widths
# over two chunks and ragged, hymba-1.5b's heads and widths, several
# chunks of 64 with a ragged S, S below the chunk, and ragged P and N
CUDA_BWD_SHAPES = [(2, 256, 4, 64, 128, 128), (2, 200, 3, 64, 128, 128),
                   (2, 256, 25, 64, 16, 128), (3, 200, 25, 64, 16, 128),
                   (2, 200, 3, 32, 16, 64), (2, 40, 2, 32, 16, 64),
                   (1, 40, 2, 33, 18, 16)]


def _hold_bwd(got, args, dy, dstate, chunk):
    """The backward kernel's hold: each output within 2e-4 of its largest
    magnitude of the plain version in f32, or, where the plain f32
    version itself lies that far from its f64 run (da sums long runs of
    both signs), no farther from the f64 run than the plain f32 version
    is."""
    want = ref.ssd_scan_bwd_ref(*args, dy, dstate, chunk)
    exact = ref.ssd_scan_bwd_ref(*(t.double() for t in args), dy.double(),
                                 None if dstate is None else dstate.double(),
                                 chunk)
    for name, g, w, e in zip(BWD_NAMES, got, want, exact):
        assert torch.isfinite(g).all(), name
        scale = max(w.abs().max().item(), 1e-30)
        err = (g - w).abs().max().item()
        if err > CHUNKED_TOL * scale:
            assert ((g.double() - e).abs().max().item()
                    <= (w.double() - e).abs().max().item()), (name, err,
                                                              scale)


@pytest.mark.cuda
@pytest.mark.parametrize("given", [False, True], ids=["dropped", "dstate"])
def test_cuda_bwd_kernel_matches_plain_version(given):
    """The backward kernel from the forward kernel's stored chunk states
    and C.B^T scratch, held by :func:`_hold_bwd` on ``CUDA_BWD_SHAPES``; the stored states
    against the plain scan's final state of each chunk's prefix at 2e-4
    of scale; a second launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for bsz, s, h, p, n, chunk in CUDA_BWD_SHAPES:
        raw, dy, ds = _bwd_inputs(bsz, s, h, p, n, seed=7)
        args = [torch.from_numpy(a).cuda() for a in raw]
        tdy = torch.from_numpy(dy).cuda()
        tds = torch.from_numpy(ds).cuda() if given else None
        cb = torch.empty(kernel.scratch_shape(bsz, s, chunk), device="cuda")
        _, _, states = kernel.ssd_scan_kernel(*args, chunk=chunk, scratch=cb,
                                              with_states=True)
        cl = min(chunk, s)
        for z in range(states.shape[1]):
            want = (ref.ssd_chunked_ref(*(t[:, :z * cl] if t.dim() > 1 else t
                                          for t in args), chunk)[1]
                    if z else torch.zeros_like(states[:, 0]))
            lim = CHUNKED_TOL * max(1.0, want.abs().max().item())
            assert (states[:, z] - want).abs().max().item() <= lim, (s, z)
        got = kernel.ssd_scan_bwd_kernel(*args, tdy, states, cb, tds,
                                         chunk=chunk)
        _hold_bwd(got, args, tdy, tds, chunk)
        again = kernel.ssd_scan_bwd_kernel(*args, tdy, states, cb, tds,
                                           chunk=chunk)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_cuda_autograd_launches_the_forward_and_backward_once():
    """``ops.ssd_scan`` on CUDA leaves that need a gradient, at
    mamba2-780m's and hymba-1.5b's widths: one forward and one backward
    launch, no plain call, and the gradient held by :func:`_hold_bwd`,
    with the final state's gradient given and dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (bsz, s, h, p, n, chunk), given in (((2, 256, 4, 64, 128, 128), True),
                                           ((2, 256, 25, 64, 16, 128),
                                            False)):
        raw, dy, ds = _bwd_inputs(bsz, s, h, p, n, seed=8)
        leaves = [torch.from_numpy(a).cuda().requires_grad_() for a in raw]
        tdy = torch.from_numpy(dy).cuda()
        tds = torch.from_numpy(ds).cuda() if given else None
        ops.reset_counts()
        y, st = ops.ssd_scan(*leaves, chunk)
        outs, grads = ((y, st), (tdy, tds)) if given else ((y,), (tdy,))
        got = torch.autograd.grad(outs, leaves, grads)
        assert (ops.ssd_scan.launches, ops.ssd_scan_bwd.launches,
                ops.ssd_scan.plain_calls) == (1, 1, 0)
        _hold_bwd(got, [t.detach() for t in leaves], tdy, tds, chunk)


@pytest.mark.cuda
def test_cuda_bwd_refuses_widths_before_launch():
    """P above 64, N above 128 and a chunk above 128 raise a ValueError
    in the backward's wrapper, as in the forward's, and launch
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for p, n, chunk in [(128, 16, 64), (64, 256, 64), (64, 16, 256)]:
        raw, dy, _ = _bwd_inputs(1, 256, 2, p, n)
        args = [torch.from_numpy(a).cuda() for a in raw]
        states = torch.zeros(kernel.states_shape(1, 256, 2, p, n, chunk),
                             device="cuda")
        cb = torch.zeros(kernel.scratch_shape(1, 256, chunk), device="cuda")
        ops.reset_counts()
        with pytest.raises(ValueError):
            ops.ssd_scan_bwd(*args, torch.from_numpy(dy).cuda(), states, cb,
                             None, chunk)
        leaves = [t.requires_grad_() for t in args]
        with pytest.raises(ValueError):
            ops.ssd_scan(*leaves, chunk)
        assert (ops.ssd_scan.launches, ops.ssd_scan_bwd.launches) == (0, 0)
