"""Hand-written Hopper kernels for the Mamba2 SSD chunked scan and its
gradient, launched through ctypes (sources: ``repro_torch/csrc/ssd_scan.cu``
and ``ssd_scan_bwd.cu``).

``ssd_scan_kernel`` replaces the TPU kernel of the same name in
``src/repro/kernels/ssd_scan/kernel.py`` (body ``_kernel``).  One call
runs two CUDA kernels: the first forms C_z . B_z^T once per (row,
chunk) into an f32 scratch; the second runs one block per (head, slice
of ``p_tile`` of the P columns, row), walks the chunks with the state in
registers and does its three products on the tensor cores in 3xTF32
(hi/lo split of every f32 operand, mma.sync m16n8k8).  The source says
more.

Takes CUDA tensors only; validates device, dtype, shape, contiguity and
the widths the tensor-core tiles take (P <= 64, N <= 128, chunk <= 128
once cut to S), allocates the outputs and the scratch, launches on the
current stream and raises if the launch is refused.  It does not
synchronise.  Given ``with_states``, the forward also writes each chunk's
incoming state, which ``ssd_scan_bwd_kernel`` reads beside the forward's
C.B^T scratch.

``ssd_scan_bwd_kernel`` replaces no TPU kernel (the JAX package
differentiates its plain ``jnp`` scan): from the forward's inputs, its
chunk states and C.B^T scratch, dy and the final state's gradient it
computes (dx, ddt, da, db, dc) in three CUDA kernels on the tensor cores
in 3xTF32 (each chunk's state gradient walked in reverse; every per-head
term, one block per group of :func:`head_group_for` heads, chunk and
row; db and dc with the heads as the k dimension), the same widths as
the forward.  The source says more."""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import check_cuda, raise_on
from repro_torch.kernels.build import load_library

MAX_P = 64          # head size: one or two slices of the P tile
MAX_N = 128         # state size, padded to 32, 64 or 128 in the kernel
MAX_CHUNK = 128     # rows of a chunk (after cutting it to S)
P_TILES = (32, 64)


def check_widths(p: int, n: int, s: int, chunk: int) -> int:
    """The chunk length C = min(chunk, S) the kernel runs; raises a
    ValueError for a width the tensor-core tiles do not take."""
    if chunk < 1 or s < 1:
        raise ValueError(f"chunk and S must be >= 1, got {chunk}, {s}")
    if not 1 <= p <= MAX_P:
        raise ValueError(f"scan head size P {p} not in [1, {MAX_P}]")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"scan state size N {n} not in [1, {MAX_N}]")
    c = min(chunk, s)
    if c > MAX_CHUNK:
        raise ValueError(f"scan chunk {c} (chunk {chunk}, S {s}) above "
                         f"{MAX_CHUNK}")
    return c


def scratch_shape(bsz: int, s: int, chunk: int) -> Tuple[int, int, int, int]:
    """Shape of the f32 C.B^T scratch: [B, chunks, Cp, Cp], Cp = the
    chunk length C = min(chunk, S) rounded up to 16."""
    c = min(chunk, s)
    cp = -(-c // 16) * 16
    return bsz, -(-s // c), cp, cp


def p_tile_for(bsz: int, h: int, p: int, sms: int) -> int:
    """The P slice of a scan block: 32 where P fits one, or where even
    32-wide slices leave the card at most one block per SM (B 1 at
    mamba2-780m's 48 heads); else 64, which reads each chunk's C.B^T, b
    and c once per head instead of twice, and was faster from B 2 on an
    H100 (PERF.md)."""
    return 32 if p <= 32 or 2 * bsz * h <= sms else 64


def head_group_for(bsz: int, nchunks: int, h: int, sms: int) -> int:
    """The heads a block of the backward's chunk kernel takes, in order:
    the fewest that leave at most one (group, chunk, row) block for each
    SM (the kernel fits one block an SM): a block leaves one dG partial
    for db and dc whatever its group, so larger groups mean fewer
    partials, and more blocks than SMs would run in a second wave.
    mamba2-780m's training call (B 8, two chunks, 48 heads) takes 6 (128
    blocks), hymba-1.5b's (25 heads) 4 (112).  Where the rows and chunks
    alone outnumber the SMs, all the heads."""
    for group in range(1, h):
        if bsz * nchunks * -(-h // group) <= sms:
            return group
    return max(h, 1)


def bwd_scratch_shapes(bsz: int, s: int, h: int, p: int, n: int, chunk: int,
                       group: int):
    """Shapes of the backward's f32 scratch: each chunk's outgoing state
    gradient (as :func:`states_shape`), each group's dG^T [B, chunks,
    groups, Cp, Cp], u and exp(cum) [B, S, H] each, and da's part [B,
    chunks, H] a (row, chunk)."""
    _, nc, cp, _ = scratch_shape(bsz, s, chunk)
    return [states_shape(bsz, s, h, p, n, chunk),
            (bsz, nc, -(-h // group), cp, cp), (bsz, s, h), (bsz, s, h),
            (bsz, nc, h)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def states_shape(bsz: int, s: int, h: int, p: int, n: int,
                 chunk: int) -> Tuple[int, int, int, int, int]:
    """Shape of the chunks' incoming states the forward writes for the
    backward: [B, chunks, H, P, N], chunks = ceil(S / min(chunk, S))."""
    return bsz, -(-s // min(chunk, s)), h, p, n


def _check_inputs(x, dt, a, b, c) -> Tuple[int, int, int, int, int]:
    """Device, dtype, contiguity and shapes of the scan's inputs; returns
    (B, S, H, P, N)."""
    f32 = torch.float32
    check_cuda("x", x, dtype=f32, dim=4)
    check_cuda("dt", dt, dtype=f32, dim=3)
    check_cuda("a", a, dtype=f32, dim=1)
    check_cuda("b", b, dtype=f32, dim=3)
    check_cuda("c", c, dtype=f32, dim=3)
    bsz, s, h, p = x.shape
    n = b.shape[2]
    if (dt.shape != (bsz, s, h) or a.shape != (h,)
            or b.shape[:2] != (bsz, s) or c.shape != b.shape):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    return bsz, s, h, p, n


def ssd_scan_kernel(x, dt, a, b, c, *, chunk: int,
                    p_tile: Optional[int] = None,
                    scratch: Optional[torch.Tensor] = None,
                    with_states: bool = False):
    """x: [B, S, H, P]; dt: [B, S, H]; a: [H]; b, c: [B, S, N], all f32
    -> (y [B, S, H, P], final state [B, H, P, N]), f32, and with
    ``with_states`` also each chunk's incoming state (:func:`states_shape`).
    ``p_tile`` (32 or 64) overrides :func:`p_tile_for`; ``scratch``, if
    given, is the f32 CUDA tensor of :func:`scratch_shape` that receives
    C.B^T (else one is allocated)."""
    f32 = torch.float32
    bsz, s, h, p, n = _check_inputs(x, dt, a, b, c)
    check_widths(p, n, s, chunk)
    if p_tile is None:
        p_tile = p_tile_for(bsz, h, p, _sm_count(x.device.index))
    if p_tile not in P_TILES:
        raise ValueError(f"p_tile {p_tile} not in {P_TILES}")
    shape = scratch_shape(bsz, s, chunk)
    if scratch is None:
        scratch = torch.empty(shape, dtype=f32, device=x.device)
    else:
        check_cuda("scratch", scratch, dtype=f32, dim=4)
        if scratch.shape != shape:
            raise ValueError(f"scratch must be {shape}, got "
                             f"{tuple(scratch.shape)}")
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=f32, device=x.device)
    states = (torch.empty(states_shape(bsz, s, h, p, n, chunk), dtype=f32,
                          device=x.device) if with_states else None)
    with torch.cuda.device(x.device):
        rc = load_library().repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), state.data_ptr(),
            states.data_ptr() if with_states else None,
            scratch.data_ptr(), bsz, s, h, p, n, chunk, p_tile,
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(rc, "ssd_scan")
    return (y, state, states) if with_states else (y, state)


def ssd_scan_bwd_kernel(x, dt, a, b, c, dy, states, cb,
                        dstate: Optional[torch.Tensor] = None, *,
                        chunk: int) -> Tuple[torch.Tensor, ...]:
    """The scan's gradient: the forward's inputs (as
    :func:`ssd_scan_kernel`), dy [B, S, H, P], ``states`` and ``cb``
    (each chunk's incoming state and the C.B^T scratch of
    :func:`scratch_shape`, from ``ssd_scan_kernel(..., scratch=cb,
    with_states=True)``) and ``dstate`` [B, H, P, N] (None: the final
    state was dropped), all f32 -> (dx [B, S, H, P], ddt [B, S, H], da
    [H], db [B, S, N], dc [B, S, N]), f32.  Allocates the f32 scratch of
    :func:`bwd_scratch_shapes` at :func:`head_group_for`'s group."""
    f32 = torch.float32
    bsz, s, h, p, n = _check_inputs(x, dt, a, b, c)
    check_widths(p, n, s, chunk)
    check_cuda("dy", dy, dtype=f32, dim=4)
    check_cuda("states", states, dtype=f32, dim=5)
    check_cuda("cb", cb, dtype=f32, dim=4)
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    shape = states_shape(bsz, s, h, p, n, chunk)
    if states.shape != shape:
        raise ValueError(f"states must be {shape}, got "
                         f"{tuple(states.shape)}")
    if cb.shape != scratch_shape(bsz, s, chunk):
        raise ValueError(f"cb must be {scratch_shape(bsz, s, chunk)}, got "
                         f"{tuple(cb.shape)}")
    if dstate is not None:
        check_cuda("dstate", dstate, dtype=f32, dim=4)
        if dstate.shape != (bsz, h, p, n):
            raise ValueError(f"dstate must be {(bsz, h, p, n)}, got "
                             f"{tuple(dstate.shape)}")
    new = functools.partial(torch.empty, dtype=f32, device=x.device)
    dx, ddt, db, dc = (torch.empty_like(t) for t in (x, dt, b, c))
    da = new((h,))
    if not (bsz and h):          # no rows or no heads: nothing to launch
        return dx, ddt, da.zero_(), db.zero_(), dc.zero_()
    group = head_group_for(bsz, shape[1], h, _sm_count(x.device.index))
    scratch = [new(sh) for sh in bwd_scratch_shapes(bsz, s, h, p, n, chunk,
                                                    group)]
    with torch.cuda.device(x.device):
        rc = load_library().repro_ssd_scan_bwd(
            *(t.data_ptr() for t in (x, dt, a, b, c, dy, states, cb)),
            None if dstate is None else dstate.data_ptr(),
            *(t.data_ptr() for t in (dx, ddt, da, db, dc, *scratch)),
            bsz, s, h, p, n, chunk, group,
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(rc, "ssd_scan_bwd")
    return dx, ddt, da, db, dc
