"""Device-keyed Mamba2 SSD scan and its gradient: the hand-written CUDA
kernels for CUDA tensors, the plain chunked PyTorch version
(``ref.ssd_chunked_ref``) for CPU tensors, and nothing else.

There is no fallback: a CUDA tensor launches the kernel or raises, and a
tensor on any other device raises (a ``meta`` tensor gets the op's
output shapes: the dry run).  Each launch is one registered op
(:func:`repro_torch.kernels.register_op`): ``repro_torch::ssd_scan``,
``ssd_scan_states`` (with the chunk states and the C.B^T scratch) and
``ssd_scan_bwd``, whose CUDA implementations count the launch in the
wrappers' ``.launches`` (:func:`ssd_scan` counts its plain-version calls
in ``.plain_calls``), plain ints a run can reset and read to show that
its main path went through the kernels.  A launch is one call of a
kernel wrapper, which counts once: the forward runs two CUDA kernels
(C.B^T once per row and chunk, then the scan on the tensor cores in
3xTF32), the backward three (each chunk's state gradient; the per-head
terms; db and dc, all on the tensor cores in 3xTF32).

The flop formulas count the products of the reference model's chunked
scan (``src/repro/models/ssm.py`` ``ssd_chunked``, chunks of the largest
length up to ``chunk`` that divides S): :func:`scan_flops`.

Training: on the CPU autograd runs through the plain chunked scan.  On
the card, a call whose inputs need a gradient goes through
:class:`SsdScanFn`: the forward kernel storing each chunk's incoming
state and keeping its C.B^T scratch, and :func:`ssd_scan_bwd` (the backward kernel, CUDA only) for the
gradient.  Serving (no gradient) launches the forward alone, as
before."""
from __future__ import annotations

import torch

from repro_torch.analysis.sanitizer import hot_path
from repro_torch.kernels import device_route, register_op
from repro_torch.kernels.ssd_scan import kernel, ref


def scan_flops(x, b, chunk: int, backward: bool = False) -> int:
    """The reference's ``ssd_chunked`` products for x [B, S, H, P] and b
    [B, S, N] (shapes), in chunks of L (the largest length up to
    ``chunk`` that divides S): C.B^T (T1 = 2 B S L N), the intra term
    (T2 = 2 B S L H P), the chunk states and the inter term (T3 = 2 B S
    H P N each).  The backward counts what ``jax.vjp`` adds to that
    forward: both gradients of T1, one of T2 (XLA's program computes
    the other without a dot), both of the chunk states, and both of the
    inter term when there is more than one chunk (with one, its state
    is the zero constant, and XLA drops them)."""
    bsz, s, h, p = x
    n = b[2]
    length = min(chunk, s)
    while s % length:
        length -= 1
    t1, t2, t3 = (2 * bsz * s * length * n, 2 * bsz * s * length * h * p,
                  2 * bsz * s * h * p * n)
    if not backward:
        return t1 + t2 + 2 * t3
    return 2 * t1 + t2 + 2 * t3 + (2 * t3 if s > length else 0)


def _forward_flops(x, dt, a, b, c, chunk, **__) -> int:
    return scan_flops(x, b, chunk)


def _backward_flops(x, dt, a, b, c, dy, states, cb, dstate, chunk,
                    **__) -> int:
    return scan_flops(x, b, chunk, backward=True)


@hot_path
def _scan_cuda(x, dt, a, b, c, chunk):
    out = kernel.ssd_scan_kernel(x, dt, a, b, c, chunk=chunk)
    ssd_scan.launches += 1
    return out


@hot_path
def _scan_states_cuda(x, dt, a, b, c, chunk):
    cb = x.new_empty(kernel.scratch_shape(x.shape[0], x.shape[1], chunk))
    y, state, states = kernel.ssd_scan_kernel(x, dt, a, b, c, chunk=chunk,
                                              scratch=cb, with_states=True)
    ssd_scan.launches += 1
    return y, state, states, cb


@hot_path
def _scan_bwd_cuda(x, dt, a, b, c, dy, states, cb, dstate, chunk):
    grads = kernel.ssd_scan_bwd_kernel(x, dt, a, b, c, dy, states, cb,
                                       dstate, chunk=chunk)
    ssd_scan_bwd.launches += 1
    return grads


def _scan_fake(x, dt, a, b, c, chunk):
    bsz, _, h, p = x.shape
    return torch.empty_like(x), x.new_empty((bsz, h, p, b.shape[2]))


def _scan_states_fake(x, dt, a, b, c, chunk):
    bsz, s, h, p = x.shape
    y, state = _scan_fake(x, dt, a, b, c, chunk)
    return (y, state,
            x.new_empty(kernel.states_shape(bsz, s, h, p, b.shape[2], chunk)),
            x.new_empty(kernel.scratch_shape(bsz, s, chunk)))


def _scan_bwd_fake(x, dt, a, b, c, *_):
    return tuple(torch.empty_like(t) for t in (x, dt, a, b, c))


_INPUTS = "Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c"
_SCAN_OP = register_op(
    "ssd_scan", f"({_INPUTS}, int chunk) -> (Tensor, Tensor)",
    _scan_cuda, _scan_fake, _forward_flops).default
_SCAN_STATES_OP = register_op(
    "ssd_scan_states",
    f"({_INPUTS}, int chunk) -> (Tensor, Tensor, Tensor, Tensor)",
    _scan_states_cuda, _scan_states_fake, _forward_flops).default
_SCAN_BWD_OP = register_op(
    "ssd_scan_bwd",
    f"({_INPUTS}, Tensor dy, Tensor states, Tensor cb, Tensor? dstate, "
    f"int chunk) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _scan_bwd_cuda, _scan_bwd_fake, _backward_flops).default


class SsdScanFn(torch.autograd.Function):
    """The scan kernel with its chunk states and C.B^T scratch saved,
    and the backward kernel as its gradient (CUDA tensors, f32)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        y, state, states, cb = _SCAN_STATES_OP(x, dt, a, b, c, chunk)
        ctx.save_for_backward(x, dt, a, b, c, states, cb)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, states, cb = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        grads = ssd_scan_bwd(x, dt, a, b, c, dy, states, cb, dstate,
                             ctx.chunk)
        return (*grads, None)


@hot_path
def ssd_scan(x, dt, a, b, c, chunk: int):
    """x: [B, S, H, P]; dt: [B, S, H] (post-softplus); a: [H] (< 0); b, c:
    [B, S, N], all f32 -> (y [B, S, H, P], final state [B, H, P, N])."""
    if device_route(x) == "cpu":
        ssd_scan.plain_calls += 1
        return ref.ssd_chunked_ref(x, dt, a, b, c, chunk)
    args = [t.contiguous() for t in (x, dt, a, b, c)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SsdScanFn.apply(*args, chunk)
    return _SCAN_OP(*args, chunk)


def ssd_scan_bwd(x, dt, a, b, c, dy, states, cb, dstate, chunk: int):
    """(dx, ddt, da, db, dc) of :func:`ssd_scan` from its inputs, dy, the
    forward's chunk states and C.B^T scratch and the final state's
    gradient (None if it was dropped): the backward kernel
    (``kernel.ssd_scan_bwd_kernel``, CUDA tensors only; the CPU
    differentiates the plain forward)."""
    return _SCAN_BWD_OP(x, dt, a, b, c, dy, states, cb, dstate, chunk)


ssd_scan.launches = 0
ssd_scan.plain_calls = 0
ssd_scan_bwd.launches = 0

KERNELS = (ssd_scan, ssd_scan_bwd)


def reset_counts() -> None:
    """Zero the wrappers' launch and plain-version counts."""
    for fn in KERNELS:
        fn.launches = 0
    ssd_scan.plain_calls = 0
