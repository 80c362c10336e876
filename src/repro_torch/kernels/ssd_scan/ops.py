"""Device-keyed Mamba2 SSD scan and its gradient: the hand-written CUDA
kernels for CUDA tensors, the plain chunked PyTorch version
(``ref.ssd_chunked_ref``) for CPU tensors, and nothing else.

There is no fallback: a CUDA tensor launches the kernel or raises, and a
tensor on any other device raises.  Each wrapper counts its kernel
launches in ``.launches`` (and :func:`ssd_scan` its plain-version calls in
``.plain_calls``), plain ints a run can reset and read to show that its
main path went through the kernels.  A launch is one call of a kernel
wrapper, which counts once: the forward runs two CUDA kernels (C.B^T once
per row and chunk, then the scan on the tensor cores in 3xTF32), the
backward three (each chunk's state gradient; the per-head terms; db and
dc, all on the tensor cores in 3xTF32).

Training: on the CPU autograd runs through the plain chunked scan.  On
the card, a call whose inputs need a gradient goes through
:class:`SsdScanFn`: the forward kernel storing each chunk's incoming
state and keeping its C.B^T scratch, and :func:`ssd_scan_bwd` (the backward kernel, CUDA only) for the
gradient.  Serving (no gradient) launches the forward alone, as
before."""
from __future__ import annotations

import torch

from repro_torch.analysis.sanitizer import hot_path
from repro_torch.kernels import device_route
from repro_torch.kernels.ssd_scan import kernel, ref


class SsdScanFn(torch.autograd.Function):
    """The scan kernel with its chunk states and C.B^T scratch saved,
    and the backward kernel as its gradient (CUDA tensors, f32)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        cb = x.new_empty(kernel.scratch_shape(x.shape[0], x.shape[1], chunk))
        y, state, states = kernel.ssd_scan_kernel(x, dt, a, b, c,
                                                  chunk=chunk, scratch=cb,
                                                  with_states=True)
        ssd_scan.launches += 1
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
    out = kernel.ssd_scan_kernel(*args, chunk=chunk)
    ssd_scan.launches += 1
    return out


def ssd_scan_bwd(x, dt, a, b, c, dy, states, cb, dstate, chunk: int):
    """(dx, ddt, da, db, dc) of :func:`ssd_scan` from its inputs, dy, the
    forward's chunk states and C.B^T scratch and the final state's
    gradient (None if it was dropped): the backward kernel
    (``kernel.ssd_scan_bwd_kernel``, CUDA tensors only; the CPU
    differentiates the plain forward)."""
    grads = kernel.ssd_scan_bwd_kernel(x, dt, a, b, c, dy, states, cb,
                                       dstate, chunk=chunk)
    ssd_scan_bwd.launches += 1
    return grads


ssd_scan.launches = 0
ssd_scan.plain_calls = 0
ssd_scan_bwd.launches = 0

KERNELS = (ssd_scan, ssd_scan_bwd)


def reset_counts() -> None:
    """Zero the wrappers' launch and plain-version counts."""
    for fn in KERNELS:
        fn.launches = 0
    ssd_scan.plain_calls = 0
