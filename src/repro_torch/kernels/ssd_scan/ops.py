"""Device-keyed Mamba2 SSD scan: the hand-written CUDA kernel for CUDA
tensors, the plain chunked PyTorch version (``ref.ssd_chunked_ref``) for
CPU tensors, and nothing else.

There is no fallback: a CUDA tensor launches the kernel or raises, and a
tensor on any other device raises.  The wrapper counts its kernel
launches in ``.launches`` (and its plain-version calls in
``.plain_calls``), plain ints a run can reset and read to show that its
main path went through the kernel.  A launch is one call of the kernel
wrapper, which runs two CUDA kernels (C.B^T once per row and chunk, then
the scan on the tensor cores in 3xTF32) and counts once.  The kernel has
no backward: a CUDA call whose inputs need a gradient raises."""
from __future__ import annotations

import torch

from repro_torch.analysis.sanitizer import hot_path
from repro_torch.kernels import device_route
from repro_torch.kernels.ssd_scan import kernel, ref


@hot_path
def ssd_scan(x, dt, a, b, c, chunk: int):
    """x: [B, S, H, P]; dt: [B, S, H] (post-softplus); a: [H] (< 0); b, c:
    [B, S, N], all f32 -> (y [B, S, H, P], final state [B, H, P, N])."""
    if device_route(x) == "cpu":
        ssd_scan.plain_calls += 1
        return ref.ssd_chunked_ref(x, dt, a, b, c, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c)):
        raise NotImplementedError(
            "the SSD scan kernel has no backward yet, so the SSM and hybrid "
            "families do not train on the card (ROADMAP §1 item 11); on "
            "the CPU they train through the plain scan")
    out = kernel.ssd_scan_kernel(x.contiguous(), dt.contiguous(),
                                 a.contiguous(), b.contiguous(),
                                 c.contiguous(), chunk=chunk)
    ssd_scan.launches += 1
    return out


ssd_scan.launches = 0
ssd_scan.plain_calls = 0

KERNELS = (ssd_scan,)


def reset_counts() -> None:
    """Zero the wrapper's launch and plain-version counts."""
    for fn in KERNELS:
        fn.launches = 0
        fn.plain_calls = 0
