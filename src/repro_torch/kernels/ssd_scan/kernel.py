"""Hand-written Hopper kernel for the Mamba2 SSD chunked scan, launched
through ctypes (source: ``repro_torch/csrc/ssd_scan.cu``).

``ssd_scan_kernel`` replaces the TPU kernel of the same name in
``src/repro/kernels/ssd_scan/kernel.py`` (body ``_kernel``): one block per
(row, head) loops over the chunks with the f32 state in shared memory
(the source says more).

Takes CUDA tensors only; validates device, dtype, shape and contiguity,
allocates the outputs, launches on the current stream and raises if the
launch is refused.  It does not synchronise."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import check_cuda, raise_on
from repro_torch.kernels.build import load_library


def ssd_scan_kernel(x, dt, a, b, c, *, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, H, P]; dt: [B, S, H]; a: [H]; b, c: [B, S, N], all f32
    -> (y [B, S, H, P], final state [B, H, P, N]), f32."""
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
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=f32, device=x.device)
    with torch.cuda.device(x.device):
        rc = load_library().repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), state.data_ptr(), bsz, s, h, p, n,
            chunk, torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(rc, "ssd_scan")
    return y, state
