"""Device-keyed prefill attention: the hand-written CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors, and nothing else.

There is no fallback: a CUDA tensor launches the kernel or raises, and a
tensor on any other device raises.  The wrapper counts its kernel
launches in ``.launches`` (and its plain-version calls in
``.plain_calls``), plain ints a run can reset and read to show that its
main path went through the kernel."""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis.sanitizer import hot_path
from repro_torch.kernels import device_route
from repro_torch.kernels.flash_attention import kernel, ref


@hot_path
def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    kv_len: Optional[int] = None):
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D]: a
    prefill (Sq == Sk, any mask) or, in full mode, cross attention (Sq
    != Sk).  Keys at or past ``kv_len`` (default Sk) are masked.  A mode
    the kernel does not take raises a ``ValueError`` on every device."""
    kernel.check_modes(q.shape[1], k.shape[1], causal, window, kv_len)
    if device_route(q) == "cpu":
        flash_attention.plain_calls += 1
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       kv_len=kv_len)
    out = kernel.flash_attention_kernel(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=causal,
                                        window=window, kv_len=kv_len)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.plain_calls = 0

KERNELS = (flash_attention,)


def reset_counts() -> None:
    """Zero the wrapper's launch and plain-version counts."""
    for fn in KERNELS:
        fn.launches = 0
        fn.plain_calls = 0
