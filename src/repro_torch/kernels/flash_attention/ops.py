"""Device-keyed prefill attention and its gradient: the hand-written CUDA
kernels for CUDA tensors, the plain PyTorch versions for CPU tensors, and
nothing else.

There is no fallback: a CUDA tensor launches the kernel or raises, and a
tensor on any other device raises (a ``meta`` tensor gets the op's
output shapes: the dry run).  Each launch is one registered op
(:func:`repro_torch.kernels.register_op`): ``repro_torch::
flash_attention``, ``flash_attention_lse`` (with the log-sum-exp) and
``flash_attention_bwd``, whose CUDA implementations count the launch in
the wrappers' ``.launches`` (:func:`flash_attention` counts its
plain-version calls in ``.plain_calls``), plain ints a run can reset and
read to show that its main path went through the kernel.

The forward ops' flop formula counts the reference model's plain
attention (``src/repro/models/attention.py`` ``gqa_prefill_attention``):
QK^T and PV over the full Sq x Sk, whatever the mask, 4 B Sq Sk Hq D.
The backward's counts the products ``jax.vjp`` of that function adds to
its forward, twice the forward's (XLA keeps no recomputed product).

Training: on the CPU autograd runs through the plain forward.  On the
card, a call whose inputs need a gradient goes through
:class:`FlashAttentionFn`: the forward kernel with its log-sum-exp, and
:func:`flash_attention_bwd` (the backward kernel, CUDA only) for the
gradient, in f32 or bf16."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.sanitizer import hot_path
from repro_torch.kernels import device_route, register_op
from repro_torch.kernels.flash_attention import kernel, ref


def _forward_flops(q, k, *_, **__) -> int:
    b, sq, hq, d = q
    return 4 * b * sq * k[1] * hq * d


def _backward_flops(q, k, *_, **__) -> int:
    return 2 * _forward_flops(q, k)


@hot_path
def _flash_cuda(q, k, v, causal, window, kv_len):
    out = kernel.flash_attention_kernel(q, k, v, causal=causal,
                                        window=window, kv_len=kv_len)
    flash_attention.launches += 1
    return out


@hot_path
def _flash_lse_cuda(q, k, v, causal, window, kv_len):
    out = kernel.flash_attention_kernel(q, k, v, causal=causal,
                                        window=window, kv_len=kv_len,
                                        with_lse=True)
    flash_attention.launches += 1
    return out


@hot_path
def _flash_bwd_cuda(q, k, v, out, dout, lse, causal, window, kv_len):
    grads = kernel.flash_attention_bwd_kernel(
        q, k, v, out, dout, lse, causal=causal, window=window, kv_len=kv_len)
    flash_attention_bwd.launches += 1
    return grads


def _flash_fake(q, *_):
    return torch.empty_like(q)


def _flash_lse_fake(q, *_):
    b, sq, hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, sq, hq),
                                            dtype=torch.float32)


def _flash_bwd_fake(q, k, v, *_):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_MODE = "bool causal, int? window, int? kv_len"
_FLASH_OP = register_op(
    "flash_attention", f"(Tensor q, Tensor k, Tensor v, {_MODE}) -> Tensor",
    _flash_cuda, _flash_fake, _forward_flops).default
_FLASH_LSE_OP = register_op(
    "flash_attention_lse",
    f"(Tensor q, Tensor k, Tensor v, {_MODE}) -> (Tensor, Tensor)",
    _flash_lse_cuda, _flash_lse_fake, _forward_flops).default
_FLASH_BWD_OP = register_op(
    "flash_attention_bwd",
    f"(Tensor q, Tensor k, Tensor v, Tensor out, Tensor dout, Tensor lse, "
    f"{_MODE}) -> (Tensor, Tensor, Tensor)",
    _flash_bwd_cuda, _flash_bwd_fake, _backward_flops).default


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel with its log-sum-exp saved, and the backward
    kernel as its gradient (CUDA tensors, f32 or bf16)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len):
        out, lse = _FLASH_LSE_OP(q, k, v, causal, window, kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mode = (causal, window, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, kv_len = ctx.mode
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, causal=causal, window=window,
                                         kv_len=kv_len)
        return dq, dk, dv, None, None, None


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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, kv_len)
    return _FLASH_OP(q, k, v, causal, window, kv_len)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: Optional[int] = None,
                        kv_len: Optional[int] = None):
    """(dq, dk, dv) of :func:`flash_attention` from its output and
    log-sum-exp: the backward kernel (``kernel.flash_attention_bwd_kernel``,
    CUDA tensors only; the CPU differentiates the plain forward)."""
    return _FLASH_BWD_OP(q, k, v, out, dout, lse, causal, window, kv_len)


flash_attention.launches = 0
flash_attention.plain_calls = 0
flash_attention_bwd.launches = 0

KERNELS = (flash_attention, flash_attention_bwd)


def reset_counts() -> None:
    """Zero the wrappers' launch and plain-version counts."""
    for fn in KERNELS:
        fn.launches = 0
    flash_attention.plain_calls = 0
