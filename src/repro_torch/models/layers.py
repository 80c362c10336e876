"""Numeric primitives of the models (the reference package's
``models/layers.py``): RMS norm, rotary embeddings in the split-half
form and the SwiGLU MLP of the decoder-only families; LayerNorm,
whisper's fixed sinusoidal positions and the GELU MLP of the
encoder-decoder family."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least f32: bf16 and f32 compute in f32, as the
    reference's ``astype(float32)``; f64 stays f64, so that a run given
    f64 weights is f64 throughout."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Normalise in f32 (:func:`upcast`), scale, cast back to ``x``'s
    dtype."""
    dt = x.dtype
    x = upcast(x)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.to(x.dtype)).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Normalise in f32 (:func:`upcast`; biased variance), scale and
    shift, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = upcast(x)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.to(x.dtype) + bias.to(x.dtype)).to(dt)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper's fixed positional embeddings [n, d] in f32: the sines of
    the ``d // 2`` frequencies, then their cosines, computed in float64
    (numpy) as the reference computes them."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device,
                                                         non_blocking=True)


def gelu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    """``gelu(x @ up + up_b) @ down + down_b`` with the tanh form of GELU,
    which is ``jax.nn.gelu``'s default (torch's default is the exact erf
    form)."""
    h = F.gelu(x @ p["up"] + p["up_b"], approximate="tanh")
    return h @ p["down"] + p["down_b"]


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D], positions: [..., S].  Split-half rotation: the
    first and second halves of D form the (real, imaginary) pairs."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)              # [D/2]
    ang = positions[..., None].float() * freqs                 # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = upcast(x).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
