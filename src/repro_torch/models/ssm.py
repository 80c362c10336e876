"""The Mamba2 (state-space duality, SSD) block of the SSM family (the
reference package's ``models/ssm.py``).

``mamba_forward`` runs the full-sequence block; its chunked scan goes
through ``ops.ssd_scan``: the hand-written CUDA kernel on the card (and,
where the inputs need a gradient, its hand-written backward kernel), the
plain chunked version (``ssd_chunked_ref``, the reference model's own
``ssd_chunked``) under autograd on the CPU.  The scan computes in f32
whatever the activations' dtype.  ``mamba_decode`` is the one-token
recurrent step in plain PyTorch, as in the reference, where it runs no
kernel either."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import rms_norm


def _split_proj(p, x, d_in: int, n: int):
    """x @ in_proj split into (z, xs, b, c, dt) along the last axis."""
    zxbcdt = x @ p["in_proj"]
    return torch.split(zxbcdt, [d_in, d_in, n, n,
                                zxbcdt.shape[-1] - 2 * d_in - 2 * n], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d then SiLU; xbc: [B, S, C], w: [C, K]."""
    k = w.shape[-1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:xbc.shape[1], :] * w[:, 0]
    for i in range(1, k):
        out = out + pad[:, i:i + xbc.shape[1], :] * w[:, i]
    return F.silu(out + bias)


def mamba_forward(p, x: torch.Tensor, s: SSMConfig, d_inner: int,
                  return_state: bool = False):
    """Full-sequence Mamba2 block.  x: [B, S, d_model] -> [B, S, d_model];
    with ``return_state`` also (final SSD state [B, H, P, N] f32, conv
    state [B, C, K-1]: the last K-1 pre-activation conv inputs).  Every
    position is scanned, a right-padded row's pads included, as in the
    reference."""
    n, n_h = s.d_state, d_inner // s.head_dim
    z, xs, b, c, dt = _split_proj(p, x, d_inner, n)
    raw = torch.cat([xs, b, c], -1)
    xbc = _causal_conv(raw, p["conv_w"], p["conv_b"])
    xs, b, c = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"].float())
    xh = xs.reshape(*xs.shape[:-1], n_h, s.head_dim).float()
    y, state = ssd_scan(xh, dt, a, b.float(), c.float(), s.chunk_size)
    y = y + xh * p["D"].float()[:, None]
    y = y.reshape(xs.shape).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"])
    out = y @ p["out_proj"]
    if not return_state:
        return out
    # the reference computes in_proj a second time for this; the values
    # are the same, so the first product's split is reused
    k = s.conv_kernel
    conv_state = F.pad(raw, (0, 0, k - 1, 0))[:, raw.shape[1]:, :]
    return out, (state, conv_state.transpose(1, 2))


def mamba_decode(p, x: torch.Tensor, s: SSMConfig, d_inner: int,
                 state: Tuple[torch.Tensor, torch.Tensor]):
    """One-token recurrent step.  x: [B, 1, d_model]; state: (SSD state
    [B, H, P, N] f32, conv state [B, C, K-1]).  Returns (out [B, 1,
    d_model], (new SSD state, new conv state), both f32)."""
    ssd_state, conv_state = state
    n, n_h = s.d_state, d_inner // s.head_dim
    z, xs, b, c, dt = _split_proj(p, x[:, 0, :], d_inner, n)
    raw = torch.cat([xs, b, c], -1)                              # [B, C]
    window = torch.cat([conv_state.float(), raw.float()[:, :, None]],
                       dim=-1)                                   # [B, C, K]
    conv_out = F.silu(torch.einsum("bck,ck->bc", window,
                                   p["conv_w"].float()) + p["conv_b"])
    xs, b, c = torch.split(conv_out, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                   # [B, H]
    a = -torch.exp(p["A_log"].float())
    da = torch.exp(dt * a)
    xh = xs.reshape(-1, n_h, s.head_dim).float()
    upd = dt[..., None, None] * xh[..., None] * b[:, None, None, :].float()
    new_state = ssd_state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, c.float())
    y = y + xh * p["D"].float()[:, None]
    y = y.reshape(x.shape[0], d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"])
    return (y @ p["out_proj"])[:, None, :], (new_state, window[:, :, 1:])


def mamba_state_spec(cfg: ModelConfig, batch: int, d_inner: int):
    """Shapes and logical axes of one layer's recurrent state: (SSD state
    [batch, H, P, N], conv state [batch, C, K-1])."""
    s = cfg.ssm
    n_h = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    shapes = ((batch, n_h, s.head_dim, s.d_state),
              (batch, conv_dim, s.conv_kernel - 1))
    axes = (("cache_batch", "ssm_heads", None, None),
            ("cache_batch", "ssm_inner", None))
    return shapes, axes
