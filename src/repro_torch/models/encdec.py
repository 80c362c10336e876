"""Whisper-style encoder-decoder, the audio family (the reference
package's ``models/encdec.py``).

The mel-spectrogram and convolutional front end is a stub, as in the
reference: the model takes precomputed frame embeddings ``frames [B,
encoder_seq, d_model]``.  The transformer encoder, the decoder, the
cross attention and the two-part decode cache are ported.  Whisper is
pre-LN with LayerNorm and a GELU MLP (tanh form, as ``jax.nn.gelu``),
fixed sinusoidal positions, biases on Q, V and the output but not on K,
and the LM head tied to the embedding.

Every attention goes through the kernels' ops: the encoder (full mask,
the pad frames masked as keys by ``kv_len``), the decoder's causal
self-attention and its cross attention at prefill (the prompt's queries
against the encoder's rows, Sq != Sk) through the flash kernel, and both
decode attentions (the self cache, and the cross cache at
``encoder_seq`` keys) through the dense decode kernel.

The cache is ``{"kv": (k, v), "cross": (ck, cv)}``, each ``[L, B, S, H,
D]``.  Three cross lengths are kept as the reference has them, so that
streams equal the reference's: prefill's cross K/V has the encoder's
padded rows (1,536 for 1,500 frames), :func:`init_cache` gives
``encoder_seq`` rows, and decode reads ``encoder_seq`` of them
(``ContinuousEngine`` cuts a prefill's cross leaves to its cache's
rows).  Pad frames are computed as queries through the encoder and
masked only as keys; the decode positions table has the self cache's S
rows and a position past it reads row S - 1 (ROADMAP §3).

Where the reference is functional, :func:`decode_step` writes the self
cache in place (the cross cache is only read), so a CUDA graph can
replay it on the same tensors.

Training: :func:`lm_loss`, the decoder's next-token CE over the encoder's
output (aux 0), each encoder and decoder layer recomputed in the
backward pass as the reference's remat does."""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (gqa_decode_attention,
                                         gqa_prefill_attention)
from repro_torch.models.layers import (gelu_mlp, layer_norm,
                                      sinusoidal_positions)
from repro_torch.models.transformer import (_layer, _out_proj, _proj, _run,
                                           cast_params, cross_entropy)

# the encoder's frames are right-padded to a multiple of this (1500 ->
# 1536), the pad keys masked by kv_len
FRAME_MULTIPLE = 512


@functools.lru_cache(maxsize=None)
def _positions(n: int, d: int, device: torch.device) -> torch.Tensor:
    """:func:`sinusoidal_positions` [n, d] on ``device``, made once: a
    captured decode step reads this tensor and copies nothing from the
    host."""
    return sinusoidal_positions(n, d, device=device)


def _ln(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return layer_norm(x, p["w"], p["b"])


def _q(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return _proj(x, p["wq"]) + p["bq"]


def _kv(p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K (no bias, as in whisper) and V (with ``bv``) of ``x``."""
    return _proj(x, p["wk"]), _proj(x, p["wv"]) + p["bv"]


def _out(p: Dict, a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return _out_proj(a.to(dtype), p["wo"]) + p["bo"]


def _mha(p: Dict, xq: torch.Tensor, kv_x: torch.Tensor, *,
         causal: bool, kv_len: Optional[int] = None):
    """Attention of ``xq``'s queries over ``kv_x``'s keys and values,
    keys at or past ``kv_len`` masked.  Returns (out [B, Sq, d], (k, v))."""
    k, v = _kv(p, kv_x)
    a = gqa_prefill_attention(_q(p, xq), k, v, causal=causal, kv_len=kv_len)
    return _out(p, a, xq.dtype), (k, v)


def _pad_frames(frames: torch.Tensor, mult: int = FRAME_MULTIPLE):
    """Right-pad the (stubbed) codec frames to a multiple of ``mult``
    (1500 -> 1536); returns (frames, the count of real frames)."""
    f = frames.shape[1]
    pad = (-f) % mult
    if pad:
        frames = torch.cat([frames, frames.new_zeros(
            (frames.shape[0], pad, frames.shape[2]))], dim=1)
    return frames, f


def _enc_layer(bp: Dict, x: torch.Tensor, kv_len: int) -> torch.Tensor:
    hn = _ln(x, bp["ln1"])
    a, _ = _mha(bp["attn"], hn, hn, causal=False, kv_len=kv_len)
    x = x + a
    return x + gelu_mlp(_ln(x, bp["ln2"]), bp["mlp"])


def encode(params: Dict, cfg: ModelConfig, frames: torch.Tensor, *,
           act_dtype: torch.dtype = torch.bfloat16,
           remat: bool = False) -> torch.Tensor:
    """frames [B, F, d] -> encoder output [B, F', d], F' = F padded to a
    multiple of 512; the pad frames run through every layer as queries
    and are masked as keys.  ``remat`` recomputes each layer in the
    backward pass (training)."""
    params = cast_params(params, act_dtype)
    frames, kv_len = _pad_frames(frames)
    x = frames.to(act_dtype)
    x = x + _positions(x.shape[1], cfg.d_model, x.device).to(act_dtype)
    for i in range(cfg.encoder_layers):
        x = _run(_enc_layer, remat, _layer(params["enc_blocks"], i), x,
                 kv_len)
    return _ln(x, params["enc_ln"])


def _dec_layer(bp: Dict, x: torch.Tensor, enc_out: torch.Tensor,
               encoder_seq: int):
    """One decoder layer over the prompt: causal self-attention, cross
    attention over ``enc_out``'s first ``encoder_seq`` rows, the MLP.
    Returns (x, self (k, v), cross (k, v))."""
    hn = _ln(x, bp["ln1"])
    a, kv = _mha(bp["self"], hn, hn, causal=True)
    x = x + a
    a, cross = _mha(bp["cross"], _ln(x, bp["ln_x"]), enc_out, causal=False,
                    kv_len=encoder_seq)
    x = x + a
    return x + gelu_mlp(_ln(x, bp["ln2"]), bp["mlp"]), kv, cross


def _decoder(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
             enc_out: torch.Tensor, lengths: torch.Tensor, *,
             act_dtype: torch.dtype, cache_len: Optional[int]):
    """The decoder over the prompt: causal self-attention, then cross
    attention over ``enc_out`` (its first ``encoder_seq`` rows), then the
    MLP.  Returns (logits at each row's ``lengths - 1`` [B, V], cache):
    the self K/V zero-padded or cut to ``cache_len`` (default S), the
    cross K/V of all of ``enc_out``'s rows."""
    b, s = tokens.shape
    cl = cache_len or s
    h, hd, n_layers = cfg.num_heads, cfg.head_dim, cfg.num_layers
    x = params["embed"][tokens.long()].to(act_dtype)
    x = x + _positions(s, cfg.d_model, x.device).to(act_dtype)
    dev, f = x.device, enc_out.shape[1]
    cache = {"kv": tuple(torch.zeros((n_layers, b, cl, h, hd),
                                     dtype=act_dtype, device=dev)
                         for _ in range(2)),
             "cross": tuple(torch.zeros((n_layers, b, f, h, hd),
                                        dtype=act_dtype, device=dev)
                            for _ in range(2))}
    n = min(s, cl)
    for i in range(n_layers):
        x, kv, cross = _dec_layer(_layer(params["dec_blocks"], i), x,
                                  enc_out, cfg.encoder_seq)
        for leaf, t in zip(cache["kv"], kv):
            leaf[i, :, :n] = t[:, :n]
        for leaf, t in zip(cache["cross"], cross):
            leaf[i] = t
    rows = torch.arange(b, device=dev)
    last = _ln(x[rows, lengths.long() - 1], params["dec_ln"])
    return last @ params["embed"].T.to(last.dtype), cache


def _dec_train_layer(bp: Dict, x: torch.Tensor, enc_out: torch.Tensor,
                     encoder_seq: int) -> torch.Tensor:
    return _dec_layer(bp, x, enc_out, encoder_seq)[0]


def lm_loss(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor, *, rules=None,
            act_dtype: torch.dtype = torch.bfloat16):
    """Next-token CE of the decoder over ``tokens`` [B, S] (labels
    shifted by one), given the encoder's output for ``frames`` [B, F, d]:
    the logits of every position (the tied embedding as the head).
    Returns (ce, {"ce", "aux": 0}), as the reference's.  ``rules`` is
    accepted as the reference's is and not read (no constraint to
    place: ``partitioning.constrain`` is the identity)."""
    params = cast_params(params, act_dtype)
    enc = encode(params, cfg, frames, act_dtype=act_dtype, remat=True)
    s = tokens.shape[1]
    x = params["embed"][tokens.long()].to(act_dtype)
    x = x + _positions(s, cfg.d_model, x.device).to(act_dtype)
    for i in range(cfg.num_layers):
        x = _run(_dec_train_layer, True, _layer(params["dec_blocks"], i), x,
                 enc, cfg.encoder_seq)
    x = _ln(x, params["dec_ln"])
    logits = x @ params["embed"].T.to(x.dtype)
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor, frames: torch.Tensor, *, rules=None,
            act_dtype: torch.dtype = torch.bfloat16,
            cache_len: Optional[int] = None):
    """Encode ``frames`` and run the decoder over the right-padded
    prompts.  Returns (next-token logits [B, V] at ``lengths - 1``,
    cache {"kv": self K/V [L, B, cache_len, H, D], "cross": cross K/V
    [L, B, F', H, D]}); the logits are computed at those positions only
    (the rows are independent, as in the dense prefill).  ``rules`` as
    :func:`lm_loss`'s."""
    params = cast_params(params, act_dtype)
    enc = encode(params, cfg, frames, act_dtype=act_dtype)
    return _decoder(params, cfg, tokens, enc, lengths, act_dtype=act_dtype,
                    cache_len=cache_len)


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, positions: torch.Tensor, *,
                rules=None, act_dtype: torch.dtype = torch.bfloat16):
    """tokens [B]; positions [B].  ``rules`` is accepted as the
    reference's is and not read: the encoder-decoder family has no
    context-parallel branch.  Writes each row's self K/V at slot
    ``positions % S`` in place, attends its first ``min(positions + 1,
    S)`` slots, then the cross cache's first ``encoder_seq`` rows (cross
    K/V come precomputed from the prefill).  The position embedding is
    row ``min(positions, S - 1)`` of an S-row table.  Returns (logits
    [B, V], cache)."""
    params = cast_params(params, act_dtype)
    k_self, v_self = cache["kv"]
    k_cross, v_cross = cache["cross"]
    s_cache = k_self.shape[2]
    b = tokens.shape[0]
    x = params["embed"][tokens.long()][:, None].to(act_dtype)
    table = _positions(s_cache, cfg.d_model, x.device)
    x = x + table[torch.clamp(positions, max=s_cache - 1).long()][:, None] \
        .to(act_dtype)
    rows = torch.arange(b, device=x.device)
    slot = (positions % s_cache).long()
    valid = torch.clamp(positions + 1, max=s_cache)
    cross_len = torch.full((b,), cfg.encoder_seq, dtype=torch.int32,
                           device=x.device)
    for i in range(cfg.num_layers):
        bp = _layer(params["dec_blocks"], i)
        hn = _ln(x, bp["ln1"])
        q = _q(bp["self"], hn)
        k, v = _kv(bp["self"], hn)
        kc, vc = k_self[i], v_self[i]
        kc[rows, slot] = k[:, 0].to(kc.dtype)
        vc[rows, slot] = v[:, 0].to(vc.dtype)
        x = x + _out(bp["self"], gqa_decode_attention(q, kc, vc, valid),
                     x.dtype)
        qx = _q(bp["cross"], _ln(x, bp["ln_x"]))
        x = x + _out(bp["cross"], gqa_decode_attention(
            qx, k_cross[i], v_cross[i], cross_len), x.dtype)
        x = x + gelu_mlp(_ln(x, bp["ln2"]), bp["mlp"])
    x = _ln(x, params["dec_ln"])
    return (x @ params["embed"].T.to(x.dtype))[:, 0], cache


def cache_struct(cfg: ModelConfig, batch: int, seq: int,
                 dtype: torch.dtype = torch.bfloat16):
    """({key: ((shape, dtype), ...)}, logical axes) of the decode cache:
    the self K/V of ``seq`` slots and the cross K/V of ``encoder_seq``
    rows, each [L, batch, rows, H, D] in ``dtype``."""
    n, h, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    kv = ((n, batch, seq, h, hd), dtype)
    cross = ((n, batch, cfg.encoder_seq, h, hd), dtype)
    ax_kv = ("layers", "cache_batch", "kv_seq", "cache_heads", None)
    ax_cr = ("layers", "cache_batch", None, "cache_heads", None)
    return ({"kv": (kv, kv), "cross": (cross, cross)},
            {"kv": (ax_kv, ax_kv), "cross": (ax_cr, ax_cr)})


def init_cache(cfg: ModelConfig, batch: int, seq: int, *,
               dtype: torch.dtype = torch.bfloat16, device) -> Dict:
    """A zero decode cache (the layout of :func:`cache_struct`) on
    ``device``."""
    shapes, _ = cache_struct(cfg, batch, seq, dtype)
    return {key: tuple(torch.zeros(shape, dtype=dt, device=device)
                       for shape, dt in leaves)
            for key, leaves in shapes.items()}
