"""The int8 KV-cache decode path of the PyTorch port against the JAX
reference, on the CPU with the reference's weights carried across.

- ``_quant_i8`` equals the reference's bit for bit (int8 values and bf16
  scales).
- The plain ``decode_attention_int8`` (dequantised in f32, as the TPU
  kernel does) is held against the JAX ``decode_attention_int8_kernel``
  in interpret mode at 2e-4, and against the float oracle on the
  unquantised cache at the reference's 0.05, on
  ``test_kernels.py::test_decode_attention_int8``'s shapes; int8 extremes
  and NaN or inf scales past the lengths change nothing.
- ``decode_step`` on an int8 cache against the JAX int8 ``decode_step``
  on the same cache, at 1e-4 of the logits' scale: the reference model
  dequantises into a bf16 copy of the cache where the port's kernel
  dequantises in f32, and on the CPU the two differ by ~1e-6 of scale
  (measured on reduced qwen2.5-14b and chatglm-6b), so 1e-4 leaves
  margin without hiding a wrong scale or slot.  On the inputs of
  ``test_perf_knobs.py::test_int8_kv_cache_close_to_fp`` both are held
  against the float decode at its 0.05.
- The int8 cache layout, the fused decode window on it, and the padded
  engines' refusal (the reference's engines cannot serve an int8 cache
  either: its prefill builds a float one).

The hand-written CUDA kernel is compared with the plain version by the
``cuda``-marked test, which runs only where a card is present.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.decode_attention.kernel import (
    decode_attention_int8_kernel as jax_int8_kernel)
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_fp_ref)
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import kernel, ops, ref
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import BatchEngine, ContinuousEngine

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

PLAIN_TOL = 2e-4       # f32 dequantisation on both sides
QUANT_TOL = 0.05       # the reference's int8-vs-float bound
MODEL_TOL = 1e-4       # port int8 decode_step vs JAX int8 decode_step
SHAPES = [(256, 4, 2, 32), (320, 8, 2, 64)]   # test_decode_attention_int8


def _q8(t):
    """The reference test's quantiser, in numpy: f32 scales."""
    sc = np.maximum(np.abs(t).max(-1) / 127.0, 1e-8).astype(np.float32)
    return np.round(t / sc[..., None]).astype(np.int8), sc


def _kernel_inputs(s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    b = 2
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    lengths = np.array([s, s // 3], np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("seed,spread", [(0, 1.0), (1, 30.0), (2, 1e-3)])
def test_quant_i8_equals_jax_bit_for_bit(seed, spread):
    rng = np.random.default_rng(seed)
    t = (rng.normal(size=(4, 1, 6, 64))
         * rng.uniform(0, spread, size=(4, 1, 6, 1))).astype(np.float32)
    t[0, 0, 0] = 0.0                         # an all-zero row: the 1e-8 floor
    jq, js = JT._quant_i8(jnp.asarray(t))
    tq, ts = T._quant_i8(torch.from_numpy(t))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tq.shape == (4, 1, 6, 64) and ts.shape == (4, 1, 6)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))


@pytest.mark.parametrize("s,hq,hkv,d", SHAPES)
def test_plain_int8_decode_matches_jax_kernel_and_fp_oracle(s, hq, hkv, d):
    q, k, v, lengths = _kernel_inputs(s, hq, hkv, d)
    kq, ks = _q8(k)
    vq, vs = _q8(v)
    out = ops.decode_attention_int8(
        *(torch.from_numpy(a) for a in (q, kq, vq, ks, vs, lengths)))
    want = np.asarray(jax_int8_kernel(
        *(jnp.asarray(a) for a in (q, kq, vq, ks, vs, lengths)), block_k=64,
        interpret=True))
    np.testing.assert_allclose(out.numpy(), want, atol=PLAIN_TOL,
                               rtol=PLAIN_TOL)
    fp = np.asarray(jax_fp_ref(*(jnp.asarray(a) for a in (q, k, v,
                                                          lengths))))
    assert float(np.abs(out.numpy() - fp).max()) < QUANT_TOL


def test_plain_int8_decode_ignores_poison_past_the_lengths():
    """Int8 extremes in the values and NaN or inf in the bf16 scales past
    each row's length leave the output exactly as it was."""
    q, k, v, lengths = _kernel_inputs(256, 4, 2, 32, seed=3)
    kq, ks = _q8(k)
    vq, vs = _q8(v)
    args = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs, lengths)]
    args[3], args[4] = args[3].to(torch.bfloat16), args[4].to(torch.bfloat16)
    out1 = ops.decode_attention_int8(*args)
    for i, n in enumerate(lengths.tolist()):
        args[1][i, n:], args[2][i, n:] = 127, -128
        args[3][i, n:], args[4][i, n:] = float("nan"), float("inf")
    out2 = ops.decode_attention_int8(*args)
    assert torch.equal(out1, out2)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _int8(cfg):
    return dataclasses.replace(cfg, cache_int8=True)


def _to_torch(a):
    """A JAX cache leaf to torch, bf16 through f32 (exact)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _quantised(kv, quant):
    """A float cache {"kv": (k, v)} -> the int8 layout (k, v, k_scale,
    v_scale), quantised by ``quant`` (a ``_quant_i8``)."""
    (kq, ks), (vq, vs) = quant(kv[0]), quant(kv[1])
    return kq, vq, ks, vs


def _prefill_both(arch, toks, s):
    """Both packages' f32 prefill of ``toks[:, :s]`` (cache_len s + 4)
    and their float decode step on ``toks[:, s]``."""
    jcfg, tcfg, jp, tp = _setup(arch)
    toks = np.array(toks)                      # writable, for from_numpy
    b = toks.shape[0]
    pos = np.full(b, s, np.int32)
    _, jcache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :s]),
                                      "lengths": jnp.asarray(pos)},
                           cache_len=s + 4, act_dtype=jnp.float32)
    jstep = {"tokens": jnp.asarray(toks[:, s]), "positions": jnp.asarray(pos)}
    jfp, _ = JM.decode_step(jp, jcfg, jcache, jstep, act_dtype=jnp.float32)
    tstep = {"tokens": torch.from_numpy(toks[:, s].copy()),
             "positions": torch.from_numpy(pos)}
    _, tcache = M.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :s]),
                                     "lengths": torch.from_numpy(pos)},
                          cache_len=s + 4, act_dtype=torch.float32)
    return jcache, jstep, np.asarray(jfp), tcache, tstep


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "chatglm-6b"])
def test_int8_decode_step_matches_jax(arch, seed):
    """The same int8 cache (the JAX prefill's, quantised by the JAX
    ``_quant_i8``) through both packages' int8 ``decode_step``: logits
    within 1e-4 of scale, the new slot's int8 values within one step and
    its scales within one bf16 step.  The seeds include inputs where the
    int8 decode of both packages lies far (0.13-0.38 of scale) from the
    float decode: random weights give peaked scores, which the int8
    rounding of K moves; the port follows the reference there too."""
    jcfg, tcfg, jp, tp = _setup(arch)
    toks = np.random.default_rng(seed).integers(
        0, tcfg.vocab_size, size=(2, 17)).astype(np.int32)
    jcache, jstep, jfp, _, tstep = _prefill_both(arch, toks, 16)
    j8_cache = {"kv": _quantised(jcache["kv"], JT._quant_i8)}
    j8, j8_after = JM.decode_step(jp, _int8(jcfg), j8_cache, jstep,
                                  act_dtype=jnp.float32)
    t8_cache = {"kv": tuple(_to_torch(a) for a in j8_cache["kv"])}
    t8, t8_after = M.decode_step(tp, _int8(tcfg), t8_cache, tstep,
                                 act_dtype=torch.float32)
    scale = float(np.abs(jfp).max())
    assert float(np.abs(t8.numpy() - np.asarray(j8)).max()) \
        <= MODEL_TOL * scale
    after = [_to_torch(a) for a in j8_after["kv"]]
    for got, want in zip(t8_after["kv"][:2], after[:2]):
        assert (got.int() - want.int()).abs().max().item() <= 1
    for got, want in zip(t8_after["kv"][2:], after[2:]):
        torch.testing.assert_close(got.float(), want.float(), atol=0,
                                   rtol=2 ** -7)       # one bf16 step


def test_int8_kv_cache_close_to_fp():
    """The reference's test_perf_knobs.py::test_int8_kv_cache_close_to_fp
    on its own inputs (reduced qwen2.5-14b, weights from PRNGKey(0),
    tokens from PRNGKey(1)): the port's int8 decode step, on its own
    prefill cache quantised by its ``_quant_i8`` and on the JAX one, stays
    within 0.05 of the float decode's scale, as the reference's does."""
    jcfg, tcfg, jp, _ = _setup("qwen2.5-14b")
    s = 16
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, s + 1),
                                         0, jcfg.vocab_size), np.int32)
    jcache, jstep, jfp, tcache, tstep = _prefill_both("qwen2.5-14b", toks, s)
    _, _, _, tp = _setup("qwen2.5-14b")
    j8_cache = {"kv": _quantised(jcache["kv"], JT._quant_i8)}
    j8, _ = JM.decode_step(jp, _int8(jcfg), j8_cache, jstep,
                           act_dtype=jnp.float32)
    t8, _ = M.decode_step(tp, _int8(tcfg), {"kv": tuple(
        _to_torch(a) for a in j8_cache["kv"])}, tstep,
        act_dtype=torch.float32)
    own = {"kv": _quantised(tcache["kv"], T._quant_i8)}
    tfp, _ = M.decode_step(tp, tcfg, tcache, tstep, act_dtype=torch.float32)
    own8, _ = M.decode_step(tp, _int8(tcfg), own, tstep,
                            act_dtype=torch.float32)
    scale = float(np.abs(jfp).max())
    np.testing.assert_allclose(tfp.numpy(), jfp, atol=2e-4 * scale, rtol=0)
    for out in (np.asarray(j8), t8.numpy(), own8.numpy()):
        assert float(np.abs(out - jfp).max()) < QUANT_TOL * scale


def test_init_cache_int8_layout():
    _, tcfg, _, _ = _setup("qwen2.5-14b")
    cfg = _int8(tcfg)
    cache = M.init_cache(cfg, 3, 24, device="cpu")
    kv_shape = (cfg.num_layers, 3, 24, cfg.num_kv_heads, cfg.head_dim)
    assert [(tuple(t.shape), t.dtype) for t in cache["kv"]] == [
        (kv_shape, torch.int8), (kv_shape, torch.int8),
        (kv_shape[:-1], torch.bfloat16), (kv_shape[:-1], torch.bfloat16)]
    assert all(not t.any() for t in cache["kv"])
    shapes, axes = T.cache_struct(cfg, 3, 24)
    jshapes, jaxes = JT.cache_struct(_int8(jax_config("qwen2.5-14b")
                                           .reduced()), 3, 24)
    assert [s for s, _ in shapes["kv"]] == [s.shape for s in jshapes["kv"]]
    assert axes == jaxes


def test_int8_decode_multi_equals_sequential_decode_steps():
    """The fused window on an int8 cache equals sequential decode_step
    calls with the argmax between them, exactly."""
    _, tcfg, _, tp = _setup("chatglm-6b")
    cfg = _int8(tcfg)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(2, 16))
                              .astype(np.int32))
    lengths = torch.tensor([16, 11], dtype=torch.int32)
    logits, fcache = M.prefill(tp, tcfg, {"tokens": tokens,
                                          "lengths": lengths},
                               cache_len=32, act_dtype=torch.float32)
    cache = {"kv": _quantised(fcache["kv"], T._quant_i8)}
    seq_cache = {"kv": tuple(t.clone() for t in cache["kv"])}
    lg, pos, seq_toks = logits, lengths.clone(), []
    for _ in range(4):
        tok = torch.argmax(lg[:, :cfg.vocab_size], dim=-1).to(torch.int32)
        seq_toks.append(tok)
        lg, seq_cache = M.decode_step(tp, cfg, seq_cache,
                                      {"tokens": tok, "positions": pos},
                                      act_dtype=torch.float32)
        pos = pos + 1
    flg, fch, fpos, toks = M.decode_multi(
        tp, cfg, cache, {"logits": logits, "positions": lengths.clone()},
        num_steps=4, act_dtype=torch.float32)
    assert torch.equal(toks, torch.stack(seq_toks, dim=1))
    assert torch.equal(flg, lg) and torch.equal(fpos, pos)
    for a, b in zip(fch["kv"], seq_cache["kv"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("engine", [BatchEngine, ContinuousEngine])
def test_padded_engines_refuse_an_int8_cache(engine):
    _, tcfg, _, tp = _setup("chatglm-6b")
    with pytest.raises(NotImplementedError, match="int8"):
        engine(_int8(tcfg), tp, device="cpu")


def test_int8_wrapper_counts_plain_calls_and_kernel_refuses_cpu():
    ops.reset_counts()
    q, k, v, lengths = _kernel_inputs(16, 4, 2, 16)
    kq, ks = _q8(k)
    args = [torch.from_numpy(a) for a in (q, kq, kq, ks, ks, lengths)]
    ops.decode_attention_int8(*args)
    assert (ops.decode_attention_int8.launches,
            ops.decode_attention_int8.plain_calls) == (0, 1)
    assert ops.decode_attention_int8 in ops.KERNELS
    args[3] = args[4] = args[3].to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.decode_attention_int8_kernel(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 5e-2)])
def test_cuda_int8_kernel_matches_plain_version(dtype, tol):
    """The hand-written int8 kernel against its plain version on the
    card, then with poison past the lengths, which must change nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for s, hq, hkv, d in SHAPES:
        q, k, v, lengths = _kernel_inputs(s, hq, hkv, d)
        kq, ks = _q8(k)
        vq, vs = _q8(v)
        args = [torch.from_numpy(a).cuda() for a in (q, kq, vq, ks, vs,
                                                     lengths)]
        args[0] = args[0].to(dtype)
        args[3], args[4] = (a.to(torch.bfloat16) for a in args[3:5])
        n0 = ops.decode_attention_int8.launches
        out = ops.decode_attention_int8(*args)
        assert ops.decode_attention_int8.launches == n0 + 1
        want = ref.decode_attention_int8_ref(*args)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=0)
        for i, n in enumerate(lengths.tolist()):
            args[1][i, n:], args[2][i, n:] = 127, -128
            args[3][i, n:], args[4][i, n:] = float("nan"), float("inf")
        assert torch.equal(ops.decode_attention_int8(*args), out)
