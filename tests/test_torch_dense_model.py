"""The PyTorch port's dense model (the padded-batch path) against the JAX
reference, at f32 on reduced configs with the reference's weights carried
across by ``params_from_numpy``: ``prefill`` logits and caches (padded,
and ring-packed for a sliding-window model), ``decode_step`` logits and
caches, and, in the port itself, the fused ``decode_multi`` against
sequential ``decode_step`` calls.  Configs: chatglm-6b (MHA) and
qwen2.5-14b (GQA, QKV bias), reduced (the MoE family has its own file,
``test_torch_moe.py``).  Families the port does not cover yet raise,
a ``decode_cp`` config decodes on one device as the reference's does,
and the padded engines refuse an int8 cache (the SSM family and the int8 decode path have their own test
files)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import (BatchEngine, ContinuousEngine,
                                        PagedContinuousEngine)

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

TOL = 2e-4     # f32, relative to each tensor's scale (see _allclose)
ARCHS = ("chatglm-6b", "qwen2.5-14b")


@functools.lru_cache(maxsize=None)
def _setup(arch, window=None):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    if window is not None:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _allclose(a, b):
    """Max abs difference within TOL of the reference's largest magnitude
    (at least 1): the reference's random weights drive activations and
    K/V to tens, so an elementwise 2e-4 would be far tighter than f32
    allows there."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= TOL * max(1.0, np.abs(b).max()), (err, np.abs(b).max())


def _prompts(cfg, b=3, s=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, cfg.vocab_size, size=(b, s)).astype(np.int32)
    lengths = np.array([s, 9, 1][:b], np.int32)
    return tokens, lengths


def _both_prefill(arch, cache_len, window=None):
    jcfg, tcfg, jp, tp = _setup(arch, window)
    tokens, lengths = _prompts(tcfg)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens),
                                   "lengths": jnp.asarray(lengths)},
                        act_dtype=jnp.float32, cache_len=cache_len)
    tl, tc = M.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens),
                                  "lengths": torch.from_numpy(lengths)},
                       act_dtype=torch.float32, cache_len=cache_len)
    return (jl, jc), (tl, tc), lengths


CASES = {"pad": (40, None), "exact": (16, None), "ring": (8, 8)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, case):
    cache_len, window = CASES[case]
    (jl, jc), (tl, tc), _ = _both_prefill(arch, cache_len, window)
    _allclose(tl.numpy(), jl)
    for j, t in zip(jc["kv"], tc["kv"]):
        assert t.shape[2] == cache_len
        _allclose(t.numpy(), j)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, case):
    """Three decode steps after the prefill, fed the same tokens: logits
    and the whole cache (ring slots included) match."""
    cache_len, window = CASES[case]
    jcfg, tcfg, jp, tp = _setup(arch, window)
    (_, jc), (_, tc), lengths = _both_prefill(arch, cache_len, window)
    rng = np.random.default_rng(1)
    pos = lengths.copy()
    for _ in range(3):
        tok = rng.integers(3, tcfg.vocab_size, size=len(pos)).astype(
            np.int32)
        jl, jc = JM.decode_step(jp, jcfg, jc, {"tokens": jnp.asarray(tok),
                                               "positions": jnp.asarray(pos)},
                                act_dtype=jnp.float32)
        tl, tc = M.decode_step(tp, tcfg, tc,
                               {"tokens": torch.from_numpy(tok),
                                "positions": torch.from_numpy(pos.copy())},
                               act_dtype=torch.float32)
        _allclose(tl.numpy(), jl)
        pos = pos + 1
    for j, t in zip(jc["kv"], tc["kv"]):
        _allclose(t.numpy(), j)


def test_jax_cache_crosses_over_as_it_is():
    """A JAX dense cache carried by params_from_numpy decodes in the port
    as the port's own prefill cache does."""
    jcfg, tcfg, jp, tp = _setup("chatglm-6b")
    (jl, jc), (tl, tc), lengths = _both_prefill("chatglm-6b", 40)
    carried = params_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    assert isinstance(carried["kv"], tuple)
    batch = {"tokens": torch.tensor([5, 6, 7], dtype=torch.int32),
             "positions": torch.from_numpy(lengths.copy())}
    a, _ = M.decode_step(tp, tcfg, carried, batch, act_dtype=torch.float32)
    b, _ = M.decode_step(tp, tcfg, tc, batch, act_dtype=torch.float32)
    _allclose(a.numpy(), b.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_multi_equals_sequential_decode_steps(arch):
    """Dense fused decode (the BatchEngine inner loop) equals sequential
    decode_step calls with the argmax between them, exactly, across a
    window split (5 = 4 + 1); the reference's
    test_decode_multi_dense_bitexact_vs_sequential."""
    _, cfg, _, params = _setup(arch)
    tokens, lengths = _prompts(cfg, b=2)
    lengths = np.array([11, 16], np.int32)
    batch = {"tokens": torch.from_numpy(tokens),
             "lengths": torch.from_numpy(lengths)}
    logits, cache = M.prefill(params, cfg, batch, act_dtype=torch.float32,
                              cache_len=64)
    seq_cache = {"kv": tuple(c.clone() for c in cache["kv"])}
    pos = torch.from_numpy(lengths.copy())
    lg, seq_toks = logits, []
    for _ in range(5):
        tok = torch.argmax(lg[:, :cfg.vocab_size], dim=-1).to(torch.int32)
        seq_toks.append(tok)
        lg, seq_cache = M.decode_step(params, cfg, seq_cache,
                                      {"tokens": tok, "positions": pos},
                                      act_dtype=torch.float32)
        pos = pos + 1
    flg, fch, fpos, t1 = M.decode_multi(
        params, cfg, cache, {"logits": logits,
                             "positions": torch.from_numpy(lengths.copy())},
        num_steps=4, act_dtype=torch.float32)
    flg, fch, fpos, t2 = M.decode_multi(
        params, cfg, fch, {"logits": flg, "positions": fpos}, num_steps=1,
        act_dtype=torch.float32)
    assert torch.equal(torch.cat([t1, t2], dim=1),
                       torch.stack(seq_toks, dim=1))
    assert torch.equal(flg, lg)
    assert torch.equal(fpos, pos)
    for a, b in zip(fch["kv"], seq_cache["kv"]):
        assert torch.equal(a, b)


UNSUPPORTED = ("deepseek-v3-671b", "internvl2-26b", "whisper-large-v3")


@pytest.mark.parametrize("arch", UNSUPPORTED)
def test_unported_families_raise(arch):
    """The MLA (deepseek-v3), vlm (internvl2) and encoder-decoder
    (whisper) families have a dense cache in the port
    (``tests/test_torch_mla.py``, ``tests/test_torch_vlm.py``,
    ``tests/test_torch_encdec.py``) but, as in the reference, no paged
    cache: their paged entry points raise, the encoder-decoder family's
    engine with the reference's words."""
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="paged"):
        M.init_paged_cache(cfg, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="paged") as err:
        PagedContinuousEngine(cfg, device="cpu")
    if cfg.family == "audio":
        assert str(err.value) == (f"{cfg.name}: enc-dec cross-KV caches "
                                  f"are not paged")


@pytest.mark.parametrize("flag", ["cache_int8", "decode_cp"])
def test_int8_and_context_parallel_caches_raise(flag):
    """An int8 cache decodes (tests/test_torch_int8_decode.py), but the
    padded engines refuse it, as the reference's cannot serve one
    either.  A ``decode_cp`` config on one device (no mesh in the rules)
    decodes as the reference's does, through plain decode attention:
    ``decode_step`` on a seeded [1, 8] cache at position 5 gives the
    reference's logits and cache at 2e-4 of scale, and the flag-off
    port's bit for bit (the context-parallel branch is
    tests/test_torch_decode_cp.py's)."""
    jcfg, cfg, jp, params = _setup("chatglm-6b")
    cfg = dataclasses.replace(cfg, **{flag: True})
    if flag == "cache_int8":
        with pytest.raises(NotImplementedError, match="cannot serve an int8"):
            ContinuousEngine(cfg, params, device="cpu")
        return
    jcfg = dataclasses.replace(jcfg, decode_cp=True)
    rng = np.random.default_rng(0)
    kv = tuple(rng.standard_normal((cfg.num_layers, 1, 8, cfg.num_kv_heads,
                                    cfg.head_dim)).astype(np.float32)
               for _ in range(2))
    batch = {"tokens": np.array([7], np.int32),
             "positions": np.array([5], np.int32)}
    jl, jc = JM.decode_step(jp, jcfg, {"kv": tuple(map(jnp.asarray, kv))},
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            act_dtype=jnp.float32)
    outs = []
    for c in (cfg, dataclasses.replace(cfg, decode_cp=False)):
        cache = {"kv": tuple(torch.from_numpy(a.copy()) for a in kv)}
        logits, cache = M.decode_step(
            params, c, cache, {k: torch.from_numpy(v.copy())
                               for k, v in batch.items()},
            act_dtype=torch.float32)
        outs.append((logits, cache))
    (tl, tc), (off_l, off_c) = outs
    _allclose(tl.numpy(), jl)
    for got, want in zip(tc["kv"], jc["kv"]):
        _allclose(got.numpy(), want)
    assert torch.equal(tl, off_l)
    assert all(torch.equal(a, b) for a, b in zip(tc["kv"], off_c["kv"]))
