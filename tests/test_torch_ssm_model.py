"""The PyTorch port's SSM family (mamba2-780m, reduced) on the padded
path against the JAX reference, at f32 on the CPU with the reference's
weights carried across by ``params_from_numpy``:

- the parameter tree (keys, shapes, the decay parameters kept f32);
- ``prefill`` logits and both recurrent-state leaves, and three
  ``decode_step`` calls after it, at 2e-4 of each tensor's scale (the
  scan runs the reference model's own chunked algorithm on the CPU);
- the fused ``decode_multi`` against sequential ``decode_step`` calls,
  exactly;
- ``BatchEngine`` streams and counters, ``run_engine_backend``'s batches
  and ``ContinuousEngine`` streams, identical to the JAX package's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.types import Batch as JaxBatch
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving.engine import BatchEngine as JaxBatchEngine
from repro.serving.engine import ContinuousEngine as JaxContinuousEngine
from repro.workload import apps as jax_apps
from repro_torch.configs import get_config
from repro_torch.core.types import Batch
from repro_torch.kernels.ssd_scan import ops as scan_ops
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import init_params, param_specs, params_from_numpy
from repro_torch.serving.engine import BatchEngine, ContinuousEngine
from repro_torch.workload import apps

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

ARCH = "mamba2-780m"
TOL = 2e-4        # f32, relative to each tensor's scale (see _allclose)
JCFG, CFG = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
RESULT_FIELDS = ("iterations", "batch_size", "batch_length", "wma",
                 "total_tokens", "valid_tokens")


@functools.lru_cache(maxsize=None)
def _params():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _allclose(a, b):
    """Max abs difference within TOL of the reference's largest magnitude
    (at least 1): the SSD state of the reference's random weights reaches
    ~1e5, the logits a few units."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= TOL * max(1.0, np.abs(b).max()), (err, np.abs(b).max())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_params_carried_across():
    jp, tp = _params()
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert sorted(jl) == sorted(tl)
    assert "/lm_head" not in tl and "/blocks/mamba/in_proj" in tl
    for name, j in jl.items():
        np.testing.assert_array_equal(tl[name].numpy(), np.asarray(j))
    bf16 = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=torch.bfloat16)
    for name, t in _leaves(bf16):
        keep = name.rsplit("/", 1)[1] in T.KEEP_F32
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), name


@pytest.mark.parametrize("reduced", [True, False])
def test_param_specs_match_the_reference(reduced):
    """Shapes of every leaf against the reference's ``model_spec``, at the
    reduced and the full width (specs only: nothing is drawn)."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jspec = dict(_leaves(jax.tree.map(
        lambda s: s.shape, JT.model_spec(jcfg),
        is_leaf=lambda s: hasattr(s, "shape"))))
    tspec = {k: v[0] for k, v in _leaves(param_specs(tcfg))}
    assert tspec == jspec


def test_init_params_keeps_decay_parameters_f32():
    p = init_params(CFG, generator=torch.Generator().manual_seed(0),
                    device="cpu", dtype=torch.bfloat16)
    m = p["blocks"]["mamba"]
    decay = ("A_log", "D", "dt_bias")     # KEEP_F32 also holds the router
    assert set(decay) <= T.KEEP_F32
    assert {k: m[k].dtype for k in decay} == {
        k: torch.float32 for k in decay}
    assert m["in_proj"].dtype == torch.bfloat16
    assert torch.equal(m["A_log"], torch.ones_like(m["A_log"]))
    cast = T.cast_params(p, torch.bfloat16)["blocks"]["mamba"]
    assert cast["dt_bias"].dtype == torch.float32


def _prompts(b=3, s=40, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, CFG.vocab_size, size=(b, s)).astype(np.int32)
    lengths = np.array([s, max(1, 3 * s // 8), 3][:b], np.int32)
    return tokens, lengths


def _both_prefill(s):
    jp, tp = _params()
    tokens, lengths = _prompts(s=s)
    jl, jc = JM.prefill(jp, JCFG, {"tokens": jnp.asarray(tokens),
                                   "lengths": jnp.asarray(lengths)},
                        act_dtype=jnp.float32, cache_len=s + 8)
    tl, tc = M.prefill(tp, CFG, {"tokens": torch.from_numpy(tokens),
                                 "lengths": torch.from_numpy(lengths)},
                       act_dtype=torch.float32, cache_len=s + 8)
    return (jl, jc), (tl, tc), lengths


# S: a multiple of the reduced chunk (32), a ragged one, one below it
@pytest.mark.parametrize("s", [64, 40, 8])
def test_prefill_matches_jax(s):
    scan_ops.reset_counts()
    (jl, jc), (tl, tc), _ = _both_prefill(s)
    assert scan_ops.ssd_scan.plain_calls == CFG.num_layers
    _allclose(tl.numpy(), jl)
    assert set(tc) == {"ssm"}
    for j, t in zip(jc["ssm"], tc["ssm"]):
        assert t.dtype == torch.float32
        _allclose(t.numpy(), j)


def test_decode_step_matches_jax():
    """Three decode steps after the prefill, fed the same tokens: logits
    and both state leaves match."""
    jp, tp = _params()
    (_, jc), (_, tc), lengths = _both_prefill(40)
    rng = np.random.default_rng(1)
    pos = lengths.copy()
    for _ in range(3):
        tok = rng.integers(3, CFG.vocab_size, size=len(pos)).astype(np.int32)
        jl, jc = JM.decode_step(jp, JCFG, jc, {"tokens": jnp.asarray(tok),
                                               "positions": jnp.asarray(pos)},
                                act_dtype=jnp.float32)
        tl, tc = M.decode_step(tp, CFG, tc, {"tokens": torch.from_numpy(tok),
                                             "positions": torch.from_numpy(
                                                 pos.copy())},
                               act_dtype=torch.float32)
        _allclose(tl.numpy(), jl)
        pos = pos + 1
    for j, t in zip(jc["ssm"], tc["ssm"]):
        _allclose(t.numpy(), j)


def test_cache_struct_and_init_cache_match_the_reference():
    shapes, axes = T.cache_struct(CFG, 3, 99)
    jshapes, jaxes = JT.cache_struct(JCFG, 3, 99)
    assert [(s, dt) for s, dt in shapes["ssm"]] == [
        (j.shape, torch.float32) for j in jshapes["ssm"]]
    assert axes == jaxes
    cache = M.init_cache(CFG, 3, 99, dtype=torch.bfloat16, device="cpu")
    assert [t.dtype for t in cache["ssm"]] == [torch.float32] * 2


def test_decode_multi_equals_sequential_decode_steps():
    """The fused decode window equals sequential decode_step calls with
    the argmax between them, exactly, across a window split (5 = 4 + 1)."""
    _, params = _params()
    tokens, lengths = _prompts(b=2, s=16)
    lengths = np.array([11, 16], np.int32)
    batch = {"tokens": torch.from_numpy(tokens),
             "lengths": torch.from_numpy(lengths)}
    logits, cache = M.prefill(params, CFG, batch, act_dtype=torch.float32)
    seq_cache = {"ssm": tuple(c.clone() for c in cache["ssm"])}
    pos = torch.from_numpy(lengths.copy())
    lg, seq_toks = logits, []
    for _ in range(5):
        tok = torch.argmax(lg[:, :CFG.vocab_size], dim=-1).to(torch.int32)
        seq_toks.append(tok)
        lg, seq_cache = M.decode_step(params, CFG, seq_cache,
                                      {"tokens": tok, "positions": pos},
                                      act_dtype=torch.float32)
        pos = pos + 1
    flg, fch, fpos, t1 = M.decode_multi(
        params, CFG, cache, {"logits": logits,
                             "positions": torch.from_numpy(lengths.copy())},
        num_steps=4, act_dtype=torch.float32)
    flg, fch, fpos, t2 = M.decode_multi(
        params, CFG, fch, {"logits": flg, "positions": fpos}, num_steps=1,
        act_dtype=torch.float32)
    assert torch.equal(torch.cat([t1, t2], dim=1),
                       torch.stack(seq_toks, dim=1))
    assert torch.equal(flg, lg) and torch.equal(fpos, pos)
    for a, b in zip(fch["ssm"], seq_cache["ssm"]):
        assert torch.equal(a, b)


def _reqs(mod, n, max_gen=10, seed=0):
    reqs = mod.make_dataset(2, seed=seed)[:n]
    for i, r in enumerate(reqs):
        r.gen_length = 3 + (i * 3) % max_gen
    return reqs


@pytest.mark.parametrize("n,seed,max_gen", [(4, 0, 16), (3, 4, 12)])
def test_batch_engine_matches_jax(n, seed, max_gen):
    """Same batch, same weights: identical streams, counters and host
    syncs (one readback per power-of-two window); one scan launch per
    layer of the prefill, none in the decode."""
    jp, tp = _params()
    jreqs, treqs = _reqs(jax_apps, n, seed=seed), _reqs(apps, n, seed=seed)
    je = JaxBatchEngine(JCFG, params=jp, max_gen=max_gen)
    te = BatchEngine(CFG, params=tp, max_gen=max_gen, device="cpu")
    jres = je.serve_batch(JaxBatch(requests=jreqs))
    scan_ops.reset_counts()
    tres = te.serve_batch(Batch(requests=treqs))
    assert scan_ops.ssd_scan.plain_calls == CFG.num_layers
    for name in RESULT_FIELDS:
        assert getattr(tres, name) == getattr(jres, name), name
    assert [tres.generated[r.req_id] for r in treqs] == \
        [jres.generated[r.req_id] for r in jreqs]
    assert te.host_syncs == je.host_syncs == bin(tres.iterations).count("1")


def test_run_engine_backend_matches_jax():
    """mamba2-780m through the padded launcher: the same batches and WMA
    as the JAX launcher (every request is queued before the first batch
    forms, so they do not depend on the engine's speed)."""
    jout = jax_serve.run_engine_backend(ARCH, 3.0, 4.0, "magnus")
    tout = serve.run_engine_backend(ARCH, 3.0, 4.0, "magnus", device="cpu")
    for key in ("requests", "batches", "wma_total"):
        assert tout[key] == jout[key], key
    assert tout["requests"] > 0
    results = tout["results"]
    assert tout["host_syncs"] == sum(bin(r.iterations).count("1")
                                     for r in results)
    assert sum(len(g) for r in results for g in r.generated.values()) == \
        sum(r.valid_tokens for r in results)


def _lockstep(engine, reqs):
    """Join while there is room, step, repeat; one (finished indices,
    per-slot generated tokens) record per step."""
    index = {r.req_id: i for i, r in enumerate(reqs)}
    queue, trace = list(reqs), []
    while queue or any(engine.active):
        while queue and engine.has_capacity:
            engine.join(queue.pop(0))
        finished = engine.step()
        trace.append(([index[r.req_id] for r in finished],
                      [None if a is None else list(a["generated"])
                       for a in engine.active]))
    return trace


def test_continuous_engine_matches_jax_step_by_step():
    """Joins merge each single-request state into its slot whole; the
    streams and the finish order equal the JAX engine's at every step."""
    jp, tp = _params()
    kw = dict(slots=3, max_len=128, max_gen=8)
    jtrace = _lockstep(JaxContinuousEngine(JCFG, params=jp, **kw),
                       _reqs(jax_apps, 5, seed=2))
    te = ContinuousEngine(CFG, params=tp, device="cpu", **kw)
    ttrace = _lockstep(te, _reqs(apps, 5, seed=2))
    assert len(ttrace) == len(jtrace)
    for step, (t, j) in enumerate(zip(ttrace, jtrace)):
        assert t == j, f"step {step}"
    assert te.host_syncs == len(ttrace)
