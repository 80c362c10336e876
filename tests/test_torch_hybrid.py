"""The PyTorch port's hybrid family (hymba-1.5b, reduced: 2 layers, 4
query heads over 1 KV head of 64, 8 SSM heads of 32, d_state 16, chunk
32, a 64-token sliding window) on the padded path against the JAX
reference, at f32 on the CPU with the reference's weights carried
across by ``params_from_numpy``:

- the parameter tree: its specs against the reference's ``model_spec``
  (the SSM heads at half the SSM family's inner width), the carried
  weights equal, the decay parameters kept f32;
- ``prefill`` logits and all four cache leaves (K, V, the SSD state and
  the conv state) at 2e-4 of scale, at S = 40 (the window does not
  bind) and S = 96 (it does); ``decode_step`` after it, and
  ``decode_multi`` equal to sequential ``decode_step`` calls;
- the window's semantics, in both packages: prefill masks keys outside
  the window, decode on a cache longer than the window reads every
  cached key (so it differs from a prefill over S + 1 tokens), and on
  the ring of exactly the window it equals that prefill
  (``test_arch_smoke.py``'s ``test_decode_matches_forward``; the port
  has no ``forward_train``, so the full forward is a prefill);
- ``BatchEngine`` (prompts of 61-111 tokens: the window binds in the
  prefill), ``ContinuousEngine`` step by step, the launcher's batches
  and WMA, all equal to JAX's; ``magnus-paged`` refuses the family
  with the reference's reason in both packages.
"""
import dataclasses
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
from repro_torch.kernels.flash_attention import ops as flash_ops
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

ARCH = "hymba-1.5b"
TOL = 2e-4        # f32, of the reference's largest magnitude
FORWARD_TOL = 2e-3   # decode against the full forward (test_arch_smoke.py)
JCFG, CFG = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
WINDOW = CFG.sliding_window
RESULT_FIELDS = ("iterations", "batch_size", "batch_length", "wma",
                 "total_tokens", "valid_tokens")


@functools.lru_cache(maxsize=None)
def _params():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _err(got, want):
    """(max abs difference, the reference's largest magnitude, >= 1)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max(), max(1.0, np.abs(want).max())


def _close(got, want, tol=TOL):
    err, scale = _err(got, want)
    assert err <= tol * scale, (err, scale)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_param_specs_match_the_reference(reduced):
    """Every leaf's shape against the reference's ``model_spec`` (specs
    only: nothing is drawn at full width), the Mamba2 sub-layer at half
    the SSM family's inner width (hymba: 1,600, so 25 heads of 64)."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jspec = dict(_leaves(jax.tree.map(
        lambda s: s.shape, JT.model_spec(jcfg),
        is_leaf=lambda s: hasattr(s, "shape"))))
    tspec = {k: v[0] for k, v in _leaves(param_specs(tcfg))}
    assert tspec == jspec
    assert T.d_inner(tcfg) == tcfg.ssm.d_inner(tcfg.d_model) // 2
    n_heads = T.d_inner(tcfg) // tcfg.ssm.head_dim
    assert tspec["/blocks/mamba/A_log"] == (tcfg.num_layers, n_heads)
    if not reduced:
        assert n_heads == 25 and T.d_inner(tcfg) == 1600


def test_params_carried_across_and_decay_kept_f32():
    jp, tp = _params()
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert sorted(jl) == sorted(tl)
    assert {"/blocks/attn/wq", "/blocks/mamba/in_proj", "/blocks/mlp/gate",
            "/lm_head"} <= set(tl)
    for name, j in jl.items():
        np.testing.assert_array_equal(tl[name].numpy(), np.asarray(j))
    for tree in (params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu", dtype=torch.bfloat16),
                 init_params(CFG, generator=torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.bfloat16)):
        for name, t in _leaves(tree):
            keep = name.rsplit("/", 1)[1] in T.KEEP_F32
            assert t.dtype == (torch.float32 if keep else torch.bfloat16), \
                name


def test_cache_struct_matches_the_reference():
    """Both kinds of state in one cache: {"kv": (k, v)} in the
    activations' dtype and {"ssm": (state, conv)} in f32, with the
    reference's shapes and logical axes."""
    shapes, axes = T.cache_struct(CFG, 3, 99)
    jshapes, jaxes = JT.cache_struct(JCFG, 3, 99)
    assert set(shapes) == set(jshapes) == {"kv", "ssm"}
    for key in shapes:
        assert [s for s, _ in shapes[key]] == [j.shape for j in jshapes[key]]
    assert [dt for _, dt in shapes["ssm"]] == [torch.float32] * 2
    assert axes == jaxes
    cache = M.init_cache(CFG, 3, 99, dtype=torch.bfloat16, device="cpu")
    assert [t.dtype for t in cache["kv"]] == [torch.bfloat16] * 2
    assert [t.dtype for t in cache["ssm"]] == [torch.float32] * 2


# ---------------------------------------------------------------------------
# prefill and decode against JAX's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tokens(s):
    """[2, s + 1] ids, as test_arch_smoke.py draws them."""
    return np.array(jax.random.randint(jax.random.PRNGKey(1), (2, s + 1),
                                       0, JCFG.vocab_size), np.int32)


@functools.lru_cache(maxsize=None)
def _jax_prefill(s, lengths, cache_len):
    jp, _ = _params()
    logits, cache = JM.prefill(
        jp, JCFG, {"tokens": jnp.asarray(_tokens(s)[:, :s]),
                   "lengths": jnp.asarray(lengths, np.int32)},
        act_dtype=jnp.float32, cache_len=cache_len)
    return logits, cache


def _port_prefill(s, lengths, cache_len):
    _, tp = _params()
    return M.prefill(tp, CFG, {
        "tokens": torch.from_numpy(_tokens(s)[:, :s].copy()),
        "lengths": torch.tensor(lengths, dtype=torch.int32)},
        act_dtype=torch.float32, cache_len=cache_len)


@pytest.mark.parametrize("s", [40, 96], ids=["window_free", "window_binds"])
def test_prefill_matches_jax(s):
    """Logits and the four cache leaves at 2e-4 of scale; one flash
    call (in window mode) and one scan per layer."""
    lengths = (s, s - 7)
    flash_ops.reset_counts()
    scan_ops.reset_counts()
    tl, tc = _port_prefill(s, lengths, None)
    assert flash_ops.flash_attention.plain_calls == CFG.num_layers
    assert scan_ops.ssd_scan.plain_calls == CFG.num_layers
    jl, jc = _jax_prefill(s, lengths, None)
    _close(tl.numpy(), jl)
    assert set(tc) == {"kv", "ssm"}
    for key in ("kv", "ssm"):
        for j, t in zip(jc[key], tc[key]):
            _close(t.numpy(), j)
    assert [t.dtype for t in tc["ssm"]] == [torch.float32] * 2


def test_the_window_binds_in_the_prefill():
    """At S = 96 the window changes the logits of the longer row: the
    same prefill without a window differs (in both packages)."""
    jp, tp = _params()
    s, lengths = 96, (96, 89)
    want, _ = _jax_prefill(s, lengths, None)
    free = dataclasses.replace(CFG, sliding_window=None)
    jfree = dataclasses.replace(JCFG, sliding_window=None)
    batch = {"tokens": torch.from_numpy(_tokens(s)[:, :s].copy()),
             "lengths": torch.tensor(lengths, dtype=torch.int32)}
    tl, _ = M.prefill(tp, free, batch, act_dtype=torch.float32)
    jl, _ = JM.prefill(jp, jfree, {"tokens": jnp.asarray(_tokens(s)[:, :s]),
                                   "lengths": jnp.asarray(lengths)},
                       act_dtype=jnp.float32)
    _close(tl.numpy(), jl)
    err, scale = _err(jl, want)
    assert err > 0.01 * scale


def test_decode_step_matches_jax():
    """Three decode steps after a ragged prefill (cache 48), fed the same
    tokens: logits after each and all four leaves at the end."""
    jp, tp = _params()
    s, lengths = 40, (40, 33)
    _, jc = _jax_prefill(s, lengths, s + 8)
    _, tc = _port_prefill(s, lengths, s + 8)
    rng = np.random.default_rng(1)
    pos = np.array(lengths, np.int32)
    for _ in range(3):
        tok = rng.integers(3, CFG.vocab_size, size=2).astype(np.int32)
        jl, jc = JM.decode_step(jp, JCFG, jc, {"tokens": jnp.asarray(tok),
                                               "positions": jnp.asarray(pos)},
                                act_dtype=jnp.float32)
        tl, tc = M.decode_step(tp, CFG, tc, {
            "tokens": torch.from_numpy(tok),
            "positions": torch.from_numpy(pos.copy())},
            act_dtype=torch.float32)
        _close(tl.numpy(), jl)
        pos = pos + 1
    for key in ("kv", "ssm"):
        for j, t in zip(jc[key], tc[key]):
            _close(t.numpy(), j)


def test_decode_multi_equals_sequential_decode_steps():
    """The fused window equals sequential decode_step calls exactly,
    across a window split (5 = 4 + 1), on both kinds of state."""
    _, params = _params()
    s, lengths = 40, (40, 33)
    logits, cache = _port_prefill(s, lengths, s + 8)
    seq_cache = {k: tuple(c.clone() for c in v) for k, v in cache.items()}
    pos = torch.tensor(lengths, dtype=torch.int32)
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
                             "positions": torch.tensor(lengths,
                                                       dtype=torch.int32)},
        num_steps=4, act_dtype=torch.float32)
    flg, fch, fpos, t2 = M.decode_multi(
        params, CFG, fch, {"logits": flg, "positions": fpos}, num_steps=1,
        act_dtype=torch.float32)
    assert torch.equal(torch.cat([t1, t2], dim=1),
                       torch.stack(seq_toks, dim=1))
    assert torch.equal(flg, lg) and torch.equal(fpos, pos)
    for key in ("kv", "ssm"):
        for a, b in zip(fch[key], seq_cache[key]):
            assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _window_case(cache_len):
    """Prefill S = 96 tokens, one decode step at position S, and a
    prefill over the S + 1 tokens (the full forward), in both packages:
    (port decode, JAX decode, port full, JAX full)."""
    jp, tp = _params()
    s = 96
    toks = _tokens(s)
    _, jc = _jax_prefill(s, (s, s), cache_len)
    _, tc = _port_prefill(s, (s, s), cache_len)
    pos = np.full(2, s, np.int32)
    jd, _ = JM.decode_step(jp, JCFG, jc, {"tokens": jnp.asarray(toks[:, s]),
                                          "positions": jnp.asarray(pos)},
                           act_dtype=jnp.float32)
    td, _ = M.decode_step(tp, CFG, tc, {
        "tokens": torch.from_numpy(toks[:, s].copy()),
        "positions": torch.from_numpy(pos)}, act_dtype=torch.float32)
    jf, _ = JM.prefill(jp, JCFG, {"tokens": jnp.asarray(toks),
                                  "lengths": jnp.full(2, s + 1)},
                       act_dtype=jnp.float32)
    tf, _ = M.prefill(tp, CFG, {"tokens": torch.from_numpy(toks),
                                "lengths": torch.full((2,), s + 1)},
                      act_dtype=torch.float32)
    return td.numpy(), np.asarray(jd), tf.numpy(), np.asarray(jf)


@pytest.mark.parametrize("cache_len", [100, WINDOW],
                         ids=["engine_cache", "ring"])
def test_window_semantics_match_jax(cache_len):
    """Decode at position S = 96 against a prefill over S + 1 tokens.
    The port's decode and full forward equal JAX's in both cases.  On a
    cache longer than the window (the engines' caches) decode reads all
    96 cached keys while the prefill masks those 64 or more positions
    back, so the two differ in both packages, by a good share of the
    logits' scale; on the ring of exactly the window they agree, within
    test_arch_smoke.py's 2e-3."""
    td, jd, tf, jf = _window_case(cache_len)
    _close(td, jd)
    _close(tf, jf)
    err_port, scale = _err(td, tf)
    err_jax, _ = _err(jd, jf)
    if cache_len > WINDOW:
        assert err_port > 0.1 * scale and err_jax > 0.1 * scale, (
            err_port, err_jax, scale)
    else:
        assert err_port < FORWARD_TOL and err_jax < FORWARD_TOL, (
            err_port, err_jax)


def test_reduced_prefill_decode():
    """test_arch_smoke.py's prefill + decode for hymba, in the port's
    default bf16: shapes, no NaN."""
    params = M.init_params(CFG, seed=0, device="cpu")
    b, s = 2, 32
    toks = torch.randint(0, CFG.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    last, cache = M.prefill(params, CFG, {
        "tokens": toks, "lengths": torch.tensor([s, s - 5])},
        cache_len=s + 8)
    assert last.shape == (b, CFG.padded_vocab)
    logits, cache = M.decode_step(params, CFG, cache, {
        "tokens": torch.tensor([3, 4], dtype=torch.int32),
        "positions": torch.tensor([s, s - 5], dtype=torch.int32)})
    assert logits.shape == (b, CFG.padded_vocab)
    assert not torch.isnan(logits.float()).any()
    assert cache["kv"][0].dtype == torch.bfloat16
    assert cache["ssm"][0].dtype == torch.float32


# ---------------------------------------------------------------------------
# the engines and the launcher against JAX's
# ---------------------------------------------------------------------------

def _window_reqs(mod):
    """Four requests of 61-111 tokens (a batch bucket of 128: the window
    binds in the prefill, not in the decode on the engine's cache)."""
    reqs = [r for r in mod.make_dataset(2, seed=2) if r.length <= 128][:4]
    for i, r in enumerate(reqs):
        r.gen_length = 3 + (i * 3) % 10
    return reqs


def test_batch_engine_matches_jax():
    """One padded batch whose prefill runs in window mode: streams,
    counters, WMA and host syncs equal the JAX engine's; one flash and
    one scan call a layer."""
    jp, tp = _params()
    jreqs, treqs = _window_reqs(jax_apps), _window_reqs(apps)
    assert max(r.length for r in treqs) > WINDOW
    je = JaxBatchEngine(JCFG, params=jp, max_gen=12)
    te = BatchEngine(CFG, params=tp, max_gen=12, device="cpu")
    jres = je.serve_batch(JaxBatch(requests=jreqs))
    flash_ops.reset_counts()
    scan_ops.reset_counts()
    tres = te.serve_batch(Batch(requests=treqs))
    assert flash_ops.flash_attention.plain_calls == CFG.num_layers
    assert scan_ops.ssd_scan.plain_calls == CFG.num_layers
    assert tres.batch_length == 128
    for name in RESULT_FIELDS:
        assert getattr(tres, name) == getattr(jres, name), name
    assert [tres.generated[r.req_id] for r in treqs] == \
        [jres.generated[r.req_id] for r in jreqs]
    assert te.host_syncs == je.host_syncs == bin(tres.iterations).count("1")


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
    """Joins prefill up to 128 tokens (the window binds) and merge the KV
    and the recurrent state into their slot; streams and finish order
    equal the JAX engine's at every step."""
    jp, tp = _params()
    kw = dict(slots=2, max_len=128, max_gen=8)
    jtrace = _lockstep(JaxContinuousEngine(JCFG, params=jp, **kw),
                       _window_reqs(jax_apps)[:3])
    te = ContinuousEngine(CFG, params=tp, device="cpu", **kw)
    ttrace = _lockstep(te, _window_reqs(apps)[:3])
    assert len(ttrace) == len(jtrace)
    for step, (t, j) in enumerate(zip(ttrace, jtrace)):
        assert t == j, f"step {step}"
    assert te.host_syncs == len(ttrace)


def test_launcher_serves_hymba_as_jax():
    """``--arch hymba-1.5b --strategy magnus`` through the padded
    launcher: JAX's batches and WMA (every request is queued before the
    first batch forms, so neither depends on the engine's speed)."""
    _, tp = _params()
    jout = jax_serve.run_engine_backend(ARCH, 2.0, 3.0, "magnus")
    tout = serve.run_engine_backend(ARCH, 2.0, 3.0, "magnus", device="cpu",
                                    params=tp)
    for key in ("requests", "batches", "wma_total"):
        assert tout[key] == jout[key], key
    assert tout["requests"] > 0
    results = tout["results"]
    assert tout["host_syncs"] == sum(bin(r.iterations).count("1")
                                     for r in results)
    assert max(r.batch_length for r in results) > WINDOW


def test_paged_strategy_refuses_hymba_as_jax():
    """The reference has no paged layout for the family: both packages'
    paged engines refuse it with the same reason, and the padded cache's
    ring is not paged either."""
    with pytest.raises(NotImplementedError) as want:
        jax_serve.run_paged_engine_backend(ARCH, 2.0, 3.0, "magnus-paged")
    with pytest.raises(NotImplementedError) as got:
        serve.run_paged_engine_backend(ARCH, 2.0, 3.0, "magnus-paged",
                                       device="cpu")
    assert str(got.value) == str(want.value)
    assert "hybrid has no paged cache layout" in str(got.value)
    assert M.supports_paged(CFG) == JM.supports_paged(JCFG)
