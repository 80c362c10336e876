"""The PyTorch port's vlm family (internvl2-26b, reduced: 2 layers,
d_model 256, 4 query heads over 1 KV head of 64, 8 patches) on the
padded path against the JAX reference, at f32 on the CPU with the
reference's weights carried across by ``params_from_numpy``:

- the parameter tree: its specs against the reference's ``model_spec``
  (the patch ``projector [d, d]``), the carried weights equal;
- ``prefill`` with zero patches and with random ones: ``patches @
  projector`` in front of the prompt, the cache holding the patch prefix,
  a row's logits at ``P + lengths - 1`` (2e-4 of scale); the patches
  change the logits; ``decode_step``'s text-relative positions with the
  patch offset added; ``test_arch_smoke.py``'s prefill/decode tests (the
  full forward is a prefill over S + 1 tokens);
- ``BatchEngine`` (its cache sized ``_bucket(bl + bg + P)``, one flash
  call a layer at S = P + bl), ``ContinuousEngine`` step by step, both
  with zero patches, and the padded launcher's batches and WMA equal
  JAX's; the ContinuousEngine's cache is sized without the patches in
  both packages, so a join whose patches and prompt bucket exceed it is
  ring-packed and its decode no longer reads the first patches; a paged
  strategy refuses the family with the reference's reason.
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
from repro.serving.engine import PagedContinuousEngine as JaxPagedEngine
from repro.workload import apps as jax_apps
from repro_torch.configs import get_config
from repro_torch.core.types import Batch
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.params import param_specs, params_from_numpy
from repro_torch.serving.engine import BatchEngine, ContinuousEngine, _bucket
from repro_torch.workload import apps
from repro_torch.workload.tokenizer import encode

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

ARCH = "internvl2-26b"
TOL = 2e-4           # f32, of the reference's largest magnitude
FORWARD_TOL = 2e-3   # decode against the full forward (test_arch_smoke.py)
JCFG, CFG = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
P = CFG.num_patches
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


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_param_specs_match_the_reference(reduced):
    """Every leaf's shape against the reference's ``model_spec``, the
    projector among them (specs only at full width)."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jspec = dict(_leaves(jax.tree.map(
        lambda s: s.shape, JT.model_spec(jcfg),
        is_leaf=lambda s: hasattr(s, "shape"))))
    tspec = {k: v[0] for k, v in _leaves(param_specs(tcfg))}
    assert tspec == jspec
    assert tspec["/projector"] == (tcfg.d_model, tcfg.d_model)
    if not reduced:
        assert tspec["/blocks/attn/wq"] == (48, 6144, 48, 128)
        assert tspec["/blocks/attn/wk"] == (48, 6144, 8, 128)


def test_params_carried_across():
    jp, tp = _params()
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert sorted(jl) == sorted(tl) and "/projector" in tl
    for name, j in jl.items():
        np.testing.assert_array_equal(tl[name].numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# prefill and decode against JAX's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tokens(s):
    """[2, s + 1] ids, as test_arch_smoke.py draws them."""
    return np.array(jax.random.randint(jax.random.PRNGKey(1), (2, s + 1),
                                       0, JCFG.vocab_size), np.int32)


def _patches(kind, b=2):
    if kind == "zero":
        return np.zeros((b, P, CFG.d_model), np.float32)
    return np.random.default_rng(7).standard_normal(
        (b, P, CFG.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_prefill(kind, s, lengths, cache_len):
    jp, _ = _params()
    return JM.prefill(jp, JCFG, {
        "tokens": jnp.asarray(_tokens(s)[:, :s]),
        "lengths": jnp.asarray(lengths, np.int32),
        "patches": jnp.asarray(_patches(kind))},
        act_dtype=jnp.float32, cache_len=cache_len)


def _port_prefill(kind, s, lengths, cache_len):
    _, tp = _params()
    return M.prefill(tp, CFG, {
        "tokens": torch.from_numpy(_tokens(s)[:, :s].copy()),
        "lengths": torch.tensor(lengths, dtype=torch.int32),
        "patches": torch.from_numpy(_patches(kind))},
        act_dtype=torch.float32, cache_len=cache_len)


@pytest.mark.parametrize("kind", ["zero", "random"])
def test_prefill_matches_jax(kind):
    """Logits and the K/V cache over P + S = 8 + 24 positions (grown to
    40) at 2e-4 of scale; one flash call a layer at S = P + 24."""
    s, lengths = 24, (24, 17)
    flash_ops.reset_counts()
    tl, tc = _port_prefill(kind, s, lengths, P + s + 8)
    assert flash_ops.flash_attention.plain_calls == CFG.num_layers
    jl, jc = _jax_prefill(kind, s, lengths, P + s + 8)
    _close(tl.numpy(), jl)
    for got, want in zip(tc["kv"], jc["kv"]):
        assert got.shape[2] == P + s + 8
        _close(got.numpy(), want)


def test_patches_change_the_prefill():
    """Zero and random patches give other logits (the prefix is attended)
    in both packages, and the port refuses a vlm prefill without
    patches (the reference would pick its logits past the prompt)."""
    s, lengths = 24, (24, 17)
    zero, _ = _port_prefill("zero", s, lengths, None)
    rand, _ = _port_prefill("random", s, lengths, None)
    err, scale = _err(zero.numpy(), rand.numpy())
    assert err > 0.01 * scale
    jzero, _ = _jax_prefill("zero", s, lengths, None)
    jrand, _ = _jax_prefill("random", s, lengths, None)
    _close(zero.numpy(), jzero)
    _close(rand.numpy(), jrand)
    _, tp = _params()
    with pytest.raises(ValueError, match="patches"):
        M.prefill(tp, CFG, {"tokens": torch.zeros(2, 8, dtype=torch.int32),
                            "lengths": torch.tensor([8, 8])},
                  act_dtype=torch.float32)


def test_decode_step_adds_the_patch_offset():
    """Three decode steps at text-relative positions after a prefill with
    random patches (cache 40): logits after each and the K/V at the end
    equal JAX's; each step writes slot ``P + position``; decoding at the
    offset already added (as a text-only model would) gives other
    logits."""
    jp, tp = _params()
    s, lengths = 24, (24, 17)
    _, jc = _jax_prefill("random", s, lengths, P + s + 8)
    _, tc = _port_prefill("random", s, lengths, P + s + 8)
    rng = np.random.default_rng(1)
    pos = np.array(lengths, np.int32)
    for step in range(3):
        tok = rng.integers(3, CFG.vocab_size, size=2).astype(np.int32)
        before = tc["kv"][0][0].clone()
        if step == 0:
            twin = {"kv": tuple(t.clone() for t in tc["kv"])}
            shifted, _ = M.decode_step(tp, CFG, twin, {
                "tokens": torch.from_numpy(tok),
                "positions": torch.from_numpy(pos + P)},
                act_dtype=torch.float32)
        jl, jc = JM.decode_step(jp, JCFG, jc, {"tokens": jnp.asarray(tok),
                                               "positions": jnp.asarray(pos)},
                                act_dtype=jnp.float32)
        tl, tc = M.decode_step(tp, CFG, tc, {
            "tokens": torch.from_numpy(tok),
            "positions": torch.from_numpy(pos.copy())},
            act_dtype=torch.float32)
        _close(tl.numpy(), jl)
        changed = (tc["kv"][0][0] != before).any(-1).any(-1)
        assert changed.nonzero()[:, 1].tolist() == (pos + P).tolist()
        if step == 0:
            err, scale = _err(shifted.numpy(), tl.numpy())
            assert err > 0.01 * scale
        pos = pos + 1
    for got, want in zip(tc["kv"], jc["kv"]):
        _close(got.numpy(), want)


def test_reduced_prefill_decode():
    """test_arch_smoke.py's prefill + decode for internvl2 (cache s + 8
    + P), in the port's default bf16: shapes, no NaN."""
    params = M.init_params(CFG, seed=0, device="cpu")
    b, s = 2, 32
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, CFG.vocab_size, (b, s), generator=gen,
                         dtype=torch.int32)
    patches = torch.randn(b, P, CFG.d_model, generator=gen).to(
        torch.bfloat16)
    last, cache = M.prefill(params, CFG, {
        "tokens": toks, "lengths": torch.tensor([s, s - 5]),
        "patches": patches}, cache_len=s + 8 + P)
    assert last.shape == (b, CFG.padded_vocab)
    logits, cache = M.decode_step(params, CFG, cache, {
        "tokens": torch.tensor([3, 4], dtype=torch.int32),
        "positions": torch.tensor([s, s - 5], dtype=torch.int32)})
    assert logits.shape == (b, CFG.padded_vocab)
    assert not torch.isnan(logits.float()).any()


def test_decode_matches_forward():
    """test_arch_smoke.py's cache invariant for internvl2 with random
    patches: decode at text position S equals the full forward over P +
    S + 1 positions (here a prefill over them), within its 2e-3; and
    both sides equal JAX's."""
    jp, tp = _params()
    b, s = 2, 32
    toks = _tokens(s)
    t = torch.from_numpy
    patches = _patches("random")
    full, _ = M.prefill(tp, CFG, {"tokens": t(toks), "patches": t(patches),
                                  "lengths": torch.full((b,), s + 1)},
                        act_dtype=torch.float32)
    _, cache = M.prefill(tp, CFG, {"tokens": t(toks[:, :s].copy()),
                                   "patches": t(patches),
                                   "lengths": torch.full((b,), s)},
                         cache_len=s + 4 + P, act_dtype=torch.float32)
    dec, _ = M.decode_step(tp, CFG, cache, {
        "tokens": t(toks[:, s].copy()),
        "positions": torch.full((b,), s, dtype=torch.int32)},
        act_dtype=torch.float32)
    assert (full - dec).abs().max().item() < FORWARD_TOL
    jfull, _ = JM.prefill(jp, JCFG, {"tokens": toks, "patches": patches,
                                     "lengths": np.full(b, s + 1)},
                          act_dtype=jnp.float32)
    _close(full, jfull)
    _close(dec, jfull, tol=FORWARD_TOL)


# ---------------------------------------------------------------------------
# the engines and the launcher against JAX's
# ---------------------------------------------------------------------------

def _reqs(mod, n=4):
    reqs = mod.make_dataset(2, seed=0)[:n]
    for i, r in enumerate(reqs):
        r.gen_length = 3 + (i * 3) % 10
    return reqs


def test_batch_engine_matches_jax(monkeypatch):
    """One padded batch with zero patches: streams, G(B) iterations, WMA
    and host syncs equal the JAX engine's; the cache holds
    ``_bucket(bl + bg + P)`` slots; one flash call a layer over P + bl
    positions and one decode call a layer and step."""
    jp, tp = _params()
    je = JaxBatchEngine(JCFG, params=jp, max_gen=12)
    te = BatchEngine(CFG, params=tp, max_gen=12, device="cpu")
    jreqs, treqs = _reqs(jax_apps), _reqs(apps)
    jres = je.serve_batch(JaxBatch(requests=jreqs))
    seen = []
    prefill = M.prefill

    def spy(params, cfg, batch, **kw):
        seen.append((tuple(batch["patches"].shape),
                     int(batch["patches"].abs().sum()), kw["cache_len"]))
        return prefill(params, cfg, batch, **kw)

    monkeypatch.setattr(M, "prefill", spy)
    flash_ops.reset_counts()
    decode_ops.reset_counts()
    tres = te.serve_batch(Batch(requests=treqs))
    for name in RESULT_FIELDS:
        assert getattr(tres, name) == getattr(jres, name), name
    assert [tres.generated[r.req_id] for r in treqs] == \
        [jres.generated[r.req_id] for r in jreqs]
    assert te.host_syncs == je.host_syncs == bin(tres.iterations).count("1")
    bl, bg = tres.batch_length, tres.iterations
    assert seen == [((4, P, CFG.d_model), 0, _bucket(bl + bg + P))]
    assert flash_ops.flash_attention.plain_calls == CFG.num_layers
    assert decode_ops.decode_attention.plain_calls == CFG.num_layers * bg


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


@pytest.mark.parametrize("max_len,max_gen", [(64, 32), (16, 4)],
                         ids=["room", "ring"])
def test_continuous_engine_matches_jax_step_by_step(max_len, max_gen):
    """Joins with zero patches; streams and finish order equal the JAX
    engine's at every step.  The prompts (230-440 tokens) are cut to
    ``max_len`` ids.  With room, 64 ids and the 8 patches (72 positions)
    and up to 12 generated tokens fit the 96 slots.  On the ring, 16 ids
    and the patches (24 positions) overflow the 20 slots, which the
    reference sizes without the patches: the prefill is ring-packed (the
    first 4 patches dropped) and each decode step overwrites the oldest
    slot."""
    jp, tp = _params()
    kw = dict(slots=2, max_len=max_len, max_gen=max_gen)
    jtrace = _lockstep(JaxContinuousEngine(JCFG, params=jp, **kw),
                       _reqs(jax_apps, 3))
    te = ContinuousEngine(CFG, params=tp, device="cpu", **kw)
    ttrace = _lockstep(te, _reqs(apps, 3))
    assert len(ttrace) == len(jtrace)
    for step, (t, j) in enumerate(zip(ttrace, jtrace)):
        assert t == j, f"step {step}"
    assert te.cache["kv"][0].shape[2] == max_len + max_gen


def test_continuous_engine_ring_drops_the_patches():
    """The reference behaviour the port keeps (ROADMAP §3), in both
    packages.  (a) A join into a ``ContinuousEngine`` of ``max_len`` 16
    and ``max_gen`` 4 prefills 8 patches and 16 ids (24 positions) into
    its 20 slots: the slot holds positions 4-23 at ``p % 20``, as a
    ring, equal to JAX's, so the first four patches are gone before the
    first decode step.  (b) What that costs, on random patches (the
    engines' zero patches leave zero K/V, whose share of a softmax over
    random weights' large scores rounds away): one decode step on the
    20-slot ring gives other logits than on a 32-slot cache, in both
    packages, each equal to the other package's."""
    jp, tp = _params()
    req = apps.make_dataset(2, seed=0)[0]
    jreq = jax_apps.make_dataset(2, seed=0)[0]
    te = ContinuousEngine(CFG, params=tp, device="cpu", slots=1,
                          max_len=16, max_gen=4)
    je = JaxContinuousEngine(JCFG, params=jp, slots=1, max_len=16,
                             max_gen=4)
    te.join(req)
    je.join(jreq)
    ids = torch.zeros((1, 16), dtype=torch.int32)
    ids[0] = torch.tensor(encode(f"{req.instruction} {req.user_input}",
                                 CFG.vocab_size)[:16])
    _, full = M.prefill(tp, CFG, {"tokens": ids,
                                  "lengths": torch.tensor([16]),
                                  "patches": torch.zeros(1, P, CFG.d_model)},
                        act_dtype=torch.float32)
    for got, want, whole in zip(te.cache["kv"], je.cache["kv"],
                                full["kv"]):
        assert got.shape[2] == 20 and whole.shape[2] == P + 16
        _close(got.numpy(), np.asarray(want))
        for p in range(4, P + 16):
            assert torch.equal(got[:, 0, p % 20], whole[:, 0, p])
    s, lengths = 16, (16, 16)
    logits = {}
    for cache_len in (20, 32):
        _, tc = _port_prefill("random", s, lengths, cache_len)
        _, jc = _jax_prefill("random", s, lengths, cache_len)
        tok, pos = _tokens(s)[:, s].copy(), np.full(2, s, np.int32)
        tl, _ = M.decode_step(tp, CFG, tc, {"tokens": torch.from_numpy(tok),
                                            "positions": torch.from_numpy(
                                                pos)},
                              act_dtype=torch.float32)
        jl, _ = JM.decode_step(jp, JCFG, jc, {"tokens": jnp.asarray(tok),
                                              "positions": jnp.asarray(pos)},
                               act_dtype=jnp.float32)
        _close(tl.numpy(), jl)
        logits[cache_len] = (tl.numpy(), np.asarray(jl))
    for i in (0, 1):
        err, scale = _err(logits[20][i], logits[32][i])
        assert err > 0.01 * scale


def test_launcher_serves_internvl2_as_jax():
    """``--arch internvl2-26b --strategy magnus`` through the padded
    launcher: JAX's batches and WMA (the memory model counts no patch
    tokens, in both packages)."""
    _, tp = _params()
    jout = jax_serve.run_engine_backend(ARCH, 2.0, 3.0, "magnus")
    tout = serve.run_engine_backend(ARCH, 2.0, 3.0, "magnus", device="cpu",
                                    params=tp)
    for key in ("requests", "batches", "wma_total"):
        assert tout[key] == jout[key], key
    assert tout["requests"] > 0
    assert tout["host_syncs"] == sum(bin(r.iterations).count("1")
                                     for r in tout["results"])


def test_paged_strategy_refuses_vlm_as_jax():
    """A paged strategy through the port's launcher refuses the family
    with the reason the reference's paged engine gives (its launcher
    builds that engine for a paged strategy, which raises first)."""
    with pytest.raises(NotImplementedError) as want:
        JaxPagedEngine(JCFG)          # where the reference launcher refuses
    with pytest.raises(NotImplementedError) as got:
        serve.run_paged_engine_backend(ARCH, 2.0, 3.0, "magnus-paged",
                                       device="cpu")
    assert str(got.value) == str(want.value)
    assert "family vlm has no paged cache layout" in str(got.value)
    assert M.supports_paged(CFG) == JM.supports_paged(JCFG)
