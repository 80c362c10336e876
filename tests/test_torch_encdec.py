"""The PyTorch port's encoder-decoder family (whisper-large-v3, reduced:
2 encoder and 2 decoder layers, d_model 256, 4 heads of 64,
``encoder_seq`` 16 padded to 512 frames) on the padded path against the
JAX reference, at f32 on the CPU with the reference's weights carried
across by ``params_from_numpy``:

- the parameter tree against the reference's ``encdec.model_spec``, the
  carried weights equal; LayerNorm, the sinusoidal positions and the
  GELU MLP (tanh form: the exact erf form, torch's default, misses);
- ``encode``, ``prefill`` (logits and both caches: the self K/V padded
  or cut to ``cache_len``, the cross K/V of the 512 padded rows) and
  ``decode_step`` (on the reference's cache, carried across; the self
  K/V written at ``positions % S``, the positions table clamped to its
  S rows) at 2e-4 of scale; ``test_arch_smoke.py``'s prefill/decode
  tests; the flash and dense decode counts of each call;
- ``decode_step_into`` k times equals ``decode_multi(num_steps=k)``;
- ``BatchEngine`` and ``ContinuousEngine`` (the cross cache at
  ``encoder_seq`` rows) stream JAX's tokens with zero frames; the
  padded launcher's batches and WMA equal JAX's; a paged strategy
  refuses the family with the reference's reason.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_config
from repro.core.types import Batch as JaxBatch
from repro.launch import serve as jax_serve
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import BatchEngine as JaxBatchEngine
from repro.serving.engine import ContinuousEngine as JaxContinuousEngine
from repro.serving.engine import PagedContinuousEngine as JaxPagedEngine
from repro.workload import apps as jax_apps
from repro_torch.configs import get_config
from repro_torch.core.types import Batch
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.params import param_specs, params_from_numpy
from repro_torch.serving.engine import BatchEngine, ContinuousEngine, _bucket
from repro_torch.workload import apps

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

ARCH = "whisper-large-v3"
TOL = 2e-4           # f32, of the reference's largest magnitude
FORWARD_TOL = 2e-3   # decode against the full forward (test_arch_smoke.py)
JCFG, CFG = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
F_PAD = 512          # encoder_seq 16 padded to a multiple of 512
RESULT_FIELDS = ("iterations", "batch_size", "batch_length", "wma",
                 "total_tokens", "valid_tokens")
S, LENGTHS = 16, (16, 11)


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


@functools.lru_cache(maxsize=None)
def _frames(b=2):
    return np.random.default_rng(3).standard_normal(
        (b, CFG.encoder_seq, CFG.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tokens(s):
    """[2, s + 1] ids, as test_arch_smoke.py draws them."""
    return np.array(jax.random.randint(jax.random.PRNGKey(1), (2, s + 1),
                                       0, JCFG.vocab_size), np.int32)


@functools.lru_cache(maxsize=None)
def _jax_prefill(cache_len):
    jp, _ = _params()
    return JM.prefill(jp, JCFG, {
        "tokens": jnp.asarray(_tokens(S)[:, :S]),
        "lengths": jnp.asarray(LENGTHS, np.int32),
        "frames": jnp.asarray(_frames())},
        act_dtype=jnp.float32, cache_len=cache_len)


def _port_prefill(cache_len):
    _, tp = _params()
    return M.prefill(tp, CFG, {
        "tokens": torch.from_numpy(_tokens(S)[:, :S].copy()),
        "lengths": torch.tensor(LENGTHS, dtype=torch.int32),
        "frames": torch.from_numpy(_frames())},
        act_dtype=torch.float32, cache_len=cache_len)


# ---------------------------------------------------------------------------
# parameters and primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_param_specs_match_the_reference(reduced):
    """Every leaf's shape against the reference's ``encdec.model_spec``
    (specs only at full width: 32 + 32 layers of 20 heads of 64)."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jspec = dict(_leaves(jax.tree.map(
        lambda s: s.shape, JE.model_spec(jcfg),
        is_leaf=lambda s: hasattr(s, "shape"))))
    tspec = {k: v[0] for k, v in _leaves(param_specs(tcfg))}
    assert tspec == jspec
    if not reduced:
        assert tspec["/dec_blocks/cross/wq"] == (32, 1280, 20, 64)
        assert tspec["/enc_blocks/mlp/up_b"] == (32, 5120)
        assert "bk" not in param_specs(tcfg)["enc_blocks"]["attn"]


def test_params_carried_across():
    """The carried tree equals the reference's, and ``init_params`` draws
    the same layout with the reference's initialisers (biases zero,
    LayerNorm weights one)."""
    jp, tp = _params()
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert sorted(jl) == sorted(tl)
    for name, j in jl.items():
        np.testing.assert_array_equal(tl[name].numpy(), np.asarray(j))
    own = dict(_leaves(M.init_params(CFG, seed=0, device="cpu")))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in tl.items()}
    assert not own["/dec_blocks/cross/bo"].any()
    assert (own["/enc_ln/w"] == 1).all() and not own["/enc_ln/b"].any()
    assert own["/dec_blocks/self/wq"].std() > 0


def test_layer_norm_and_positions_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 256)) * 30 + 5).astype(np.float32)
    w, b = (rng.standard_normal(256).astype(np.float32) for _ in range(2))
    got = L.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(got.numpy(), JL.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b)), tol=1e-6)
    bf = L.layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                      torch.from_numpy(b))
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        L.sinusoidal_positions(1536, 1280).numpy(),
        np.asarray(JL.sinusoidal_positions(1536, 1280)))


def test_gelu_mlp_is_the_tanh_form():
    """The port's GELU MLP equals the reference's ``_gelu_mlp``
    (``jax.nn.gelu``'s default tanh form) at 1e-6 of scale; the exact
    erf form, torch's default, misses it by more than this test's
    tolerance, so this test fails if the port used it."""
    _, tp = _params()
    jp, _ = _params()
    mlp = {k: v[0] for k, v in tp["enc_blocks"]["mlp"].items()}
    jmlp = {k: v[0] for k, v in jp["enc_blocks"]["mlp"].items()}
    x = np.random.default_rng(1).standard_normal(
        (2, 9, CFG.d_model)).astype(np.float32) * 2
    want = np.asarray(JE._gelu_mlp(jmlp, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    _close(L.gelu_mlp(xt, mlp).numpy(), want, tol=1e-6)
    erf = F.gelu(xt @ mlp["up"] + mlp["up_b"]) @ mlp["down"] + mlp["down_b"]
    err, scale = _err(erf.numpy(), want)
    assert err > 1e-6 * scale


# ---------------------------------------------------------------------------
# encode, prefill and decode against JAX's
# ---------------------------------------------------------------------------

def test_encode_matches_jax():
    """The encoder over 16 random frames padded to 512 (the pad frames
    masked as keys, computed as queries): 2e-4 of scale, one flash call
    a layer, at Sq = Sk = 512."""
    jp, tp = _params()
    want = JE.encode(jp, JCFG, jnp.asarray(_frames()), act_dtype=jnp.float32)
    flash_ops.reset_counts()
    got = E.encode(tp, CFG, torch.from_numpy(_frames()),
                   act_dtype=torch.float32)
    assert flash_ops.flash_attention.plain_calls == CFG.encoder_layers
    assert got.shape == (2, F_PAD, CFG.d_model)
    _close(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _jax_prefill_f64(cache_len):
    """The reference's prefill on the same weights and inputs at f64
    (``jax.enable_x64``; its LayerNorm and attention still round to f32
    inside, as the port's do), as numpy: the run both packages' f32
    self caches are measured against."""
    jp, _ = _params()
    tokens, frames = _tokens(S)[:, :S], _frames()   # drawn outside x64
    with jax.enable_x64(True):
        jp64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                            jp)
        logits, cache = JM.prefill(jp64, JCFG, {
            "tokens": jnp.asarray(tokens),
            "lengths": jnp.asarray(LENGTHS, np.int32),
            "frames": jnp.asarray(frames.astype(np.float64))},
            act_dtype=jnp.float64, cache_len=cache_len)
        return jax.tree.map(np.asarray, (logits, cache))


def _port_prefill_f64(cache_len):
    """The port's prefill in f64 throughout (``layers.upcast`` keeps f64
    through LayerNorm and attention)."""
    jp, _ = _params()
    tp64 = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=torch.float64)
    return M.prefill(tp64, CFG, {
        "tokens": torch.from_numpy(_tokens(S)[:, :S].copy()),
        "lengths": torch.tensor(LENGTHS, dtype=torch.int32),
        "frames": torch.from_numpy(_frames().astype(np.float64))},
        act_dtype=torch.float64, cache_len=cache_len)


@pytest.mark.parametrize("cache_len", [None, 24, 8],
                         ids=["S", "grown", "cut"])
def test_prefill_matches_jax(cache_len):
    """Logits at ``lengths - 1`` and the cross K/V of all 512 encoder
    rows at 2e-4 of scale; the self K/V zero-padded or cut (not
    ring-packed) to ``cache_len``; an encoder call a layer and two
    decoder calls a layer (causal self, cross at Sq 16, Sk 512, key
    bound 16) through flash.

    The self K/V is held another way, in f64 and in f32.  Both packages
    compute the same operations (compared one by one at f32: LayerNorm,
    Q/K/V, attention, cross attention, GELU MLP, residuals), but with
    random weights the cross attention's scores reach ~540, so its
    softmax amplifies the f32 rounding of a 64-term dot product (the two
    packages sum it in different orders) to ~1e-4 of scale and more in
    layer 0's output, which layer 1's K/V inherit; how far depends on
    the CPU that sums it.

    - f64: the port's f64 self cache against the reference's x64 run.
      That run still scores attention and normalises in f32 (the
      ``astype(float32)`` of its ``gqa_prefill_attention`` and
      ``layer_norm``), so it carries an f32 attention error of its own
      (~1e-4 of scale from the port's f64 run, measured on the CPU).
      The two must lie within the f32 runs' own rounding: the port's
      f32 run's distance from its f64 run plus the reference's f32
      run's distance from its x64 run.
    - f32: the two f32 caches within 2e-4 of scale, widened by those
      same two distances.
    Layer 0's self K/V, before any softmax, stays at 2e-4 of scale."""
    flash_ops.reset_counts()
    tl, tc = _port_prefill(cache_len)
    assert flash_ops.flash_attention.plain_calls == \
        CFG.encoder_layers + 2 * CFG.num_layers
    jl, jc = _jax_prefill(cache_len)
    _, jc64 = _jax_prefill_f64(cache_len)
    _, tc64 = _port_prefill_f64(cache_len)
    _close(tl.numpy(), jl)
    for key, rows in (("kv", cache_len or S), ("cross", F_PAD)):
        for got, want, got64, want64 in zip(tc[key], jc[key], tc64[key],
                                            jc64[key]):
            assert got.shape == (CFG.num_layers, 2, rows, CFG.num_heads,
                                 CFG.head_dim)
            if key == "cross":
                _close(got.numpy(), want)
                continue
            _close(got[0].numpy(), want[0])
            port_round, _ = _err(got, got64.numpy())
            ref_round, _ = _err(want, want64)
            err64, _ = _err(got64.numpy(), want64)
            assert err64 <= port_round + ref_round, (
                f"self {key}: the port's f64 cache lies {err64:.3e} from "
                f"the reference's x64 run, past the f32 runs' own "
                f"rounding {port_round:.3e} + {ref_round:.3e}")
            err, scale = _err(got, want)
            assert err <= TOL * scale + port_round + ref_round, (
                f"self {key}: the f32 caches differ by {err:.3e}, past "
                f"2e-4 of {scale:.3e} plus the runs' own rounding "
                f"{port_round:.3e} + {ref_round:.3e}")


@pytest.mark.parametrize("cache_len", [24, 16], ids=["room", "ring"])
def test_decode_step_matches_jax(cache_len):
    """Three decode steps on the reference's prefill cache, carried
    across: logits after each and both caches at the end at 2e-4 of
    scale.  Each step writes the self K/V at ``positions % S`` in place
    and reads nothing of the cross cache past ``encoder_seq``; two
    decode calls a layer.  With S 16, row 0 (at 16-18) wraps to slots
    0-2 and its position embedding is the table's last row, as in the
    reference."""
    jp, tp = _params()
    _, jc = _jax_prefill(cache_len)
    tc = params_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    rng = np.random.default_rng(1)
    pos = np.array(LENGTHS, np.int32)
    for _ in range(3):
        tok = rng.integers(3, CFG.vocab_size, size=2).astype(np.int32)
        before = tc["kv"][0][0].clone()
        jl, jc = JM.decode_step(jp, JCFG, jc, {"tokens": jnp.asarray(tok),
                                               "positions": jnp.asarray(pos)},
                                act_dtype=jnp.float32)
        decode_ops.reset_counts()
        tl, out = M.decode_step(tp, CFG, tc, {
            "tokens": torch.from_numpy(tok),
            "positions": torch.from_numpy(pos.copy())},
            act_dtype=torch.float32)
        assert out is tc
        assert decode_ops.decode_attention.plain_calls == 2 * CFG.num_layers
        _close(tl.numpy(), jl)
        changed = (tc["kv"][0][0] != before).any(-1).any(-1)
        assert changed.nonzero()[:, 1].tolist() == (pos % cache_len).tolist()
        pos = pos + 1
    for key in ("kv", "cross"):
        for got, want in zip(tc[key], jc[key]):
            _close(got.numpy(), want)


def test_cross_decode_reads_encoder_seq_rows():
    """Decode attends the cross cache's first ``encoder_seq`` rows only:
    NaN in rows 16-511 of a prefill's cross cache changes nothing, bit
    for bit; a cache of exactly ``encoder_seq`` rows (``init_cache``'s)
    gives the same logits."""
    _, tp = _params()
    _, tc = _port_prefill(24)
    poisoned = {"kv": tuple(t.clone() for t in tc["kv"]),
                "cross": tuple(t.clone() for t in tc["cross"])}
    for t in poisoned["cross"]:
        t[:, :, CFG.encoder_seq:] = float("nan")
    cut = {"kv": tuple(t.clone() for t in tc["kv"]),
           "cross": tuple(t[:, :, :CFG.encoder_seq].clone()
                          for t in tc["cross"])}
    shapes = M.init_cache(CFG, 2, 24, dtype=torch.float32, device="cpu")
    assert [tuple(t.shape) for t in shapes["cross"]] == \
        [tuple(t.shape) for t in cut["cross"]]
    batch = {"tokens": torch.tensor([5, 6], dtype=torch.int32),
             "positions": torch.tensor(LENGTHS, dtype=torch.int32)}
    logits = [M.decode_step(tp, CFG, c, dict(batch),
                            act_dtype=torch.float32)[0]
              for c in (tc, poisoned, cut)]
    assert torch.equal(logits[0], logits[1])
    assert torch.equal(logits[0], logits[2])


def test_reduced_prefill_decode():
    """test_arch_smoke.py's prefill + decode for whisper (cache s + 8),
    in the port's default bf16: shapes, no NaN."""
    params = M.init_params(CFG, seed=0, device="cpu")
    b, s = 2, 32
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, CFG.vocab_size, (b, s), generator=gen,
                         dtype=torch.int32)
    frames = torch.randn(b, CFG.encoder_seq, CFG.d_model,
                         generator=gen).to(torch.bfloat16)
    last, cache = M.prefill(params, CFG, {
        "tokens": toks, "lengths": torch.tensor([s, s - 5]),
        "frames": frames}, cache_len=s + 8)
    assert last.shape == (b, CFG.padded_vocab)
    logits, cache = M.decode_step(params, CFG, cache, {
        "tokens": torch.tensor([3, 4], dtype=torch.int32),
        "positions": torch.tensor([s, s - 5], dtype=torch.int32)})
    assert logits.shape == (b, CFG.padded_vocab)
    assert not torch.isnan(logits.float()).any()


def test_decode_matches_forward():
    """test_arch_smoke.py's cache invariant for whisper: decode at
    position S equals the decoder's full forward over S + 1 tokens (here
    a prefill over them) within its 2e-3; the forward equals JAX's at
    2e-4 and the decode JAX's forward at 2e-3."""
    jp, tp = _params()
    b, s = 2, 32
    toks = _tokens(s)
    t = torch.from_numpy
    full, _ = M.prefill(tp, CFG, {"tokens": t(toks), "frames": t(_frames()),
                                  "lengths": torch.full((b,), s + 1)},
                        act_dtype=torch.float32)
    _, cache = M.prefill(tp, CFG, {"tokens": t(toks[:, :s].copy()),
                                   "frames": t(_frames()),
                                   "lengths": torch.full((b,), s)},
                         cache_len=s + 4, act_dtype=torch.float32)
    dec, _ = M.decode_step(tp, CFG, cache, {
        "tokens": t(toks[:, s].copy()),
        "positions": torch.full((b,), s, dtype=torch.int32)},
        act_dtype=torch.float32)
    assert (full - dec).abs().max().item() < FORWARD_TOL
    enc = JE.encode(jp, JCFG, jnp.asarray(_frames()), act_dtype=jnp.float32)
    jfull, _ = JE._decoder(jp, JCFG, jnp.asarray(toks), enc, rules=None,
                           act_dtype=jnp.float32)
    _close(full, jfull[:, s])
    _close(dec, jfull[:, s], tol=FORWARD_TOL)


def test_decode_step_into_equals_decode_multi():
    """``decode_step_into`` called k times (the step a CUDA graph
    captures) equals ``decode_multi(num_steps=k)``: tokens, logits,
    positions and both caches, bit for bit; it writes the self cache in
    place and leaves the cross cache as it was."""
    _, tp = _params()
    logits, cache = _port_prefill(24)
    twin = {key: tuple(t.clone() for t in leaves)
            for key, leaves in cache.items()}
    cross = [t.clone() for t in cache["cross"]]
    pos = torch.tensor(LENGTHS, dtype=torch.int32)
    m_logits, m_cache, m_pos, m_toks = M.decode_multi(
        tp, CFG, twin, {"logits": logits.clone(), "positions": pos.clone()},
        num_steps=4, act_dtype=torch.float32)
    state = {"logits": logits.clone(), "positions": pos.clone()}
    addresses = [t.data_ptr() for leaves in cache.values() for t in leaves]
    tok = torch.zeros(2, dtype=torch.int32)
    toks = []
    for _ in range(4):
        M.decode_step_into(tp, CFG, cache, state, tok,
                           act_dtype=torch.float32)
        toks.append(tok.clone())
    assert torch.equal(torch.stack(toks, dim=1), m_toks)
    assert torch.equal(state["logits"], m_logits)
    assert torch.equal(state["positions"], m_pos)
    assert addresses == [t.data_ptr() for leaves in cache.values()
                         for t in leaves]
    for key in ("kv", "cross"):
        for a, b in zip(cache[key], m_cache[key]):
            assert torch.equal(a, b)
    for a, b in zip(cache["cross"], cross):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engines and the launcher against JAX's
# ---------------------------------------------------------------------------

def _reqs(mod, n=4):
    reqs = mod.make_dataset(2, seed=0)[:n]
    for i, r in enumerate(reqs):
        r.gen_length = 3 + (i * 3) % 10
    return reqs


def test_batch_engine_matches_jax(monkeypatch):
    """One padded batch with zero frames: streams, G(B) iterations, WMA
    and host syncs equal the JAX engine's; the prefill takes zero frames
    [4, encoder_seq, d] and a cache of ``_bucket(bl + bg)`` slots; the
    flash and decode counts are the family's (an encoder and two decoder
    calls a layer; two decode calls a layer and step)."""
    jp, tp = _params()
    je = JaxBatchEngine(JCFG, params=jp, max_gen=12)
    te = BatchEngine(CFG, params=tp, max_gen=12, device="cpu")
    jreqs, treqs = _reqs(jax_apps), _reqs(apps)
    jres = je.serve_batch(JaxBatch(requests=jreqs))
    seen = []
    prefill = M.prefill

    def spy(params, cfg, batch, **kw):
        seen.append((tuple(batch["frames"].shape),
                     int(batch["frames"].abs().sum()), kw["cache_len"]))
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
    assert seen == [((4, CFG.encoder_seq, CFG.d_model), 0,
                     _bucket(bl + bg))]
    assert flash_ops.flash_attention.plain_calls == \
        CFG.encoder_layers + 2 * CFG.num_layers
    assert decode_ops.decode_attention.plain_calls == \
        2 * CFG.num_layers * bg


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
    """Joins with zero frames; streams and finish order equal the JAX
    engine's at every step.  The slot cache holds the cross K/V at
    ``encoder_seq`` rows (``init_cache``'s), to which each join's 512-row
    prefill cache is cut, as the reference's merge cuts it; the cut
    slot equals the JAX engine's."""
    jp, tp = _params()
    kw = dict(slots=2, max_len=32, max_gen=12)
    je = JaxContinuousEngine(JCFG, params=jp, **kw)
    jtrace = _lockstep(je, _reqs(jax_apps, 3))
    te = ContinuousEngine(CFG, params=tp, device="cpu", **kw)
    ttrace = _lockstep(te, _reqs(apps, 3))
    assert len(ttrace) == len(jtrace)
    for step, (t, j) in enumerate(zip(ttrace, jtrace)):
        assert t == j, f"step {step}"
    assert [tuple(t.shape) for t in te.cache["cross"]] == \
        [(CFG.num_layers, 2, CFG.encoder_seq, CFG.num_heads,
          CFG.head_dim)] * 2
    for got, want in zip(te.cache["cross"], je.cache["cross"]):
        _close(got.numpy(), np.asarray(want))


def _short_training(monkeypatch):
    """Both launchers' length predictors trained on 5 requests an app
    where they take 60: the same inputs in both packages, at a twelfth of
    the fitting time."""
    for mod in (serve, jax_serve):
        monkeypatch.setattr(mod, "make_dataset", functools.partial(
            lambda real, n, seed: real(5, seed=seed), mod.make_dataset))


def test_launcher_serves_whisper_as_jax(monkeypatch):
    """``--arch whisper-large-v3 --strategy magnus`` through the padded
    launcher: JAX's batches and WMA (the memory model prices each
    request's cross cache at ``encoder_seq`` rows, in both packages)."""
    _short_training(monkeypatch)
    _, tp = _params()
    jout = jax_serve.run_engine_backend(ARCH, 2.0, 3.0, "magnus")
    tout = serve.run_engine_backend(ARCH, 2.0, 3.0, "magnus", device="cpu",
                                    params=tp)
    for key in ("requests", "batches", "wma_total"):
        assert tout[key] == jout[key], key
    assert tout["requests"] > 0
    assert tout["host_syncs"] == sum(bin(r.iterations).count("1")
                                     for r in tout["results"])


def test_paged_strategy_refuses_encdec_as_jax(monkeypatch):
    """The reference pages no cross cache: a paged strategy through the
    port's launcher refuses the family with the reason the reference's
    paged engine gives (its launcher builds that engine, which raises
    first)."""
    _short_training(monkeypatch)
    with pytest.raises(NotImplementedError) as want:
        JaxPagedEngine(JCFG)          # where the reference launcher refuses
    with pytest.raises(NotImplementedError) as got:
        serve.run_paged_engine_backend(ARCH, 2.0, 3.0, "magnus-paged",
                                       device="cpu")
    assert str(got.value) == str(want.value)
    assert "enc-dec cross-KV caches are not paged" in str(got.value)
    assert M.supports_paged(CFG) == JM.supports_paged(JCFG)
