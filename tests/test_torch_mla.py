"""The PyTorch port's MLA family (deepseek-v3-671b, reduced: 2 layers,
d_model 256, 4 heads, q_lora 64, kv_lora 32, nope 32, rope 16, v 32, 4
experts top 2 of width 73 plus a shared one, MTP depth 1) on the padded
path against the JAX reference, at f32 on the CPU with the reference's
weights carried across by ``params_from_numpy``:

- the parameter tree: its specs against the reference's ``model_spec``
  leaf for leaf (reduced and full: the MLA leaves, the MoE and the
  unstacked ``"mtp"`` block), the reference's whole tree carried across
  (the routers, the MTP block's too, kept f32), and ``init_params``'s
  sliced draw of leaves above ``DRAW_WHOLE``;
- ``models/mla.py`` against the reference's ``models/mla.py`` at 2e-4 of
  scale: ``_queries``, ``mla_latents``, ``mla_prefill`` in several KV
  chunks and in one, ``mla_decode`` on a cache longer than the position
  and on a ring; the absorbed decode against the naive form (K and V
  expanded from the latent) in f64; no host read in a decode step;
- ``prefill`` (the latent cache's two leaves, grown and ring-packed)
  and ``decode_step`` of the whole model; ``test_arch_smoke.py``'s
  prefill/decode tests (the full forward is a prefill over S + 1 tokens:
  training is not ported);
- ``BatchEngine``, ``ContinuousEngine`` step by step and the padded
  launcher's batches and WMA equal JAX's; a paged strategy refuses the
  family with the reference's reason in both packages.
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
from repro.models import mla as jax_mla
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving.engine import BatchEngine as JaxBatchEngine
from repro.serving.engine import ContinuousEngine as JaxContinuousEngine
from repro.serving.engine import PagedContinuousEngine as JaxPagedEngine
from repro.workload import apps as jax_apps
from repro_torch import params as params_lib
from repro_torch.analysis.sanitizer import count_host_reads
from repro_torch.configs import get_config
from repro_torch.core.types import Batch
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve
from repro_torch.models import mla
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.params import init_params, param_specs, params_from_numpy
from repro_torch.serving.engine import BatchEngine, ContinuousEngine
from repro_torch.workload import apps

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
TOL = 2e-4           # f32, of the reference's largest magnitude
FORWARD_TOL = 2e-3   # decode against the full forward (test_arch_smoke.py)
JCFG, CFG = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
M_CFG = CFG.mla
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
    only: nothing is drawn at full width): the stacked MLA leaves, the
    MoE with its shared expert, and the MTP module with its unstacked
    block."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jspec = dict(_leaves(jax.tree.map(
        lambda s: s.shape, JT.model_spec(jcfg),
        is_leaf=lambda s: hasattr(s, "shape"))))
    tspec = {k: v[0] for k, v in _leaves(param_specs(tcfg))}
    assert tspec == jspec
    m, h, L = tcfg.mla, tcfg.num_heads, tcfg.num_layers
    assert tspec["/blocks/mla/k_b"] == (L, m.kv_lora_rank, h, m.qk_nope_dim)
    assert tspec["/mtp/block/mla/k_b"] == (m.kv_lora_rank, h, m.qk_nope_dim)
    assert tspec["/mtp/proj"] == (2 * tcfg.d_model, tcfg.d_model)
    assert "/blocks/attn/wq" not in tspec
    if not reduced:
        assert tspec["/blocks/moe/gate"] == (61, 256, 7168, 2048)


def test_params_carried_across_whole():
    """The reference's whole tree (MTP included) crosses over leaf for
    leaf; every router, the MTP block's too, stays f32 in a bf16 cast,
    and so it does in the port's own draw."""
    jp, tp = _params()
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert sorted(jl) == sorted(tl)
    assert {"/blocks/mla/q_a", "/blocks/mla/v_b", "/mtp/proj",
            "/mtp/block/mla/out", "/mtp/block/moe/router",
            "/mtp/norm_h"} <= set(tl)
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


def test_init_params_draws_large_leaves_in_slices(monkeypatch):
    """A leaf above ``DRAW_WHOLE`` (here the experts' 149,504 elements,
    the largest leaves) is drawn ``DRAW_SLICE`` elements at a time, cast
    as it goes, with the reference's std; the leaves drawn before it,
    each at most ``DRAW_WHOLE``, are drawn whole and do not change."""
    def draw(whole, sl):
        monkeypatch.setattr(params_lib, "DRAW_WHOLE", whole)
        monkeypatch.setattr(params_lib, "DRAW_SLICE", sl)
        return dict(_leaves(init_params(
            CFG, generator=torch.Generator().manual_seed(0), device="cpu",
            dtype=torch.bfloat16)))

    whole, sliced = draw(1 << 31, 1 << 28), draw(140_000, 1000)
    name = "/blocks/moe/gate"                   # [2, 4, 256, 73]
    assert whole[name].numel() > 140_000 >= whole["/embed"].numel()
    assert sliced[name].dtype == torch.bfloat16
    assert not torch.equal(sliced[name], whole[name])
    want = 1 / np.sqrt(CFG.num_layers)          # fan-in: the leading axis
    assert abs(sliced[name].float().std().item() / want - 1) < 0.02
    for before in ("/embed", "/blocks/mla/q_a", "/blocks/mla/out"):
        assert torch.equal(sliced[before], whole[before])


def test_cache_struct_matches_the_reference():
    """The latent cache: {"kv": (c_kv [L, B, S, R], k_rope [L, B, S,
    Dr])} in the activations' dtype, the reference's shapes and axes."""
    shapes, axes = T.cache_struct(CFG, 3, 40)
    jshapes, jaxes = JT.cache_struct(JCFG, 3, 40)
    assert set(shapes) == set(jshapes) == {"kv"}
    assert [s for s, _ in shapes["kv"]] == [j.shape for j in jshapes["kv"]]
    assert [s for s, _ in shapes["kv"]] == [
        (2, 3, 40, M_CFG.kv_lora_rank), (2, 3, 40, M_CFG.qk_rope_dim)]
    assert axes == jaxes
    cache = M.init_cache(CFG, 3, 40, dtype=torch.bfloat16, device="cpu")
    assert [t.dtype for t in cache["kv"]] == [torch.bfloat16] * 2


# ---------------------------------------------------------------------------
# models/mla.py against the reference's
# ---------------------------------------------------------------------------

def _layer0():
    """Layer 0's MLA weights in both packages."""
    jp, tp = _params()
    return ({k: v[0] for k, v in jp["blocks"]["mla"].items()},
            {k: v[0] for k, v in tp["blocks"]["mla"].items()})


def _x(b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, CFG.d_model)).astype(np.float32)


def test_queries_and_latents_match_jax():
    jl, tl = _layer0()
    x, pos = _x(2, 24), np.arange(24)
    theta, h = CFG.rope_theta, CFG.num_heads
    jq = jax_mla._queries(jl, jnp.asarray(x), JCFG.mla, h, jnp.asarray(pos),
                          theta)
    tq = mla._queries(tl, torch.from_numpy(x), M_CFG, h,
                      torch.from_numpy(pos), theta)
    for got, want in zip(tq, jq):
        _close(got.numpy(), want)
    jc = jax_mla.mla_latents(jl, jnp.asarray(x), JCFG.mla, jnp.asarray(pos),
                             theta)
    tc = mla.mla_latents(tl, torch.from_numpy(x), M_CFG,
                         torch.from_numpy(pos), theta)
    for got, want in zip(tc, jc):
        _close(got.numpy(), want)


@pytest.mark.parametrize("s,chunk,ck", [(24, 8, 8), (24, 24, 24),
                                        (30, 8, 6)],
                         ids=["three_chunks", "one_chunk", "uneven"])
def test_mla_prefill_matches_jax(s, chunk, ck):
    """The online-softmax loop over KV chunks against the reference's
    scan, output and latents: S 24 in three chunks of 8 or one of 24
    (the hold ``chip_smoke.py`` phase 20 (b) makes at full width, two
    chunks against one), and S 30 asked for chunks of 8, for which
    ``_pick_chunk`` takes the largest divisor, 6, as the reference's
    does."""
    jl, tl = _layer0()
    x, pos = _x(2, s, seed=1), np.arange(s)
    jout, jc = jax_mla.mla_prefill(jl, jnp.asarray(x), JCFG.mla,
                                   CFG.num_heads, jnp.asarray(pos),
                                   CFG.rope_theta, chunk=chunk)
    tout, tc = mla.mla_prefill(tl, torch.from_numpy(x), M_CFG, CFG.num_heads,
                               torch.from_numpy(pos), CFG.rope_theta,
                               chunk=chunk)
    assert mla._pick_chunk(s, chunk) == jax_mla._pick_chunk(s, chunk) == ck
    _close(tout.numpy(), jout)
    for got, want in zip(tc, jc):
        _close(got.numpy(), want)


def _decode_case(s, positions, seed=3):
    """A random latent cache of ``s`` slots and one new token a row."""
    rng = np.random.default_rng(seed)
    b = len(positions)
    c_kv = rng.standard_normal((b, s, M_CFG.kv_lora_rank)).astype(np.float32)
    k_rope = rng.standard_normal((b, s, M_CFG.qk_rope_dim)).astype(
        np.float32)
    x = rng.standard_normal((b, 1, CFG.d_model)).astype(np.float32)
    return x, c_kv, k_rope, np.array(positions, np.int32)


@pytest.mark.parametrize("s,positions", [(32, (20, 5)), (16, (20, 37))],
                         ids=["longer_cache", "ring"])
def test_mla_decode_matches_jax(s, positions):
    """The absorbed step writes the new latents at ``positions % S`` in
    place and reads ``min(pos + 1, S)`` slots: output and both leaves
    against the reference's, on a cache longer than the position and on
    a ring (slots 4 and 5 of 16, every slot read)."""
    jl, tl = _layer0()
    x, c_kv, k_rope, pos = _decode_case(s, positions)
    jout, jc = jax_mla.mla_decode(
        jl, jnp.asarray(x), JCFG.mla, CFG.num_heads,
        (jnp.asarray(c_kv), jnp.asarray(k_rope)), jnp.asarray(pos),
        jnp.asarray(pos), CFG.rope_theta)
    cache = (torch.from_numpy(c_kv.copy()), torch.from_numpy(k_rope.copy()))
    tout = mla.mla_decode(tl, torch.from_numpy(x), M_CFG, CFG.num_heads,
                          cache, torch.from_numpy(pos), CFG.rope_theta)
    _close(tout.numpy(), jout)
    for got, want in zip(cache, jc):
        _close(got.numpy(), want)
    slots = pos % s
    assert not np.array_equal(cache[0].numpy()[[0, 1], slots],
                              c_kv[[0, 1], slots])


def test_absorbed_decode_equals_the_naive_form():
    """The absorbed attention (query into the latent space, value out of
    it) against K = c_kv @ k_b and V = c_kv @ v_b with a plain masked
    softmax, in f64, on a cache with lengths 1, 9 and 16 of 16."""
    _, tl = _layer0()
    rng = np.random.default_rng(4)
    b, s, h = 3, 16, CFG.num_heads
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape))
    qn, qr = t(b, h, M_CFG.qk_nope_dim), t(b, h, M_CFG.qk_rope_dim)
    c_kv, k_rope = t(b, s, M_CFG.kv_lora_rank), t(b, s, M_CFG.qk_rope_dim)
    valid = torch.tensor([1, 9, 16])
    scale = mla._scale(M_CFG)
    k_b, v_b = tl["k_b"].double(), tl["v_b"].double()
    got = mla.absorbed_attention(qn.float(), qr.float(), c_kv.float(),
                                 k_rope.float(), k_b.float(), v_b.float(),
                                 valid, scale)
    k = torch.einsum("bsr,rhd->bshd", c_kv, k_b)
    v = torch.einsum("bsr,rhd->bshd", c_kv, v_b)
    sc = (torch.einsum("bhd,bshd->bhs", qn, k)
          + torch.einsum("bhd,bsd->bhs", qr, k_rope)) * scale
    mask = torch.arange(s)[None, :] < valid[:, None]
    sc = sc.masked_fill(~mask[:, None, :], float("-inf"))
    want = torch.einsum("bhs,bshd->bhd", torch.softmax(sc, -1), v)
    _close(got.numpy(), want.numpy())


def test_mla_decode_reads_nothing_on_the_host():
    """A whole-model decode step reads no tensor value on the host, so a
    CUDA graph can capture it."""
    _, tp = _params()
    cache = M.init_cache(CFG, 2, 16, dtype=torch.float32, device="cpu")
    with count_host_reads() as reads:
        M.decode_step(tp, CFG, cache, {
            "tokens": torch.tensor([3, 4], dtype=torch.int32),
            "positions": torch.tensor([5, 20], dtype=torch.int32)},
            act_dtype=torch.float32)
    assert reads["reads"] == 0


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tokens(s):
    """[2, s + 1] ids, as test_arch_smoke.py draws them."""
    return np.array(jax.random.randint(jax.random.PRNGKey(1), (2, s + 1),
                                       0, JCFG.vocab_size), np.int32)


@pytest.mark.parametrize("cache_len", [None, 32, 16],
                         ids=["exact", "grown", "ring"])
def test_prefill_matches_jax(cache_len):
    """Logits and both latent leaves at 2e-4 of scale, at S 24 with
    lengths 24 and 17: the cache as long as the prompt, grown to 32, and
    ring-packed to 16; no attention kernel runs."""
    jp, tp = _params()
    s, lengths = 24, (24, 17)
    toks = _tokens(s)[:, :s]
    jl, jc = JM.prefill(jp, JCFG, {"tokens": jnp.asarray(toks),
                                   "lengths": jnp.asarray(lengths)},
                        act_dtype=jnp.float32, cache_len=cache_len)
    flash_ops.reset_counts()
    tl, tc = M.prefill(tp, CFG, {"tokens": torch.from_numpy(toks.copy()),
                                 "lengths": torch.tensor(lengths)},
                       act_dtype=torch.float32, cache_len=cache_len)
    assert flash_ops.flash_attention.plain_calls == 0
    _close(tl.numpy(), jl)
    assert set(tc) == {"kv"}
    for got, want in zip(tc["kv"], jc["kv"]):
        assert got.shape[2] == (cache_len or s)
        _close(got.numpy(), want)


def test_decode_step_matches_jax():
    """Three decode steps after a ragged prefill (cache 32), fed the same
    tokens: logits after each and both leaves at the end; no decode
    kernel runs."""
    jp, tp = _params()
    s, lengths = 24, (24, 17)
    toks = _tokens(s)[:, :s]
    _, jc = JM.prefill(jp, JCFG, {"tokens": jnp.asarray(toks),
                                  "lengths": jnp.asarray(lengths)},
                       act_dtype=jnp.float32, cache_len=32)
    _, tc = M.prefill(tp, CFG, {"tokens": torch.from_numpy(toks.copy()),
                                "lengths": torch.tensor(lengths)},
                      act_dtype=torch.float32, cache_len=32)
    rng = np.random.default_rng(1)
    pos = np.array(lengths, np.int32)
    decode_ops.reset_counts()
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
    assert all(fn.plain_calls == 0 for fn in decode_ops.KERNELS)
    for got, want in zip(tc["kv"], jc["kv"]):
        _close(got.numpy(), want)


def test_reduced_prefill_decode():
    """test_arch_smoke.py's prefill + decode for deepseek-v3, in the
    port's default bf16: shapes, no NaN; the cache is bf16 latents."""
    params = M.init_params(CFG, seed=0, device="cpu")
    assert "mtp" in params
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
    assert [t.dtype for t in cache["kv"]] == [torch.bfloat16] * 2


def test_decode_matches_forward():
    """test_arch_smoke.py's cache invariant for deepseek-v3, on the
    reference's weights and tokens: decode at position S equals the full
    forward over S + 1 tokens (here a prefill over them), within its
    2e-3; and both sides equal JAX's."""
    jp, tp = _params()
    b, s = 2, 32
    toks = _tokens(s)
    t = torch.from_numpy
    full, _ = M.prefill(tp, CFG, {"tokens": t(toks), "lengths":
                                  torch.full((b,), s + 1)},
                        act_dtype=torch.float32)
    _, cache = M.prefill(tp, CFG, {"tokens": t(toks[:, :s].copy()),
                                   "lengths": torch.full((b,), s)},
                         cache_len=s + 4, act_dtype=torch.float32)
    dec, _ = M.decode_step(tp, CFG, cache, {
        "tokens": t(toks[:, s].copy()),
        "positions": torch.full((b,), s, dtype=torch.int32)},
        act_dtype=torch.float32)
    assert (full - dec).abs().max().item() < FORWARD_TOL
    jfull, _ = JM.prefill(jp, JCFG, {"tokens": toks, "lengths":
                                     np.full(b, s + 1)},
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


def test_batch_engine_matches_jax():
    """One padded batch: streams, G(B) iterations, WMA and host syncs
    equal the JAX engine's; no attention kernel runs."""
    jp, tp = _params()
    je = JaxBatchEngine(JCFG, params=jp, max_gen=12)
    te = BatchEngine(CFG, params=tp, max_gen=12, device="cpu")
    jreqs, treqs = _reqs(jax_apps), _reqs(apps)
    jres = je.serve_batch(JaxBatch(requests=jreqs))
    flash_ops.reset_counts()
    decode_ops.reset_counts()
    tres = te.serve_batch(Batch(requests=treqs))
    assert all(getattr(fn, "plain_calls", 0) == 0
               for fn in flash_ops.KERNELS + decode_ops.KERNELS)
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
    """Joins merge their latents into a slot of one cache; streams and
    finish order equal the JAX engine's at every step."""
    jp, tp = _params()
    kw = dict(slots=2, max_len=64, max_gen=8)
    jtrace = _lockstep(JaxContinuousEngine(JCFG, params=jp, **kw),
                       _reqs(jax_apps, 3))
    te = ContinuousEngine(CFG, params=tp, device="cpu", **kw)
    ttrace = _lockstep(te, _reqs(apps, 3))
    assert len(ttrace) == len(jtrace)
    for step, (t, j) in enumerate(zip(ttrace, jtrace)):
        assert t == j, f"step {step}"
    assert [c.shape for c in te.cache["kv"]] == [
        (2, 2, 72, M_CFG.kv_lora_rank), (2, 2, 72, M_CFG.qk_rope_dim)]


def test_launcher_serves_deepseek_as_jax():
    """``--arch deepseek-v3-671b --strategy magnus`` through the padded
    launcher: JAX's batches and WMA (every request is queued before the
    first batch forms, so neither depends on the engine's speed)."""
    _, tp = _params()
    jout = jax_serve.run_engine_backend(ARCH, 2.0, 3.0, "magnus")
    tout = serve.run_engine_backend(ARCH, 2.0, 3.0, "magnus", device="cpu",
                                    params=tp)
    for key in ("requests", "batches", "wma_total"):
        assert tout[key] == jout[key], key
    assert tout["requests"] > 0
    assert tout["host_syncs"] == sum(bin(r.iterations).count("1")
                                     for r in tout["results"])


def test_paged_strategy_refuses_mla_as_jax():
    """The reference pages no latent cache: a paged strategy through the
    port's launcher refuses the family with the reason the reference's
    paged engine gives (its launcher builds that engine, which raises
    first); the padded half takes the family
    (``test_launcher_serves_deepseek_as_jax`` serves it)."""
    with pytest.raises(NotImplementedError) as want:
        JaxPagedEngine(JCFG)          # where the reference launcher refuses
    with pytest.raises(NotImplementedError) as got:
        serve.run_paged_engine_backend(ARCH, 2.0, 3.0, "magnus-paged",
                                       device="cpu")
    assert str(got.value) == str(want.value)
    assert "MLA latent caches are not paged" in str(got.value)
    assert M.supports_paged(CFG) == JM.supports_paged(JCFG)
