"""The PyTorch port's MoE family (olmoe-1b-7b) against the JAX reference
on the CPU, at f32 with the reference's weights carried across by
``params_from_numpy``:

- ``moe_forward`` (capacity dispatch) and ``moe_forward_ragged``
  (dropless) against JAX's on the same inputs: capacity not binding,
  binding (many drops), several groups, a shared expert, 16 experts top
  4; their outputs within 2e-4 of scale and their aux losses equal;
- the reference's ``test_ragged_moe_matches_padded``
  (``tests/test_perf_knobs.py``) on the FFNs and the prefill logits,
  and its ``test_arch_smoke.py`` prefill/decode tests for olmoe
  (``forward_train`` is not ported: the full forward is a prefill over
  S + 1 tokens);
- greedy streams of the paged engine (radix cache on and off, fused,
  warmed), of ``BatchEngine`` (with its WMA) and of the launchers equal
  JAX's for ``olmoe-1b-7b`` reduced;
- the coupling the capacity brings, in both packages: a request served
  alone and in company gets other tokens when the capacity binds;
- the router stays f32 in a bf16 cast, ``batch_invariant()`` refuses a
  MoE config, and the FFN reads nothing back to the host.

On the card (``cuda``-marked): ``moe_forward_ragged`` and
``moe_forward`` in f32 and bf16 against their CPU results."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.core.types import Batch as JaxBatch
from repro.models import model as JM
from repro.models import moe as jax_moe
from repro.models.layers import materialize
from repro.serving.engine import BatchEngine as JaxBatchEngine
from repro.serving.engine import PagedContinuousEngine as JaxEngine
from repro.serving.engine import drive_paged as jax_drive
from repro.workload import apps as jax_apps
from repro_torch.analysis.sanitizer import count_host_reads
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core.types import Batch
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.transformer import cast_params
from repro_torch.params import init_params, params_from_numpy
from repro_torch.serving.engine import (BatchEngine, PagedContinuousEngine,
                                        drive_paged)
from repro_torch.workload import apps

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

TOL = 2e-4     # f32, of the reference's largest magnitude
BF16_GATES = 4e-3   # capacity against ragged: bf16 combine gates, 2^-9
ARCH = "olmoe-1b-7b"
JCFG, CFG = jax_config(ARCH).reduced(), get_config(ARCH).reduced()

# FFN cases: (max_experts, MoEConfig overrides, [B, S], group_size)
FFN_CASES = {
    "stock": (4, {}, (2, 16), 256),
    "binding": (4, dict(capacity_factor=0.5), (3, 40), 256),
    "groups": (4, {}, (3, 100), 64),            # T = 300: 5 groups of 60
    "shared": (4, dict(num_shared=1), (2, 24), 256),
    "e16_top4": (16, dict(top_k=4), (3, 40), 64),
}


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err,
                                                       np.abs(want).max())


def _moe_cfg(case):
    experts, over, _, _ = FFN_CASES[case]
    m = get_config(ARCH).reduced(max_experts=experts).moe
    return dataclasses.replace(m, **over)


@functools.lru_cache(maxsize=None)
def _ffn_setup(case):
    """The case's weights (the reference's ``moe_spec``, materialised by
    JAX), its input, and JAX's outputs of both FFNs."""
    _, _, (b, s), gs = FFN_CASES[case]
    m = _moe_cfg(case)
    jm = JaxMoEConfig(**dataclasses.asdict(m))
    d = CFG.d_model
    jp = materialize(jax_moe.moe_spec(d, jm), jax.random.PRNGKey(0))
    x = np.random.default_rng(1).normal(size=(b, s, d)).astype(np.float32)
    want = {"capacity": jax_moe.moe_forward(jp, jnp.asarray(x), jm,
                                            group_size=gs),
            "ragged": jax_moe.moe_forward_ragged(jp, jnp.asarray(x), jm)}
    want = {k: tuple(np.asarray(a) for a in v) for k, v in want.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return m, tp, x, gs, want


def _port_ffn(kind, tp, x, m, gs):
    if kind == "capacity":
        return moe.moe_forward(tp, x, m, group_size=gs)
    return moe.moe_forward_ragged(tp, x, m)


@pytest.mark.parametrize("kind", ["capacity", "ragged"])
@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(case, kind):
    m, tp, x, gs, want = _ffn_setup(case)
    y, aux = _port_ffn(kind, tp, torch.from_numpy(x), m, gs)
    _close(y, want[kind][0])
    assert abs(float(aux) - float(want[kind][1])) <= 1e-6 * abs(
        float(want[kind][1]))


def test_binding_capacity_drops_and_changes_the_output():
    """The binding case really drops: its capacity output is not the
    dropless one (JAX's and the port's alike)."""
    m, tp, x, gs, want = _ffn_setup("binding")
    t, k, e = x.shape[0] * x.shape[1], m.top_k, m.num_experts
    cap = int(np.ceil(t * k / e * m.capacity_factor))
    _, _, idx = moe._route(tp, torch.from_numpy(x).reshape(t, -1), m)
    load = np.bincount(idx.reshape(-1).numpy(), minlength=e)
    assert load.max() > cap
    diff = np.abs(want["capacity"][0] - want["ragged"][0]).max()
    assert diff > 0.1 * np.abs(want["ragged"][0]).max()


def test_num_groups_matches_jax():
    for t in (1, 32, 255, 256, 300, 2048, 4097):
        for target in (32, 64, 256):
            assert moe._num_groups(t, target) == \
                jax_moe._num_groups(t, target)


# ---------------------------------------------------------------------------
# the model: copies of the reference's ragged and arch-smoke tests
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_ragged_moe_matches_padded():
    """The reference's test (tests/test_perf_knobs.py): the dropless FFN
    equals the capacity dispatch when nothing drops (capacity_factor 8),
    on the FFNs and on the prefill logits.  The capacity dispatch
    combines with bf16-rounded gates (2^-9 of a gate at most) where the
    ragged form keeps them f32, so the two agree to ``BF16_GATES`` of
    scale, not to f32's 2e-4 (the reference holds its loss to 2e-3)."""
    _, tp = _params()
    cfgp = dataclasses.replace(
        CFG, moe=dataclasses.replace(CFG.moe, capacity_factor=8.0))
    cfgr = dataclasses.replace(CFG, moe_ragged=True)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, CFG.d_model, generator=gen)
    bp = {k: v[0] for k, v in tp["blocks"]["moe"].items()}
    _close(moe.moe_forward(bp, x, cfgp.moe)[0],
           moe.moe_forward_ragged(bp, x, cfgr.moe)[0], tol=BF16_GATES)
    toks = torch.randint(0, CFG.vocab_size, (2, 32), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks, "lengths": torch.tensor([32, 27])}
    lp, _ = M.prefill(tp, cfgp, batch, act_dtype=torch.float32)
    lr, _ = M.prefill(tp, cfgr, batch, act_dtype=torch.float32)
    _close(lp, lr, tol=BF16_GATES)


def test_reduced_prefill_decode():
    """test_arch_smoke.py's prefill + decode for olmoe, in the port's
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


def test_decode_matches_forward():
    """test_arch_smoke.py's cache invariant for olmoe, on the reference's
    weights and tokens: decode at position S equals the full forward
    over S + 1 tokens (here a prefill over them), within its 2e-3; and
    both sides equal JAX's."""
    jp, tp = _params()
    b, s = 2, 32
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (b, s + 1),
                                       0, JCFG.vocab_size), np.int32)
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
    assert (full - dec).abs().max().item() < 2e-3
    jfull, _ = JM.prefill(jp, JCFG, {"tokens": toks, "lengths":
                                     np.full(b, s + 1)},
                          act_dtype=jnp.float32)
    _close(full, jfull)
    _close(dec, jfull, tol=2e-3)


# ---------------------------------------------------------------------------
# the engines and launchers against JAX's
# ---------------------------------------------------------------------------

def _shared(mod, n=6, seed=3, gen=6):
    reqs = mod.make_shared_prefix_dataset(n, n_apps=2, instr_words=14,
                                          input_words=5, gen_length=gen,
                                          seed=seed)
    for i, r in enumerate(reqs):
        r.gen_length = 2 + (i * 3) % gen
        r.predicted_gen_length = r.gen_length
    return reqs


PAGED_KW = dict(max_concurrency=3, num_blocks=64, block_tokens=4,
                max_len=64, max_gen=8)
PAGED_COUNTERS = ("prefill_dispatches", "prefill_tokens", "cow_copies",
                  "host_syncs", "evictions", "decode_steps")


@functools.lru_cache(maxsize=None)
def _jax_paged(prefix_cache):
    jp, _ = _params()
    reqs = _shared(jax_apps)
    je = JaxEngine(JCFG, params=jp, prefix_cache=prefix_cache, **PAGED_KW)
    st = jax_drive(je, reqs)
    je.assert_drained()
    return (st["served"], [je.generated[r.req_id] for r in reqs],
            {n: getattr(je, n) for n in PAGED_COUNTERS})


@pytest.mark.parametrize("warmup", [False, True], ids=["lazy", "warmed"])
@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["radix_off", "radix_on"])
def test_paged_engine_matches_jax(prefix_cache, warmup):
    _, tp = _params()
    served, streams, counters = _jax_paged(prefix_cache)
    reqs = _shared(apps)
    te = PagedContinuousEngine(CFG, params=tp, device="cpu",
                               prefix_cache=prefix_cache, warmup=warmup,
                               **PAGED_KW)
    st = drive_paged(te, reqs)
    assert st["served"] == served == len(reqs)
    assert [te.generated[r.req_id] for r in reqs] == streams
    for name in PAGED_COUNTERS:
        assert getattr(te, name) == counters[name], name
    if prefix_cache:
        assert te.prefix_cache.hits > 0
    te.assert_drained()


def test_batch_engine_matches_jax():
    """One padded batch: streams, G(B) iterations, WMA and host syncs
    equal the JAX engine's."""
    jp, tp = _params()
    reqs = {}
    for name, mod in (("jax", jax_apps), ("port", apps)):
        reqs[name] = mod.make_dataset(2, seed=0)[:4]
        for i, r in enumerate(reqs[name]):
            r.gen_length = 3 + (i * 3) % 10
    je = JaxBatchEngine(JCFG, params=jp, max_gen=12)
    te = BatchEngine(CFG, params=tp, max_gen=12, device="cpu")
    jres = je.serve_batch(JaxBatch(requests=reqs["jax"]))
    tres = te.serve_batch(Batch(requests=reqs["port"]))
    for name in ("iterations", "batch_size", "batch_length", "wma",
                 "total_tokens", "valid_tokens"):
        assert getattr(tres, name) == getattr(jres, name), name
    assert [tres.generated[r.req_id] for r in reqs["port"]] == \
        [jres.generated[r.req_id] for r in reqs["jax"]]
    assert te.host_syncs == je.host_syncs


def test_launchers_serve_olmoe_as_jax():
    """``--arch olmoe-1b-7b`` through both launchers: the paged serve
    (``magnus-paged`` with the radix cache) counts what JAX's does, and
    the padded ``magnus`` serve forms JAX's batches with its WMA."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    jp, tp = _params()
    want = jax_serve.run_paged_engine_backend(ARCH, 2.0, 3.0, "magnus-paged",
                                              prefix_cache=True)
    got = serve.run_paged_engine_backend(ARCH, 2.0, 3.0, "magnus-paged",
                                         prefix_cache=True, device="cpu",
                                         params=tp)
    got.pop("engine").assert_drained()
    assert got["requests"] > 0
    for key in ("requests", "steps", "peak_concurrency", "evictions",
                "prefix_hits", "prefix_misses", "prefill_dispatches",
                "prefill_tokens", "cow_copies", "host_syncs", "shed"):
        assert got[key] == want[key], key
    jout = jax_serve.run_engine_backend(ARCH, 2.0, 3.0, "magnus")
    tout = serve.run_engine_backend(ARCH, 2.0, 3.0, "magnus", device="cpu",
                                    params=tp)
    for key in ("requests", "batches", "wma_total"):
        assert tout[key] == jout[key], key
    assert tout["requests"] > 0


# the coupling: capacity_factor 0.25 binds at every decode step of 4 slots
COUPLED = dict(max_concurrency=4, num_blocks=64, block_tokens=4,
               max_len=64, max_gen=12)


def _coupled_cfg(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))


def _coupled_reqs(mod):
    reqs = mod.make_dataset(2, seed=5)[:4]
    for r in reqs:
        r.gen_length = r.predicted_gen_length = 10
    return reqs


def test_capacity_couples_a_request_to_its_batch_mates():
    """Request 0 alone and with three others: the streams differ (its
    assignments compete for capacity with theirs), and in each case the
    port's stream equals JAX's."""
    jp, tp = _params()
    jcfg, tcfg = _coupled_cfg(JCFG), _coupled_cfg(CFG)
    out = {}
    for n in (1, 4):
        jreqs, treqs = _coupled_reqs(jax_apps)[:n], _coupled_reqs(apps)[:n]
        je = JaxEngine(jcfg, params=jp, **COUPLED)
        te = PagedContinuousEngine(tcfg, params=tp, device="cpu", **COUPLED)
        jax_drive(je, jreqs)
        drive_paged(te, treqs)
        assert [te.generated[r.req_id] for r in treqs] == \
            [je.generated[r.req_id] for r in jreqs]
        out[n] = te.generated[treqs[0].req_id]
    assert out[1] != out[4]


# ---------------------------------------------------------------------------
# f32 router, batch invariance, host reads
# ---------------------------------------------------------------------------

def test_router_stays_f32_in_bf16():
    jp, tp = _params()
    for tree in (cast_params(tp, torch.bfloat16),
                 params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu", dtype=torch.bfloat16),
                 init_params(CFG, generator=torch.Generator(), device="cpu",
                             dtype=torch.bfloat16)):
        ffn = tree["blocks"]["moe"]
        assert ffn["router"].dtype == torch.float32
        assert ffn["gate"].dtype == ffn["up"].dtype == ffn["down"].dtype \
            == torch.bfloat16
    assert tp["blocks"]["moe"]["router"].shape == (
        CFG.num_layers, CFG.d_model, CFG.moe.num_experts)


def test_batch_invariant_refuses_moe():
    _, tp = _params()
    pages = M.init_paged_cache(CFG, 8, 4, dtype=torch.float32, device="cpu")
    batch = {"tokens": torch.ones(2, dtype=torch.int32),
             "positions": torch.zeros(2, dtype=torch.int32),
             "block_tables": torch.tensor([[1], [2]], dtype=torch.int32)}
    M.decode_step_paged(tp, CFG, pages, batch, act_dtype=torch.float32)
    with M.batch_invariant():
        with pytest.raises(NotImplementedError, match="batch_invariant"):
            M.decode_step_paged(tp, CFG, pages, batch,
                                act_dtype=torch.float32)


@pytest.mark.parametrize("kind", ["capacity", "ragged"])
def test_moe_ffn_reads_nothing_on_the_host(kind):
    m, tp, x, gs, _ = _ffn_setup("binding")
    with count_host_reads() as reads:
        _port_ffn(kind, tp, torch.from_numpy(x), m, gs)
    assert reads["reads"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["capacity", "ragged"])
def test_moe_ffn_on_the_card_matches_cpu(kind, dtype):
    """Both FFNs on the card against the same call on the CPU (the port's
    own weights, 16 experts top 4, capacity binding), at 2e-4 of scale
    in f32 (TF32 off) and 5e-2 in bf16; and no host read on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        get_config(ARCH).reduced(max_experts=16),
        moe=dataclasses.replace(_moe_cfg("e16_top4"), capacity_factor=0.5))
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu", dtype=dtype)
    bp = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.randn(4, 50, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    want, want_aux = _port_ffn(kind, bp, x, cfg.moe, 64)
    gbp = {k: v.cuda() for k, v in bp.items()}
    with count_host_reads() as reads:
        got, aux = _port_ffn(kind, gbp, x.cuda(), cfg.moe, 64)
    assert reads["reads"] == 0
    _close(got.float().cpu(), want.float(),
           tol=2e-4 if dtype == torch.float32 else 5e-2)
    assert abs(aux.item() - want_aux.item()) <= 1e-5
