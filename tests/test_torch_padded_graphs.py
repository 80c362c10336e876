"""The padded path's decode step as a captured CUDA graph
(``repro_torch/serving/graphs.py``, ``DecodeGraph.padded``), the port's
counterpart of the reference's compiled ``decode_multi`` window in
``BatchEngine.serve_batch``.

On the CPU, for a reduced chatglm-6b, mamba2-780m, olmoe-1b-7b,
hymba-1.5b (the hybrid family: KV and SSM state in one cache),
deepseek-v3-671b (the MLA family: a latent cache, decoded in plain
PyTorch) and internvl2-26b (the vlm family: zero patches in front of
the prompt, the decode positions offset by them): the
captured unit, ``decode_step_into`` (one greedy step written in place),
repeated ``k`` times equals ``decode_multi(k)`` bit for bit (tokens,
logits, positions and the dense cache or SSM state) and the JAX
``decode_multi`` at f32 from the same state; a CPU ``BatchEngine``
decodes eagerly and captures nothing.

On the card (``cuda``-marked, a reduced chatglm-6b in f32 and bf16, a
reduced mamba2-780m in f32, a reduced olmoe-1b-7b in bf16, its MoE
FFN inside the graph, a reduced hymba-1.5b in f32 and bf16, its
attention and SSM heads both inside the graph, its prefill in window
mode, a reduced deepseek-v3-671b in bf16, its absorbed MLA decode and
MoE FFN inside the graph and no attention kernel, and a reduced
internvl2-26b in bf16 behind its patch prefix): a ``BatchEngine`` batch
captures once,
and its streams, logits, positions and cache equal the same batch
decoded by eager ``decode_multi`` on a copy of its state, with the
kernels' launch counts equal to eager's; a batch of one step, or of
fewer than ``MIN_GRAPH_STEPS``, captures nothing; a served batch reads
nothing on the host but its one readback a window; and the batch's
memory is freed with it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.analysis.sanitizer import count_host_reads
from repro_torch.configs import get_config
from repro_torch.core.types import Batch
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as scan_ops
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import graphs
from repro_torch.serving.engine import BatchEngine
from repro_torch.workload import apps

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

TOL = 2e-4          # f32, of the reference's largest magnitude
ARCHS = ("chatglm-6b", "mamba2-780m", "olmoe-1b-7b", "hymba-1.5b",
         "deepseek-v3-671b", "internvl2-26b")
KERNELS = decode_ops.KERNELS + flash_ops.KERNELS + scan_ops.KERNELS


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jax_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return (jcfg, get_config(arch).reduced(), jp,
            params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))


def _allclose(got, want):
    """Max abs difference within TOL of the reference's largest magnitude
    (at least 1): random weights drive the SSM state to ~1e5 and the
    logits and K/V to tens."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (err,
                                                       np.abs(want).max())


def _jax_prefill(arch, b=3, s=16, cache_len=32, seed=0):
    """A JAX prefill of ``b`` right-padded prompts: its logits, its cache
    (numpy) and the rows' lengths."""
    jcfg, cfg, jp, _ = _setup(arch)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, cfg.vocab_size, size=(b, s)).astype(np.int32)
    lengths = np.array([s, 9, 1][:b], np.int32)
    batch = {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths)}
    if cfg.family == "vlm":
        batch["patches"] = jnp.zeros((b, cfg.num_patches, cfg.d_model))
        cache_len += cfg.num_patches
    logits, cache = JM.prefill(jp, jcfg, batch, act_dtype=jnp.float32,
                               cache_len=cache_len)
    return np.asarray(logits), jax.tree.map(np.asarray, cache), lengths


def _torch_state(logits, cache, lengths):
    return (torch.from_numpy(np.array(logits)),
            params_from_numpy(cache, device="cpu"),
            torch.from_numpy(lengths.copy()))


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_into_equals_decode_multi_and_jax(arch, k):
    """``k`` in-place steps from a JAX prefill's state against the port's
    fused window on a copy of the same state (bit for bit: tokens,
    logits, positions, every cache leaf) and the JAX fused window
    (tokens and positions equal, logits and cache at f32's 2e-4)."""
    jcfg, cfg, jp, tp = _setup(arch)
    jlogits, jcache, lengths = _jax_prefill(arch)
    logits, cache, positions = _torch_state(jlogits, jcache, lengths)
    state = {"logits": logits, "positions": positions}
    tok = torch.zeros(len(lengths), dtype=torch.int32)
    toks = []
    for _ in range(k):
        M.decode_step_into(tp, cfg, cache, state, tok,
                           act_dtype=torch.float32)
        toks.append(tok.clone())
    toks = torch.stack(toks, 1)
    flog, fcache, fpos, ftoks = M.decode_multi(
        tp, cfg, params_from_numpy(jcache, device="cpu"),
        {"logits": torch.from_numpy(np.array(jlogits)),
         "positions": torch.from_numpy(lengths.copy())},
        num_steps=k, act_dtype=torch.float32)
    assert torch.equal(toks, ftoks)
    assert torch.equal(state["logits"], flog)
    assert torch.equal(state["positions"], fpos)
    assert set(cache) == set(fcache) == set(jcache)
    for key in cache:
        for got, want in zip(cache[key], fcache[key]):
            assert torch.equal(got, want)
    jdec = jax.jit(functools.partial(JM.decode_multi, cfg=jcfg,
                                     act_dtype=jnp.float32),
                   static_argnames=("num_steps",))
    jlog, jc, jpos, jtoks = jdec(
        jp, cache=jax.tree.map(jnp.asarray, jcache),
        batch={"logits": jlogits, "positions": lengths}, num_steps=k)
    assert np.array_equal(toks.numpy(), np.asarray(jtoks))
    assert np.array_equal(state["positions"].numpy(), np.asarray(jpos))
    _allclose(state["logits"].numpy(), jlog)
    for key in cache:
        for got, want in zip(cache[key], jc[key]):
            _allclose(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_query_heads_size_the_private_counters(arch):
    """The graph sizes its split counters from the attention weights'
    query heads; the SSM family has none and the MLA family's decode is
    plain PyTorch, so neither launches a decode kernel and both plan
    none (the paged engine's sizing raised there)."""
    _, cfg, _, tp = _setup(arch)
    want = (0 if cfg.family == "ssm" or cfg.uses_mla
            else tp["blocks"]["attn"]["wq"].shape[2])
    assert graphs._query_heads(tp) == want


def _requests(n, gen, seed=0):
    reqs = apps.make_dataset(2, seed=seed)[:n]
    for i, r in enumerate(reqs):
        r.gen_length = gen if isinstance(gen, int) else gen(i)
    return reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_batch_engine_captures_nothing(arch):
    """A CPU engine decodes eagerly: a batch of several windows captures
    nothing, and its one readback a window stays the only host sync."""
    _, cfg, _, tp = _setup(arch)
    eng = BatchEngine(cfg, params=tp, max_gen=8, device="cpu")
    res = eng.serve_batch(Batch(requests=_requests(3, lambda i: 7 - 2 * i)))
    assert res.iterations == 7
    assert eng.graph_captures == 0 and eng.capture_time == 0.0
    assert eng.host_syncs == bin(7).count("1")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


CARD_CASES = [("chatglm-6b", torch.float32), ("chatglm-6b", torch.bfloat16),
              ("mamba2-780m", torch.float32), ("olmoe-1b-7b", torch.bfloat16),
              ("hymba-1.5b", torch.float32), ("hymba-1.5b", torch.bfloat16),
              ("deepseek-v3-671b", torch.bfloat16),
              ("internvl2-26b", torch.bfloat16)]
CARD_IDS = ["chatglm-f32", "chatglm-bf16", "mamba2-f32", "olmoe-bf16",
            "hymba-f32", "hymba-bf16", "deepseek-bf16", "internvl2-bf16"]


def _card_engine(arch, dtype, max_gen=16):
    return BatchEngine(get_config(arch).reduced(), seed=0, max_gen=max_gen,
                       dtype=dtype, device="cuda")


def _launches():
    return {fn.__name__: fn.launches for fn in KERNELS}


def _plain_calls():
    return sum(getattr(fn, "plain_calls", 0) for fn in KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", CARD_CASES, ids=CARD_IDS)
def test_captured_batch_equals_eager_decode(card, arch, dtype, monkeypatch):
    """A batch of G(B) = 13 (windows 8, 4, 1; 13 >= ``MIN_GRAPH_STEPS``)
    captures once; the state it
    was captured on is copied just before, and ``decode_multi`` run
    eagerly on the copy in the same windows gives the same streams, and
    leaves the same logits, positions and cache, bit for bit.  Launch
    counts grow as eagerly, with no plain call."""
    eng = _card_engine(arch, dtype)
    made = []
    padded = graphs.DecodeGraph.padded

    def keep(params, cfg, cache, logits, positions, **kw):
        copy = ({key: tuple(t.clone() for t in leaves)
                 for key, leaves in cache.items()},
                logits.clone(), positions.clone())
        g = padded(params, cfg, cache, logits, positions, **kw)
        made.append((g, cache, copy))
        return g

    monkeypatch.setattr(graphs.DecodeGraph, "padded", keep)
    reqs = _requests(3, lambda i: 13 - 4 * i, seed=1)
    l0, p0 = _launches(), _plain_calls()
    res = eng.serve_batch(Batch(requests=reqs))
    served = {n: c - l0[n] for n, c in _launches().items()}
    monkeypatch.undo()
    assert res.iterations == 13 and eng.graph_captures == 1
    assert eng.capture_time > 0 and len(made) == 1
    assert eng.host_syncs == bin(13).count("1")
    assert _plain_calls() == p0
    g, cache, (ecache, logits, positions) = made[0]
    l1, chunks = _launches(), []
    for k in (8, 4, 1):
        logits, ecache, positions, toks = M.decode_multi(
            eng.params, eng.cfg, ecache,
            {"logits": logits, "positions": positions}, num_steps=k,
            act_dtype=dtype)
        chunks.append(toks.cpu())
    eager = {n: c - l1[n] for n, c in _launches().items()}
    layers, family = eng.cfg.num_layers, eng.cfg.family
    attends = family != "ssm" and not eng.cfg.uses_mla
    prefill = {n: 0 for n in served}
    if attends:
        prefill["flash_attention"] = layers
    if family in ("ssm", "hybrid"):
        prefill["ssd_scan"] = layers
    assert {n: served[n] - eager[n] for n in served} == prefill
    assert eager["decode_attention"] == (layers * 13 if attends else 0)
    toks = torch.cat(chunks, 1)
    for i, r in enumerate(reqs):
        assert res.generated[r.req_id] == toks[i, :r.gen_length].tolist()
    assert torch.equal(g.state["logits"], logits)
    assert torch.equal(g.state["positions"], positions)
    for key, leaves in cache.items():
        for got, want in zip(leaves, ecache[key]):
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", CARD_CASES, ids=CARD_IDS)
def test_short_batch_captures_nothing(card, arch, dtype):
    """G(B) = 1 (no step to replay) and G(B) = MIN_GRAPH_STEPS - 1 (below
    the measured break-even): eager steps, one readback a window, no
    capture."""
    eng = _card_engine(arch, dtype)
    syncs = 0
    for gen in sorted({1, engine_mod.MIN_GRAPH_STEPS - 1}):
        res = eng.serve_batch(Batch(requests=_requests(2, gen, seed=2)))
        syncs += bin(gen).count("1")
        assert res.iterations == gen
        assert eng.graph_captures == 0 and eng.host_syncs == syncs


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", CARD_CASES, ids=CARD_IDS)
def test_replayed_window_reads_nothing(card, arch, dtype):
    """A whole served batch (prefill, capture, replayed windows) reads no
    tensor value on the host; its readbacks are one a window.  A window
    of replays on a graph made by hand reads nothing either."""
    eng = _card_engine(arch, dtype)
    reqs = _requests(3, 11, seed=3)
    with count_host_reads() as reads:
        res = eng.serve_batch(Batch(requests=reqs))
    assert reads["reads"] == 0 and eng.graph_captures == 1
    assert eng.host_syncs == bin(res.iterations).count("1")
    tokens = torch.randint(3, eng.cfg.vocab_size, (3, 16), device="cuda",
                           dtype=torch.int32)
    lengths = torch.tensor([16, 9, 4], dtype=torch.int32, device="cuda")
    batch = {"tokens": tokens, "lengths": lengths}
    if eng.cfg.family == "vlm":
        batch["patches"] = eng._patches(3)
    logits, cache = M.prefill(eng.params, eng.cfg, batch, act_dtype=dtype,
                              cache_len=32 + eng.cfg.num_patches)
    g = graphs.DecodeGraph.padded(eng.params, eng.cfg, cache, logits,
                                  lengths, act_dtype=dtype, max_steps=8,
                                  stream=torch.cuda.Stream())
    with count_host_reads() as reads:
        toks = g.window(8, 1)
    assert reads["reads"] == 0
    assert torch.equal(g.state["positions"], lengths + 8)
    assert toks.shape == (3, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", CARD_CASES, ids=CARD_IDS)
def test_batch_memory_is_freed_with_the_batch(card, arch, dtype):
    """After ``serve_batch`` returns, the batch's cache, its graph and
    the graph's buffers are gone: the allocated bytes are back at their
    level before the batch, batch after batch."""
    eng = _card_engine(arch, dtype)
    eng.serve_batch(Batch(requests=_requests(2, 9, seed=4)))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gens = (9, 1, 12)
    for seed, (n, gen) in enumerate(zip((3, 1, 2), gens), start=5):
        eng.serve_batch(Batch(requests=_requests(n, gen, seed=seed)))
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == before
    assert eng.graph_captures == 1 + sum(
        g >= engine_mod.MIN_GRAPH_STEPS for g in gens)
