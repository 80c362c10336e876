"""``ContinuousEngine``'s decode step written in place and, on the card,
captured as one CUDA graph per engine (``serving/graphs.py``
``DecodeGraph.continuous``), the port's counterpart of the reference's
compiled decode (``_jitted``'s ``"decode"`` in its
``serving/engine.py``), with the token readback overlapped with the
step as the reference's is.

On the CPU, for a reduced chatglm-6b (dense), olmoe-1b-7b (MoE),
mamba2-780m (SSM), hymba-1.5b (hybrid), deepseek-v3-671b (MLA),
internvl2-26b (vlm) and whisper-large-v3 (enc-dec):

- the in-place engine run in lockstep with the JAX ``ContinuousEngine``
  (joins while there is room, then a step, the reference's serve loop)
  gives the same tokens and finish order at every step, one host sync a
  step;
- the addresses of every cache leaf, the logits, the device positions
  and the token buffer stay the same across joins, steps and finishes,
  and the device positions equal the host mirror after every call;
- the split step (``greedy_token_into``, then ``decode_step_fed_into``)
  equals ``decode_step`` run eagerly on a copy of the state, bit for bit;
- a CPU engine captures nothing (checked in the lockstep test).

On the card (``cuda``-marked; each family in f32 with TF32 off, and
chatglm-6b in bf16 too): the graphed engine's trace, logits, positions
and cache are bit-equal to an eager twin's (a subclass whose ``step``
runs ``decode_step`` eagerly and reads the tokens back after it), with
equal launch counts; it captures once, at its first step, across joins
made after it, and reads no tensor value on the host; its memory is
freed with it.
"""
import functools
import gc

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.serving.engine import ContinuousEngine as JaxContinuousEngine
from repro.workload import apps as jax_apps
from repro_torch.analysis.sanitizer import count_host_reads
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as scan_ops
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.workload import apps
from test_torch_dense_engine import _lockstep

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

ARCHS = ("chatglm-6b", "olmoe-1b-7b", "mamba2-780m", "hymba-1.5b",
         "deepseek-v3-671b", "internvl2-26b", "whisper-large-v3")
# two slots, four requests: two joins wait for a finish, so they come
# after the first step (the capture, on the card)
KW = dict(slots=2, max_len=32, max_gen=8)
GENS = (4, 2, 5, 3)
KERNELS = decode_ops.KERNELS + flash_ops.KERNELS + scan_ops.KERNELS


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jax_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return (jcfg, get_config(arch).reduced(), jp,
            params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))


def _reqs(mod, seed=0):
    reqs = mod.make_dataset(2, seed=seed)[:len(GENS)]
    for r, g in zip(reqs, GENS):
        r.gen_length = g
    return reqs


def _leaves(engine):
    return [t for key in sorted(engine.cache) for t in engine.cache[key]]


def _addresses(engine):
    return ([t.data_ptr() for t in _leaves(engine)]
            + [engine.logits.data_ptr(), engine.device_positions.data_ptr(),
               engine.tokens.data_ptr()])


def _watch(engine):
    """Wrap the engine's ``join`` and ``step``: after each call, every
    tensor the step reads is at its first address, and the device
    positions equal the host mirror.  Returns the number of calls
    checked, in a list that grows."""
    first, calls = _addresses(engine), []
    join, step = engine.join, engine.step

    def held(out):
        assert _addresses(engine) == first
        assert engine.device_positions.cpu().numpy().tolist() == \
            engine.positions.tolist()
        calls.append(1)
        return out

    engine.join = lambda req: held(join(req))
    engine.step = lambda: held(step())
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_in_place_engine_matches_jax_step_by_step(arch):
    """The same requests and weights: tokens and finish order equal the
    JAX engine's at every step, one host sync a step; a CPU engine runs
    its steps eagerly and captures nothing."""
    jcfg, cfg, jp, tp = _setup(arch)
    jtrace = _lockstep(JaxContinuousEngine(jcfg, params=jp, **KW),
                       _reqs(jax_apps))
    te = ContinuousEngine(cfg, params=tp, device="cpu", **KW)
    ttrace = _lockstep(te, _reqs(apps))
    assert len(ttrace) == len(jtrace)
    for step, (t, j) in enumerate(zip(ttrace, jtrace)):
        assert t == j, f"step {step}"
    assert te.host_syncs == len(ttrace)
    assert te.graph_captures == 0 and te.capture_time == 0.0
    assert te._graph is None


@pytest.mark.parametrize("arch", ARCHS)
def test_step_keeps_addresses_and_positions(arch):
    """Across joins, steps and finishes the cache leaves, logits, device
    positions and token buffer keep their addresses, and the device
    positions follow the host mirror (idle slots too)."""
    _, cfg, _, tp = _setup(arch)
    te = ContinuousEngine(cfg, params=tp, device="cpu", **KW)
    calls = _watch(te)
    trace = _lockstep(te, _reqs(apps, seed=1))
    assert len(calls) == len(GENS) + len(trace)
    assert not any(te.active)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_step_equals_decode_step(arch):
    """What a step runs, the argmax apart and the rest in place on the
    engine's tensors, equals ``decode_step`` on a copy of the state,
    bit for bit: tokens, logits, positions and every cache leaf."""
    _, cfg, _, tp = _setup(arch)
    te = ContinuousEngine(cfg, params=tp, device="cpu", **KW)
    for r in _reqs(apps, seed=2)[:2]:
        te.join(r)
    te.step()
    cache = {k: tuple(t.clone() for t in v) for k, v in te.cache.items()}
    logits, positions = te.logits.clone(), te.device_positions.clone()
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)
    want, _ = M.decode_step(tp, cfg, cache,
                            {"tokens": tok, "positions": positions},
                            act_dtype=torch.float32)
    M.greedy_token_into(cfg, te.logits, te.tokens)
    M.decode_step_fed_into(tp, cfg, te.cache,
                           {"logits": te.logits,
                            "positions": te.device_positions,
                            "tokens": te.tokens}, act_dtype=torch.float32)
    assert torch.equal(te.tokens, tok)
    assert torch.equal(te.logits, want)
    assert torch.equal(te.device_positions, positions + 1)
    for key in cache:
        for got, exp in zip(te.cache[key], cache[key]):
            assert torch.equal(got, exp)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


CARD_CASES = [(a, torch.float32) for a in ARCHS] + [
    ("chatglm-6b", torch.bfloat16)]
CARD_IDS = [f"{a.split('-')[0]}-f32" for a in ARCHS] + ["chatglm-bf16"]


class _EagerTwin(ContinuousEngine):
    """The step as the port ran it before its graph: ``decode_step``
    eagerly on the host positions' upload, the cache and logits rebound,
    the tokens read back after the whole step."""

    def step(self):
        if not any(self.active):
            return []
        tok = torch.argmax(self.logits[:, :self.cfg.vocab_size],
                           dim=-1).to(torch.int32)
        positions = torch.from_numpy(self.positions).to(self.device)
        logits, self.cache = M.decode_step(
            self.params, self.cfg, self.cache,
            {"tokens": tok, "positions": positions}, act_dtype=self.dtype)
        self.logits = logits.to(self.dtype)
        self.positions = self.positions + 1
        self.device_positions.copy_(positions + 1)
        tok_host = tok.cpu().numpy()
        self.host_syncs += 1
        for slot, a in enumerate(self.active):
            if a is not None:
                a["generated"].append(int(tok_host[slot]))
        finished = []
        for slot, a in enumerate(self.active):
            if a is not None and len(a["generated"]) >= a["target"]:
                finished.append(a["req"])
                self.active[slot] = None
                self.positions[slot] = 0
                self.device_positions[slot].fill_(0)
        return finished


def _launches():
    return {fn.__name__: fn.launches for fn in KERNELS}


def _served(engine, reqs):
    """``_lockstep`` on the engine; its trace and the launches it made."""
    l0 = _launches()
    trace = _lockstep(engine, reqs)
    torch.cuda.synchronize()
    return trace, {n: c - l0[n] for n, c in _launches().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", CARD_CASES, ids=CARD_IDS)
def test_graphed_engine_equals_eager_twin(card, arch, dtype):
    """The same weights and requests through the graphed engine and its
    eager twin: the same trace at every step, the same logits, positions
    and cache after it, bit for bit, and the same launches of every
    kernel: the decode kernel once a layer and step where the family
    attends (twice for the encoder-decoder family: self and cross)."""
    cfg = get_config(arch).reduced()
    eng = ContinuousEngine(cfg, seed=0, dtype=dtype, device="cuda", **KW)
    twin = _EagerTwin(cfg, seed=0, dtype=dtype, device="cuda", **KW)
    trace, launches = _served(eng, _reqs(apps, seed=4))
    ttrace, tlaunches = _served(twin, _reqs(apps, seed=4))
    assert trace == ttrace
    assert launches == tlaunches
    attends = cfg.family != "ssm" and not cfg.uses_mla
    per_step = (2 if cfg.family == "audio" else 1) * cfg.num_layers
    assert launches["decode_attention"] == (per_step * len(trace)
                                            if attends else 0)
    assert eng.host_syncs == twin.host_syncs == len(trace)
    assert torch.equal(eng.logits, twin.logits)
    assert torch.equal(eng.device_positions, twin.device_positions)
    for got, want in zip(_leaves(eng), _leaves(twin)):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", CARD_CASES, ids=CARD_IDS)
def test_one_capture_across_joins(card, arch, dtype):
    """The engine captures at its first step and replays at every later
    one, across the joins that wait for a finish; a step reads no tensor
    value on the host (its one readback is the tokens' copy)."""
    cfg = get_config(arch).reduced()
    eng = ContinuousEngine(cfg, seed=0, dtype=dtype, device="cuda", **KW)
    reqs = _reqs(apps, seed=5)
    for r in reqs[:KW["slots"]]:
        eng.join(r)
    assert eng.graph_captures == 0
    eng.step()
    assert eng.graph_captures == 1 and eng.capture_time > 0
    graph = eng._graph
    queue, steps, joins = list(reqs[KW["slots"]:]), 1, 0
    with count_host_reads() as reads:
        while queue or any(eng.active):
            while queue and eng.has_capacity:
                eng.join(queue.pop(0))
                joins += 1
            eng.step()
            steps += 1
    assert reads["reads"] == 0 and joins == len(reqs) - KW["slots"]
    assert eng.graph_captures == 1 and eng._graph is graph
    assert eng.host_syncs == steps
    assert not any(eng.active)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", CARD_CASES, ids=CARD_IDS)
def test_engine_memory_is_freed_with_it(card, arch, dtype):
    """Once a served engine is dropped, its weights, cache, graph and
    the graph's buffers are gone: the allocated bytes are back.  cuBLAS
    keeps a workspace for each stream it has run on (32 MiB on an H100,
    the capture stream's among them) outside any engine, so both counts
    are taken with its workspaces cleared, as PyTorch's own CUDA leak
    check takes them."""
    cfg = get_config(arch).reduced()

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        return torch.cuda.memory_allocated()

    before = allocated()
    eng = ContinuousEngine(cfg, seed=0, dtype=dtype, device="cuda", **KW)
    _lockstep(eng, _reqs(apps, seed=6))
    assert eng.graph_captures == 1
    del eng
    assert allocated() == before
