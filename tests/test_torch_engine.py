"""The PyTorch port's PagedContinuousEngine against the JAX reference on
the CPU: the same weights (carried by ``params_from_numpy``) and the same
requests must give identical greedy token streams and equal
``prefill_dispatches``, ``prefill_tokens``, ``cow_copies``,
``host_syncs`` and ``evictions``, with both pools drained.  Fixtures
follow the reference's engine tests: scripted lengths, a prediction
undershoot that forces evict-and-requeue, shared-instruction traffic
with the radix cache on and off (partial-tail copy-on-write), and a
radix-aware admission wave with byte-identical retries.  Also: the
launcher serves the same requests as the reference's, the fused window
property test, the per-token baseline (``fuse=False``) against the fused
engine and JAX's, and ``warmup()``: it writes nothing a request can
read, a second call changes nothing, and a warmed engine serves what an
unwarmed one and JAX's serve.  (A CPU engine runs its decode eagerly;
the captured CUDA graph is tested on the card, in
``test_torch_graphs.py``.)"""
import copy
import functools

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from repro.testing import given, settings
    from repro.testing import strategies as st

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.serving.engine import PagedContinuousEngine as JaxEngine
from repro.serving.engine import drive_paged as jax_drive
from repro.workload import apps as jax_apps
from repro_torch.configs import get_config
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
from repro_torch.workload import apps

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

JCFG = jax_config("smollm-135m").reduced(num_layers=2, d_model=64)
CFG = get_config("smollm-135m").reduced(num_layers=2, d_model=64)
COUNTERS = ("prefill_dispatches", "prefill_tokens", "cow_copies",
            "host_syncs", "evictions", "decode_steps")


@functools.lru_cache(maxsize=None)
def _params():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _scripted(mod, n, seed, short=False, max_gen=10):
    reqs = mod.make_dataset(2, seed=seed)[:n]
    for i, r in enumerate(reqs):
        if short:
            r.user_input = " ".join(r.user_input.split()[:6])
        r.gen_length = 3 + (i * 3) % max_gen
        r.predicted_gen_length = r.gen_length
    return reqs


def _undershoot(mod):
    reqs = _scripted(mod, 5, seed=3, short=True)
    for r in reqs:
        r.gen_length = 12
        r.predicted_gen_length = 2           # severe undershoot
    return reqs


def _shared(mod, n=6, seed=3, gen=6, instr_words=14, input_words=5):
    # 14 instruction words + BOS = 15 tokens: ends mid-block at
    # block_tokens=4, so hits share a partial tail (copy-on-write)
    reqs = mod.make_shared_prefix_dataset(
        n, n_apps=2, instr_words=instr_words, input_words=input_words,
        gen_length=gen, seed=seed)
    for i, r in enumerate(reqs):
        r.gen_length = 2 + (i * 3) % gen
        r.predicted_gen_length = r.gen_length
    return reqs


def _wave_with_retries(mod):
    reqs = _shared(mod, n=6, seed=11, instr_words=14, input_words=6)
    return reqs + [copy.deepcopy(r) for r in reqs[:2]]   # same prompts


CASES = {
    "scripted": (lambda m: _scripted(m, 3, seed=2),
                 dict(max_concurrency=4, num_blocks=32, block_tokens=16,
                      max_len=128, max_gen=16)),
    "evict_requeue": (_undershoot,
                      dict(max_concurrency=6, num_blocks=10, block_tokens=8,
                           max_len=64, max_gen=16)),
    "prefix_off": (_shared,
                   dict(max_concurrency=3, num_blocks=64, block_tokens=4,
                        max_len=64, max_gen=8, prefix_cache=False)),
    "prefix_on": (_shared,
                  dict(max_concurrency=3, num_blocks=64, block_tokens=4,
                       max_len=64, max_gen=8, prefix_cache=True)),
    "wave_retries": (_wave_with_retries,
                     dict(max_concurrency=6, num_blocks=192, block_tokens=4,
                          max_len=64, max_gen=8, prefix_cache=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax(case):
    make, kw = CASES[case]
    jp, tp = _params()
    jreqs, treqs = make(jax_apps), make(apps)
    je = JaxEngine(JCFG, params=jp, **kw)
    te = PagedContinuousEngine(CFG, params=tp, device="cpu", **kw)
    js = jax_drive(je, jreqs)
    ts = drive_paged(te, treqs)
    assert ts["served"] == js["served"] == len(treqs)
    assert [te.generated[r.req_id] for r in treqs] == \
        [je.generated[r.req_id] for r in jreqs]
    for name in COUNTERS:
        assert getattr(te, name) == getattr(je, name), name
    assert ts["host_syncs"] == js["host_syncs"]
    assert ts["peak"] == js["peak"]
    if kw.get("prefix_cache"):
        assert te.prefix_cache.hits == je.prefix_cache.hits > 0
        assert te.prefix_cache.misses == je.prefix_cache.misses
    if case == "prefix_on":
        assert te.cow_copies > 0
    if case == "evict_requeue":
        assert te.evictions >= 1
    te.assert_drained()
    je.assert_drained()


def test_launcher_serves_the_same_requests_as_jax():
    from repro.launch.serve import run_paged_engine_backend as jax_run
    from repro_torch.launch.serve import run_paged_engine_backend

    jcfg = jax_config("smollm-135m").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    want = jax_run("smollm-135m", 2.0, 3.0, "magnus-paged",
                   prefix_cache=True)
    got = run_paged_engine_backend(
        "smollm-135m", 2.0, 3.0, "magnus-paged", prefix_cache=True,
        device="cpu", params=params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    got.pop("engine").assert_drained()
    assert got["requests"] > 0
    for key in ("requests", "steps", "peak_concurrency", "evictions",
                "prefix_hits", "prefix_misses", "prefill_dispatches",
                "prefill_tokens", "cow_copies", "host_syncs",
                "mean_block_utilization", "shed", "headroom"):
        assert got[key] == want[key], key


def test_launcher_spec_decode_matches_jax():
    """The launcher's ``spec_decode`` (a self-draft, as in the
    reference): the same requests, streams' counts and §16 keys as the
    reference launcher's."""
    from repro.launch.serve import run_paged_engine_backend as jax_run
    from repro_torch.launch.serve import run_paged_engine_backend

    jcfg = jax_config("smollm-135m").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    want = jax_run("smollm-135m", 2.0, 2.0, "magnus-paged",
                   prefix_cache=True, spec_decode=True, draft_k=2)
    got = run_paged_engine_backend(
        "smollm-135m", 2.0, 2.0, "magnus-paged", prefix_cache=True,
        spec_decode=True, draft_k=2, device="cpu", params=params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    eng = got.pop("engine")
    eng.assert_drained()
    assert eng.draft_params is eng.params
    assert got["requests"] > 0 and got["spec_windows"] > 0
    assert got["acceptance_rate"] == 1.0
    for key in ("requests", "steps", "peak_concurrency", "evictions",
                "prefix_hits", "prefill_dispatches", "prefill_tokens",
                "host_syncs", "spec_windows",
                "accepted_per_dispatch", "acceptance_rate",
                "draft_quarantined", "draft_prefill_tokens", "shed"):
        assert got[key] == want[key], key


_PROP_ENGINE = {}


def _prop_engine():
    """One engine reused across examples (drained between runs)."""
    if "eng" not in _PROP_ENGINE:
        _PROP_ENGINE["eng"] = PagedContinuousEngine(
            CFG, params=_params()[1], max_concurrency=4, num_blocks=12,
            block_tokens=8, max_len=64, max_gen=16, device="cpu")
    return _PROP_ENGINE["eng"]


@settings(max_examples=5, deadline=None)
@given(st.integers(min_value=1, max_value=5),
       st.lists(st.tuples(st.integers(min_value=1, max_value=12),
                          st.integers(min_value=1, max_value=12)),
                min_size=5, max_size=5),
       st.integers(min_value=0, max_value=10_000))
def test_fusion_windows_never_skip_events(n, gens, seed):
    """Random (target, prediction) workloads through the fused engine:
    after every window no request decoded past its target and no
    position outran its block table, and every request finishes with
    exactly its target tokens (the reference's property test, with no
    deadline: the first example pays one-off set-up time)."""
    from collections import deque
    eng = _prop_engine()
    reqs = _scripted(apps, n, seed=seed % 7, short=True)
    for r, (g, pred) in zip(reqs, gens):
        r.gen_length = g
        r.predicted_gen_length = pred
    pending = deque(reqs)
    done, guard = 0, 0
    while (pending or eng.num_active) and guard < 400:
        for _ in range(eng.join_many(pending)):
            pending.popleft()
        finished, evicted, k = eng.step_window()
        done += len(finished)
        for r in reversed(evicted):
            pending.appendleft(r)
        for slot, a in enumerate(eng.active):
            if a is None:
                continue
            assert len(a["generated"]) <= a["target"]
            cap = len(eng.allocator.tables[slot]) * eng.bt
            assert int(eng.pos_host[slot]) <= cap
        guard += max(k, 1)
    assert done == len(reqs)
    for r in reqs:
        assert len(eng.generated[r.req_id]) == min(r.gen_length, 16)
    assert eng.allocator.used_blocks == 1
    eng.assert_drained()


FUSE_KW = dict(max_concurrency=4, num_blocks=48, block_tokens=8,
               max_len=128, max_gen=16)


@pytest.mark.parametrize("fuse", [False, True])
def test_fuse_flag_matches_jax(fuse):
    """``fuse`` has the reference's meaning: the port's engine with
    ``fuse`` serves the streams, and counts the steps and host syncs, of
    the JAX engine with the same ``fuse``."""
    jp, tp = _params()
    jreqs, treqs = (_scripted(m, 4, seed=2, short=True)
                    for m in (jax_apps, apps))
    je = JaxEngine(JCFG, params=jp, fuse=fuse, **FUSE_KW)
    te = PagedContinuousEngine(CFG, params=tp, device="cpu", fuse=fuse,
                               **FUSE_KW)
    js, ts = jax_drive(je, jreqs), drive_paged(te, treqs)
    assert ts["served"] == js["served"] == len(treqs)
    assert [te.generated[r.req_id] for r in treqs] == \
        [je.generated[r.req_id] for r in jreqs]
    for name in COUNTERS:
        assert getattr(te, name) == getattr(je, name), name
    assert (ts["steps"], ts["host_syncs"]) == (js["steps"], js["host_syncs"])
    te.assert_drained()


def test_fused_engine_matches_per_token_engine():
    """The port of the reference's ``test_fused_decode`` engine test:
    ``fuse=True`` and ``fuse=False`` give identical streams in the same
    steps, and fusion cuts the host syncs."""
    _, tp = _params()
    out, syncs, steps = {}, {}, {}
    for fuse in (False, True):
        eng = PagedContinuousEngine(CFG, params=tp, device="cpu", fuse=fuse,
                                    **FUSE_KW)
        reqs = _scripted(apps, 4, seed=2, short=True)
        stats = drive_paged(eng, reqs)
        assert stats["served"] == len(reqs)
        out[fuse] = [eng.generated[r.req_id] for r in reqs]
        syncs[fuse], steps[fuse] = stats["host_syncs"], stats["steps"]
    assert out[True] == out[False]
    assert steps[True] == steps[False]
    assert syncs[True] < syncs[False] == steps[False]


def _engine_state(eng):
    """Everything a request can read: the pool outside the null block,
    the tables, positions, active mask and carried logits, and the swap
    tier's slots in use (with its free list and maps, as tensors)."""
    keep = torch.ones(eng.allocator.num_blocks, dtype=torch.bool)
    keep[eng.null_block] = False
    state = ([eng.pages[key][:, keep].clone() for key in ("k", "v")]
             + [t.clone() for t in (eng.tables, eng.positions,
                                    eng.active_mask, eng.logits)])
    if eng.swap is not None:
        used = sorted(eng.swap.slot_ref)
        state += [eng.swap._store[used].clone(),
                  torch.tensor(eng.swap.free + [-1] + used),
                  torch.tensor([s for m in eng.swap.maps.values()
                                for s in m])]
        state += [eng._swapped[rid]["logits"].clone()
                  for rid in sorted(eng._swapped)]
    return state


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


WARM_KW = dict(max_concurrency=4, num_blocks=96, block_tokens=4,
               max_len=64, max_gen=8, prefix_cache=True, swap_blocks=16)


def test_warmup_writes_nothing_and_is_idempotent():
    """``warmup()`` in the middle of a serve (requests admitted, pages
    written, a window decoded, stale logits in idle slots, one request
    suspended on the host swap tier) leaves every tensor a request can
    read bit-equal, the tier's slots in use and its books included, and
    so does a second call (the null block is the write sink: duplicate
    pad writes leave it junk in no fixed order; the swap pass moves it
    through a free tier slot); the serve then goes on, the suspended
    request resumed, exactly as on an engine that was never warmed,
    which equals JAX's."""
    jp, tp = _params()
    streams = {}
    for warm in (True, False, "jax"):
        reqs = _shared(jax_apps if warm == "jax" else apps)
        eng = (JaxEngine(JCFG, params=jp, **WARM_KW) if warm == "jax" else
               PagedContinuousEngine(CFG, params=tp, device="cpu",
                                     **WARM_KW))
        n = eng.join_many(reqs[:3])
        assert n == 3
        eng.step_window(max_steps=2)
        assert eng._swap_out(1) and eng.num_suspended == 1
        if warm is True:
            before = _engine_state(eng)
            eng.warmup()
            once = _engine_state(eng)
            eng.warmup()
            _assert_same(before, once)
            _assert_same(once, _engine_state(eng))
        (jax_drive if warm == "jax" else drive_paged)(eng, reqs[3:])
        assert all(r.req_id in eng.generated for r in reqs)
        assert eng.swap_ins == 1 and eng.reprefilled_swapped_tokens == 0
        streams[warm] = [eng.generated[r.req_id] for r in reqs]
        eng.assert_drained()
    assert streams[True] == streams[False] == streams["jax"]


@pytest.mark.parametrize("case", ["evict_requeue", "prefix_on"])
def test_warmed_engine_matches_jax(case):
    """``warmup=True`` at construction, as in the reference: the warmed
    engine serves JAX's streams and counts (the waves' sacrificial state
    updates and the decode's idle window leave no trace)."""
    make, kw = CASES[case]
    jp, tp = _params()
    jreqs, treqs = make(jax_apps), make(apps)
    je = JaxEngine(JCFG, params=jp, **kw)
    te = PagedContinuousEngine(CFG, params=tp, device="cpu", warmup=True,
                               **kw)
    assert te.graph_captures == 0         # a CPU engine captures nothing
    js, ts = jax_drive(je, jreqs), drive_paged(te, treqs)
    assert ts["served"] == js["served"] == len(treqs)
    assert [te.generated[r.req_id] for r in treqs] == \
        [je.generated[r.req_id] for r in jreqs]
    for name in COUNTERS:
        assert getattr(te, name) == getattr(je, name), name
    te.assert_drained()


@pytest.mark.parametrize("spec", [False, True], ids=["spec_off", "spec_on"])
@pytest.mark.parametrize("case", ["evict_requeue", "prefix_on"])
def test_can_admit_matches_jax_and_the_next_join(case, spec):
    """``can_admit`` (the reference's admission probe: free blocks plus
    what radix eviction could reclaim, less a hit's shared blocks, plus
    a speculative engine's draft copy of the reservation), asked before
    every ``join`` of a one-at-a-time serve: the port's answer equals
    JAX's, and equals whether that join succeeds.  With speculation on,
    the pool is twice the fixture's (each request's draft pool is a
    private copy of its reservation)."""
    from collections import deque
    from repro.serving.engine import EngineFull as JaxEngineFull
    from repro_torch.serving.engine import EngineFull
    make, kw = CASES[case]
    jp, tp = _params()
    kw = dict(kw, spec_decode=spec,
              num_blocks=kw["num_blocks"] * (2 if spec else 1))
    answers, streams = {}, {}
    for side in ("jax", "torch"):
        reqs = make(jax_apps if side == "jax" else apps)
        eng = (JaxEngine(JCFG, params=jp, **kw) if side == "jax" else
               PagedContinuousEngine(CFG, params=tp, device="cpu", **kw))
        pending, said = deque(reqs), []
        for _ in range(400):
            if not (pending or eng.num_active):
                break
            if pending:
                ok = eng.can_admit(pending[0])
                try:
                    eng.join(pending[0])
                    joined = True
                except (EngineFull, JaxEngineFull):
                    joined = False
                assert ok == joined, (side, len(said))
                said.append(ok)
                if joined:
                    pending.popleft()
                    continue
            _, evicted, _ = eng.step_window()
            pending.extendleft(reversed(evicted))
        assert not pending and not eng.num_active
        eng.assert_drained()
        answers[side] = said
        streams[side] = [eng.generated[r.req_id] for r in reqs]
    assert answers["torch"] == answers["jax"]
    assert False in answers["torch"] and True in answers["torch"]
    assert streams["torch"] == streams["jax"]
