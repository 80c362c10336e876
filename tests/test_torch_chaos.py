"""The port's §14 lifecycle against the JAX reference on the CPU: the
reference's chaos harness (``tests/test_chaos.py``), each storm replayed
through both engines under the same ``FaultEvent`` plan, with the same
weights (carried by ``params_from_numpy``) and the same requests.

Every storm asserts the reference's degradation contract on the port (no
hang, no crash, no strand, surviving streams equal to the fault-free
run, ``served + shed`` accounts for every request) and parity with JAX:
identical streams, equal counters (``host_syncs``, ``evictions``,
``quarantined``, ``deadline_misses``, ``stall_ticks``, the swap counters
and the rest of ``COUNTERS``), equal fault-injector counters, the same
shed reasons for the same requests in the same order, and both pools
drained.  ``test_poisoned_draft_storm_keeps_verified_streams`` needs
speculative decoding (§16), which the port does not have yet.

The harness here (``run_pair``, ``assert_parity``) is shared with
``test_torch_swap.py`` and ``test_torch_sanitizer.py``."""
import copy
import functools

import jax
import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from repro.testing import given, settings
    from repro.testing import strategies as st

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.serving import engine as jax_engine
from repro.serving import faults as jax_faults
from repro.serving import paged_cache as jax_cache
from repro.workload import apps as jax_apps
from repro_torch.configs import get_config
from repro_torch.params import params_from_numpy
from repro_torch.serving import engine as torch_engine
from repro_torch.serving import faults as torch_faults
from repro_torch.serving import paged_cache as torch_cache
from repro_torch.serving.engine import EngineFull, PoolExhausted, drive_paged
from repro_torch.serving.faults import FAULT_SEQ, FaultEvent, Shed
from repro_torch.workload import apps

JCFG = jax_config("smollm-135m").reduced(num_layers=2, d_model=64)
CFG = get_config("smollm-135m").reduced(num_layers=2, d_model=64)
MAX_GEN = 10
BT = 4

#: engine counters the two packages must agree on after every run
COUNTERS = ("host_syncs", "evictions", "swap_outs", "swap_ins",
            "quarantined", "deadline_misses", "stall_ticks", "clock",
            "windows", "decode_steps", "prefill_tokens",
            "prefill_dispatches", "cow_copies", "requeue_prefix_hits",
            "swapped_blocks", "swap_reused_blocks",
            "reprefilled_swapped_tokens")

#: per side: engine module, faults module, paged-cache module, apps module
SIDES = {"jax": (jax_engine, jax_faults, jax_cache, jax_apps),
         "torch": (torch_engine, torch_faults, torch_cache, apps)}


@functools.lru_cache(maxsize=None)
def params():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def make_engine(side, plan=None, **kw):
    """``side``'s paged engine at the tiny config, with ``side``'s own
    ``FaultInjector`` over ``plan`` (FaultEvent keyword dicts; None: no
    injector).  Returns (engine, injector)."""
    eng_mod, faults_mod, cache_mod, _ = SIDES[side]
    inj = None if plan is None else faults_mod.FaultInjector(
        [faults_mod.FaultEvent(**e) for e in plan])
    if "allocator" in kw and isinstance(kw["allocator"], tuple):
        kw["allocator"] = cache_mod.BlockAllocator(*kw["allocator"])
    jp, tp = params()
    if side == "jax":
        eng = eng_mod.PagedContinuousEngine(JCFG, params=jp, faults=inj,
                                            **kw)
    else:
        eng = eng_mod.PagedContinuousEngine(CFG, params=tp, faults=inj,
                                            device="cpu", **kw)
    return eng, inj


def run_pair(reqs_fn, plan=None, *, drive=True, before=None, drive_kw=None,
             **kw):
    """Both sides under one plan: build each engine, run ``before(eng,
    reqs)`` (manual steps, optional), then ``drive_paged`` over what it
    returns (default: the requests).  Returns {side: (engine, injector,
    requests, stats)}."""
    out = {}
    for side in SIDES:
        eng, inj = make_engine(side, plan, **kw)
        reqs = reqs_fn(SIDES[side][3])
        todo = reqs if before is None else before(eng, reqs)
        stats = (SIDES[side][0].drive_paged(eng, todo, **(drive_kw or {}))
                 if drive else None)
        out[side] = (eng, inj, reqs, stats)
    return out


def _shed_view(shed, reqs):
    index = {r.req_id: i for i, r in enumerate(reqs)}
    return [(index[s.req.req_id], s.reason, s.clock) for s in shed]


def assert_parity(runs):
    """Streams, counters, injector counters, sheds and drive stats equal
    on both sides; both engines drained (fault-held blocks released)."""
    (je, jinj, jreqs, jst), (te, tinj, treqs, tst) = (runs["jax"],
                                                      runs["torch"])
    assert [te.generated.get(r.req_id) for r in treqs] == \
        [je.generated.get(r.req_id) for r in jreqs]
    for name in COUNTERS:
        assert getattr(te, name) == getattr(je, name), name
    assert _shed_view(te.shed_log, treqs) == _shed_view(je.shed_log, jreqs)
    if jinj is not None:
        assert tinj.counters() == jinj.counters()
        assert tinj.fired == jinj.fired
        jinj.release(je.allocator)
        tinj.release(te.allocator)
    if jst is not None:
        for key in ("served", "steps", "peak", "evictions", "host_syncs",
                    "deadline_misses", "quarantined", "retries_max",
                    "swap_outs", "swap_ins", "reprefilled_swapped_tokens",
                    "requeue_prefix_hits"):
            assert tst[key] == jst[key], key
        assert len(tst["unserved"]) == len(jst["unserved"])
    je.assert_drained()
    te.assert_drained()


_REQ_CACHE = {}


def _reqs(mod, n, max_gen=MAX_GEN, seed=0):
    """The reference's request list, canonical per (package, n, seed):
    the fault-free comparison keys on req_ids, so every run deep-copies
    the same base list."""
    key = (mod.__name__, n, max_gen, seed)
    if key not in _REQ_CACHE:
        reqs = mod.make_dataset(2, seed=seed)[:n]
        for i, r in enumerate(reqs):
            r.user_input = " ".join(r.user_input.split()[:6])
            r.gen_length = 3 + (i * 3) % max_gen
            r.predicted_gen_length = r.gen_length
        _REQ_CACHE[key] = reqs
    return copy.deepcopy(_REQ_CACHE[key])


def _kw(num_blocks=48, n=4, **kw):
    return dict(max_concurrency=n, num_blocks=num_blocks, block_tokens=BT,
                max_len=64, max_gen=MAX_GEN, **kw)


_REF_CACHE = {}


def _reference_streams(n, seed=0):
    """The port's fault-free streams keyed by req_id."""
    key = (n, seed)
    if key not in _REF_CACHE:
        eng, _ = make_engine("torch", **_kw(n=n))
        stats = drive_paged(eng, _reqs(apps, n, seed=seed))
        assert stats["served"] == n
        eng.assert_drained()
        _REF_CACHE[key] = dict(eng.generated)
    return _REF_CACHE[key]


def _assert_contract(run, n, seed=0):
    """The reference's degradation contract, on the port's run."""
    eng, inj, _, stats = run
    if inj is not None:
        inj.release(eng.allocator)
    assert not stats["unserved"], "hang: the loop exited with a live queue"
    assert stats["served"] + len(stats["shed"]) == n, \
        "unaccounted requests: neither served nor typed-shed"
    ref = _reference_streams(n, seed=seed)
    for rid, toks in eng.generated.items():
        assert toks == ref[rid], f"survivor {rid} diverged from reference"
    eng.assert_drained()
    assert not eng.allocator.tables.get(FAULT_SEQ)


def _storm(plan, n=4, **kw):
    runs = run_pair(lambda m: _reqs(m, n), plan, **_kw(n=n, **kw))
    assert_parity(runs)
    _assert_contract(runs["torch"], n)
    return runs["torch"]


# ---------------------------------------------------------------------------
# scripted storms
# ---------------------------------------------------------------------------

def test_allocator_exhaustion_storm_serves_everything():
    """Pool shrink mid-serve: evictions and retries, then the restore
    lets every request finish, nothing shed."""
    _, inj, _, stats = _storm(
        [dict(window=1, kind="pool_shrink", blocks=10),
         dict(window=4, kind="pool_restore")], num_blocks=20)
    kinds = [k for _, k in inj.fired]
    assert "pool_shrink" in kinds and "pool_restore" in kinds
    assert stats["served"] == 4 and not stats["shed"]


def test_underprediction_storm_escalates_and_finishes():
    """x4 under-prediction on every admission: the eviction storm damps
    (EWMA headroom + retry-budget escalation), it does not repeat."""
    eng, inj, _, stats = _storm(
        [dict(window=0, kind="predict_skew", factor=0.25)],
        num_blocks=24, retry_budget=2)
    assert inj.corrupted_predictions > 0
    assert stats["served"] == 4 and not stats["shed"]
    assert eng.mispredict.samples > 0
    assert max(eng.mispredict.factor(app)
               for app in eng.mispredict.ratio) > 1.0
    assert stats["retries_max"] <= eng.retry_budget + 2


def test_poisoned_logits_quarantine_is_surgical():
    """NaN poisoning of one slot: exactly that slot is quarantined and
    re-served; every stream (the victim's too) matches the reference."""
    eng, inj, _, stats = _storm(
        [dict(window=2, kind="poison_logits", slot=0)])
    assert inj.poisoned == 1
    assert eng.quarantined == 1 and stats["quarantined"] == 1
    assert stats["served"] == 4


def test_poisoned_draft_is_noop_without_speculation():
    """A draft poison against an engine without speculation is a
    recorded no-op."""
    _, inj, _, stats = _storm(
        [dict(window=1, kind="poison_draft_logits")], n=2, nan_guard=True)
    assert ("poison_draft_logits" in [k for _, k in inj.fired]
            and inj.draft_poisoned == 0)
    assert stats["served"] == 2 and not stats["shed"]


def test_deadline_storm_sheds_expired_requests():
    """Stalled windows burn the clock past tight TTLs: expired requests
    are shed with reason ``deadline``, counted, their blocks freed."""
    eng, _, _, stats = _storm([dict(window=1, kind="stall", ticks=50)],
                              default_ttl=8)
    assert eng.stall_ticks == 50
    assert stats["deadline_misses"] > 0
    assert all(s.reason == "deadline" for s in stats["shed"])
    assert len(stats["shed"]) == stats["deadline_misses"]


def test_radix_corruption_is_blocked_by_shadow(monkeypatch):
    """A rogue write into a cache-held radix block goes through the
    shadow: with REPRO_SANITIZE=1 it is blocked and counted, and serving
    goes on unaffected."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    _, inj, _, stats = _storm([dict(window=1, kind="radix_corrupt")],
                              allocator=(48, BT), prefix_cache=True)
    assert inj.radix_corruptions_blocked == 1
    assert inj.radix_probes_unchecked == 0
    assert stats["served"] == 4 and not stats["shed"]


# ---------------------------------------------------------------------------
# typed exceptions
# ---------------------------------------------------------------------------

def test_engine_full_has_typed_evicted_field():
    assert EngineFull().evicted == ()
    assert EngineFull("msg", evicted=()).evicted == ()
    e = PoolExhausted("boom")
    assert isinstance(e, MemoryError) and isinstance(e, EngineFull)
    assert e.evicted == () and e.culprit is None


def _foreign_squeeze(side):
    """An engine whose free pool a foreign sequence (seq 999 on the
    shared allocator) swallows after admission."""
    eng_mod, _, cache_mod, mod = SIDES[side]
    alloc = cache_mod.BlockAllocator(num_blocks=16, block_tokens=BT)
    eng, _ = make_engine(side, allocator=alloc, **_kw(num_blocks=16, n=1))
    reqs = _reqs(mod, 1)
    for r in reqs:
        r.gen_length = MAX_GEN
        r.predicted_gen_length = 1          # force decode-time growth
    return eng, alloc, reqs


def test_pool_exhausted_carries_culprit_and_leaves_engine_drainable():
    out = {}
    for side in SIDES:
        eng, alloc, reqs = _foreign_squeeze(side)
        assert eng.join_many(copy.deepcopy(reqs)) == 1
        alloc.allocate(999, len(alloc.free) * BT)
        exc = (PoolExhausted if side == "torch"
               else jax_engine.PoolExhausted)
        with pytest.raises(exc) as ei:
            for _ in range(2 * MAX_GEN):
                eng.step_window()
        e = ei.value
        assert isinstance(e, MemoryError)
        assert e.culprit is not None and e.culprit.req_id == reqs[0].req_id
        assert e.evicted == ()
        assert eng.num_active == 0
        alloc.free_seq(999)
        eng.assert_drained()
        out[side] = (str(e), eng.windows, eng.host_syncs, eng.evictions)
    assert out["torch"] == out["jax"]


def test_drive_paged_sheds_pool_exhausted_culprit_as_oom():
    """``drive_paged``'s catch site: a PoolExhausted window becomes a typed
    ``oom`` shed, never a crash or a hang, on both sides alike."""
    runs = {}
    for side in SIDES:
        eng, alloc, reqs = _foreign_squeeze(side)
        alloc.allocate(999, (len(alloc.free) - 4) * BT)   # room for one
        stats = SIDES[side][0].drive_paged(eng, copy.deepcopy(reqs),
                                           max_steps=200)
        alloc.free_seq(999)
        runs[side] = (eng, None, reqs, stats)
    _, _, reqs, stats = runs["torch"]
    assert stats["served"] == 0
    assert [s.reason for s in stats["shed"]] == ["oom"]
    assert stats["shed"][0].req.req_id == reqs[0].req_id
    assert not stats["unserved"]
    assert_parity(runs)


def test_shed_reason_is_validated():
    with pytest.raises(ValueError):
        Shed(req=None, reason="because")
    with pytest.raises(ValueError):
        FaultEvent(window=0, kind="meteor_strike")
    assert torch_engine.Shed is Shed      # re-exported for older callers


# ---------------------------------------------------------------------------
# requeue through the radix cache
# ---------------------------------------------------------------------------

def test_requeued_request_prefills_only_its_suffix():
    """An evicted-then-requeued request re-enters through the radix hit
    path: the readmission prefills only the uncached tail, on both
    sides alike."""
    def before(eng, reqs):
        req = reqs[0]
        slot = eng.join(req)
        first = eng.prefill_tokens
        assert eng._evict(slot).req_id == req.req_id
        eng.join(req)
        assert eng.requeue_prefix_hits == 1
        assert eng.prefill_tokens - first < first
        eng._evict(0 if eng.active[0] is not None else 1)
        return []

    runs = run_pair(lambda m: _reqs(m, 1), before=before,
                    **_kw(n=2, prefix_cache=True))
    assert_parity(runs)


# ---------------------------------------------------------------------------
# property: random fault schedules never break the contract
# ---------------------------------------------------------------------------

@settings(max_examples=4, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 5),
                          st.sampled_from(["pool_shrink", "stall",
                                           "poison_logits",
                                           "predict_skew"])),
                min_size=1, max_size=4),
       st.sampled_from([0.25, 0.5, 2.0]))
def test_random_fault_schedule_keeps_contract(events, factor):
    """The reference's property test, with no deadline (the first example
    pays one-off set-up time): random plans keep the contract and
    parity, and with no deadline and no retry cap everything is
    served."""
    plan = [dict(window=w, kind=k, blocks=8 if k == "pool_shrink" else 0,
                 factor=factor if k == "predict_skew" else 1.0,
                 ticks=3 if k == "stall" else 0) for w, k in events]
    plan.append(dict(window=8, kind="pool_restore"))
    _, _, _, stats = _storm(plan, num_blocks=24)
    assert stats["served"] == 4


# ---------------------------------------------------------------------------
# drive_paged's lifecycle knobs
# ---------------------------------------------------------------------------

def test_queue_cap_and_max_retries_shed_like_jax():
    """``queue_cap`` sheds the queue's tail as ``queue_full`` and
    ``max_retries`` sheds an over-evicted request as ``retry_budget``,
    on both sides alike (an under-prediction storm on a small pool)."""
    plan = [dict(window=0, kind="predict_skew", factor=0.25)]
    runs = run_pair(lambda m: _reqs(m, 6), plan,
                    drive_kw=dict(queue_cap=5, max_retries=0),
                    **_kw(num_blocks=16, n=4))
    _, _, _, stats = runs["torch"]
    reasons = [s.reason for s in stats["shed"]]
    assert reasons.count("queue_full") == 1
    assert "retry_budget" in reasons
    assert stats["served"] + len(stats["shed"]) == 6
    assert_parity(runs)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_lifecycle_flags_match_jax(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --strategy magnus-paged
    --ttl-steps ... --swap-blocks ... --device cpu`` serves the requests
    the reference's launcher serves with the same flags (``--backend
    engine``), with equal schedule, lifecycle and swap counters."""
    import json
    import sys

    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    flags = ["--arch", "smollm-135m", "--strategy", "magnus-paged",
             "--rate", "3", "--duration", "4", "--ttl-steps", "12",
             "--swap-blocks", "32"]
    serve.main(flags + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv",
                        ["serve"] + flags + ["--backend", "engine"])
    jax_serve.main()
    want = json.loads(capsys.readouterr().out)
    assert got["requests"] > 0 and got["device"] == "cpu"
    for key in ("requests", "steps", "peak_concurrency", "evictions",
                "prefill_dispatches", "prefill_tokens", "host_syncs",
                "mean_block_utilization", "retries_max", "deadline_misses",
                "quarantined", "shed", "requeue_prefix_hits", "swap_outs",
                "swap_ins", "swapped_blocks", "swap_reused_blocks",
                "reprefilled_swapped_tokens", "headroom"):
        assert got[key] == want[key], key
