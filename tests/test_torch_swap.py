"""The port's §15 host swap tier against the JAX reference on the CPU:
the reference's ``tests/test_swap.py``, under ``REPRO_SANITIZE=1`` for
the whole module (the shadow allocator tracks cross-tier residency),
each engine test run through both engines with the same weights,
requests and ``FaultEvent`` plan (the harness of
``test_torch_chaos.py``): identical streams and counters, the same shed
reasons in the same order, both pools and both tiers drained.

The port writes every tensor a captured decode graph reads in place:
``test_inplace_writes_keep_addresses`` holds the addresses of the
logits, positions, tables, active mask and pools across a poison, a
quarantine, a swap-out and a resume (``_restore_slot``,
``scatter_pages``); ``test_spec_inplace_writes_keep_addresses`` holds
those and the speculative window's (the draft logits, tables and pool)
across a draft quarantine, a swap-out that drops the draft pool and a
resume that rebuilds it.

On the card (``cuda``-marked, the tiny config in f32 with the decode
graph captured): the same addresses hold and are the graph's own, the
graphed engine's streams and counters under a poison, a pool shrink and
a forced swap round trip equal the CPU engine's, and the tier's store
is pinned."""
import copy
import os

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from repro_torch.testing import given, settings
    from repro_torch.testing import strategies as st

from repro.core import types as jax_types
from repro_torch.analysis.sanitizer import (SWAP_HOLDER, ShadowAllocator,
                                            SharedWriteError,
                                            SwappedBlockError)
from repro_torch.core import types as torch_types
from repro_torch.core.types import ShedReason
from repro_torch.models import model as M
from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
from repro_torch.serving.faults import FaultEvent, FaultInjector
from repro_torch.serving.paged_cache import BlockAllocator, HostSwapTier

from test_torch_chaos import (CFG, SIDES, SPEC_COUNTERS, assert_parity,
                              make_engine, run_pair)

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

MAX_GEN = 10
BT = 4
TYPES = {"jax": jax_types, "torch": torch_types}


@pytest.fixture(autouse=True, scope="module")
def _sanitize():
    old = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    yield
    if old is None:
        os.environ.pop("REPRO_SANITIZE", None)
    else:
        os.environ["REPRO_SANITIZE"] = old


def _kw(num_blocks=24, *, n=4, swap_blocks=64, **kw):
    return dict(max_concurrency=n, num_blocks=num_blocks, block_tokens=BT,
                max_len=64, max_gen=MAX_GEN, swap_blocks=swap_blocks, **kw)


_REQ_CACHE = {}


def _reqs(side, n, seed=0):
    """Distinct-instruction requests (no radix sharing, so real pool
    pressure), canonical per (side, n, seed)."""
    key = (side, n, seed)
    if key not in _REQ_CACHE:
        _REQ_CACHE[key] = [
            TYPES[side].Request(
                app=f"a{i % 3}", task="t",
                instruction=f"distinct instruction {seed} {i} words",
                user_input=f"user input number {i} more text",
                length=14, gen_length=3 + (i * 3) % MAX_GEN,
                predicted_gen_length=1)
            for i in range(n)]
    return copy.deepcopy(_REQ_CACHE[key])


def _pair(n, plan=None, **kw):
    """``run_pair`` on this module's requests (the side is found from the
    apps module the harness passes)."""
    side_of = {SIDES[s][3]: s for s in SIDES}
    return run_pair(lambda mod: _reqs(side_of[mod], n), plan, **kw)


_REF_CACHE = {}


def _reference_streams(n, seed=0):
    """The port's fault-free streams from a roomy engine, keyed by req_id."""
    key = (n, seed)
    if key not in _REF_CACHE:
        eng, _ = make_engine("torch", **_kw(num_blocks=96, n=n,
                                            swap_blocks=0))
        stats = drive_paged(eng, _reqs("torch", n, seed=seed))
        assert stats["served"] == n
        eng.assert_drained()
        _REF_CACHE[key] = dict(eng.generated)
    return _REF_CACHE[key]


def _suspend_first(eng, reqs, slot=0):
    """Admit ``reqs``, decode one window, suspend ``slot``; nothing left
    to admit."""
    assert eng.join_many(copy.deepcopy(reqs)) == len(reqs)
    eng.step_window()
    assert eng._swap_out(slot)
    return []


# ---------------------------------------------------------------------------
# tier unit: round trip bit for bit, dedup, drain
# ---------------------------------------------------------------------------

def test_tier_roundtrip_bitexact():
    """The port's tier and JAX's hold and hand back the same pages, bit
    for bit, in the same slots."""
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((2, 1, 4, 2, 2, 4), dtype=np.float32)
    out = {}
    for side, v in (("jax", vals), ("torch", torch.from_numpy(vals))):
        cache = SIDES[side][2]
        alloc = cache.BlockAllocator(num_blocks=8, block_tokens=2)
        tier = (cache.HostSwapTier(16) if side == "jax" else
                cache.HostSwapTier(16, (2, 1, 2, 2, 4), torch.float32))
        table = alloc.allocate(0, 8)                   # 4 blocks
        fresh = tier.fresh_blocks(table)
        assert fresh == list(table)
        alloc.free_seq(0)
        tier.swap_out(7, table, fresh, v, alloc)
        shared, slots = tier.split_resident(7)
        assert shared == [] and len(slots) == len(table)
        out[side] = (slots, np.asarray(tier.read(slots)))
        tier.drop(7, alloc)
        assert tier.empty and not tier.device_holds()
    assert out["torch"][0] == out["jax"][0]
    np.testing.assert_array_equal(out["torch"][1], vals)   # not close
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])


def test_tier_roundtrip_through_scattered_slots():
    """Images over slots freed out of order (so a copy spans several runs
    of the store) come back bit for bit, in the same slots as JAX's."""
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((2, 1, 9, 2, 2, 4), dtype=np.float32)
    out = {}
    for side in ("jax", "torch"):
        cache = SIDES[side][2]
        v = vals if side == "jax" else torch.from_numpy(vals)
        alloc = cache.BlockAllocator(num_blocks=16, block_tokens=2)
        tier = (cache.HostSwapTier(8) if side == "jax" else
                cache.HostSwapTier(8, (2, 1, 2, 2, 4), torch.float32))
        for key, (seq, lo, hi) in enumerate(((0, 0, 2), (1, 2, 4))):
            table = alloc.allocate(seq, 2 * (hi - lo))
            alloc.free_seq(seq)
            tier.swap_out(key, table, tier.fresh_blocks(table),
                          v[:, :, lo:hi], alloc)
        tier.drop(0, alloc)                  # frees slots 0-1: reused last
        table = alloc.allocate(2, 10)        # 5 blocks: slots 1, 0, 4-6
        alloc.free_seq(2)
        tier.swap_out(2, table, tier.fresh_blocks(table), v[:, :, 4:],
                      alloc)
        got = [tier.split_resident(k)[1] for k in (1, 2)]
        out[side] = (got, [np.asarray(tier.read(g)) for g in got])
        for k in (1, 2):
            tier.drop(k, alloc)
        assert tier.empty
    assert out["torch"][0] == out["jax"][0]
    assert len(HostSwapTier._runs(out["torch"][0][1])) > 1
    np.testing.assert_array_equal(out["torch"][1][0], vals[:, :, 2:4])
    np.testing.assert_array_equal(out["torch"][1][1], vals[:, :, 4:])
    for t, j in zip(out["torch"][1], out["jax"][1]):
        np.testing.assert_array_equal(t, j)


def test_tier_dedups_shared_blocks():
    """Two images over the same still-live blocks swap the pages ONCE;
    the tier's device holds certify them immutable until both drop."""
    alloc = BlockAllocator(num_blocks=8, block_tokens=2)
    table = alloc.allocate(0, 4)                   # 2 shared blocks
    alloc.share(1, list(table))
    vals = torch.arange(2 * len(table) * 2 * 2,
                        dtype=torch.float32).reshape(2, 1, len(table), 2, 2,
                                                     1)
    tier = HostSwapTier(16, (2, 1, 2, 2, 1), torch.float32)
    alloc.free_seq(0)
    tier.swap_out("img0", table, tier.fresh_blocks(table), vals, alloc)
    assert sorted(tier.device_holds()) == sorted(table)
    used0 = tier.used_slots
    alloc.free_seq(1)
    fresh = tier.fresh_blocks(table)
    assert fresh == [], "already-resident blocks must not re-swap"
    tier.swap_out("img1", table, fresh, vals[:, :, :0], alloc)
    assert tier.used_slots == used0, "dedup: second image adds no slot"
    shared, slots = tier.split_resident("img1")
    assert shared == list(table) and slots == []
    tier.drop("img0", alloc)
    assert not tier.empty                          # img1 still pins slots
    tier.drop("img1", alloc)
    assert tier.empty and not tier.device_holds()
    assert len(alloc.free_blocks()) == alloc.num_blocks


# ---------------------------------------------------------------------------
# engine: forced suspension round trip
# ---------------------------------------------------------------------------

def test_forced_swap_roundtrip_resumes_bitexact():
    """Mid-generation suspension and auto-resume: the stream continues
    exactly where it stopped, with zero re-prefilled tokens, as on JAX."""
    n = 2
    runs = _pair(n, before=lambda eng, reqs: _suspend_first(eng, reqs),
                 **_kw(num_blocks=48, n=n))
    eng, _, reqs, stats = runs["torch"]
    assert stats["swap_outs"] == 1 and stats["swap_ins"] == 1
    assert stats["reprefilled_swapped_tokens"] == 0
    assert stats["served"] == n and not stats["shed"]
    ref = _reference_streams(n)
    for r in reqs:
        assert eng.generated[r.req_id] == ref[r.req_id]
    assert_parity(runs)


def test_swap_mid_speculation_resumes_bitexact():
    """§15 x §16: suspending a slot mid-speculation drops its draft KV
    (never swapped: it can be recomputed), and the resume re-prefills
    the DRAFT pool only: the target stream goes on with zero re-prefilled
    tokens and equals the spec-off reference, as JAX's does."""
    n = 2

    def suspend(eng, reqs):
        assert eng.join_many(copy.deepcopy(reqs)) == n
        eng.step_window()                          # mid-speculation state
        live = next(s for s, a in enumerate(eng.active) if a is not None)
        assert eng._swap_out(live)
        assert eng.num_suspended == 1
        # the suspended slot's draft band is released at suspension
        assert eng.allocator.tables.get(eng._draft_seq(live), []) == []
        return []

    runs = _pair(n, before=suspend, **_kw(num_blocks=48, n=n,
                                          spec_decode=True, draft_k=4))
    for name in SPEC_COUNTERS:
        assert getattr(runs["torch"][0], name) == \
            getattr(runs["jax"][0], name), name
    assert_parity(runs)
    eng, _, reqs, stats = runs["torch"]
    assert stats["swap_outs"] == 1 and stats["swap_ins"] == 1
    assert stats["reprefilled_swapped_tokens"] == 0, \
        "the TARGET stream must never re-prefill across a suspension"
    assert stats["draft_reprefill_tokens"] > 0, \
        "resume must rebuild the draft KV from the verified stream"
    # a spec window emits up to draft_k+1 tokens, so the short request
    # can finish inside the manual step_window: count streams
    assert len(eng.generated) == n and not stats["shed"]
    ref = _reference_streams(n)
    for r in reqs:
        assert eng.generated[r.req_id] == ref[r.req_id]


def test_swap_out_refuses_when_tier_full():
    eng, _ = make_engine("torch", **_kw(num_blocks=48, n=2, swap_blocks=1))
    assert eng.join_many(_reqs("torch", 2)) == 2
    eng.step_window()
    assert not eng._swap_out(0), \
        "a 1-slot tier cannot hold a multi-block image"
    assert eng.num_suspended == 0 and eng.active[0] is not None
    drive_paged(eng, [])
    eng.assert_drained()


# ---------------------------------------------------------------------------
# scripted storm: pressure suspends instead of destroying
# ---------------------------------------------------------------------------

_STORM = [dict(window=2, kind="pool_shrink", blocks=12),
          dict(window=9, kind="pool_restore")]
_STORM_RUNS = {}


def _storm_runs():
    """The pool-shrink storm through both engines, run once a module."""
    if not _STORM_RUNS:
        _STORM_RUNS.update(_pair(8, _STORM, **_kw(num_blocks=24, n=4)))
        assert_parity(_STORM_RUNS)
    return _STORM_RUNS


def test_pool_shrink_storm_swaps_and_survives():
    """A mid-serve pool shrink under under-prediction forces live
    suspensions; after the restore every request finishes bit for bit
    with ZERO re-prefilled swapped tokens, and both tiers drain (as on
    JAX)."""
    eng, _, _, stats = _storm_runs()["torch"]
    assert stats["swap_outs"] > 0 and stats["swap_ins"] > 0
    assert stats["reprefilled_swapped_tokens"] == 0
    assert stats["served"] + len(stats["shed"]) == 8
    assert not stats["unserved"]
    ref = _reference_streams(8)
    for rid, toks in eng.generated.items():
        assert toks == ref[rid], f"survivor {rid} diverged from reference"
    eng.assert_drained()


def test_swap_victims_preferred_over_destruction():
    """With a working tier the storm destroys nothing: every preemption
    is a suspension."""
    _, _, _, stats = _storm_runs()["torch"]
    assert stats["swap_outs"] > 0
    assert stats["evictions"] == 0


# ---------------------------------------------------------------------------
# typed shed, swap_stall, host_pressure
# ---------------------------------------------------------------------------

def test_suspended_deadline_sheds_swapped_timeout():
    """A suspended image whose deadline lapses while resume is stalled
    sheds as ``swapped_timeout``, counted as a deadline miss; the tier
    drains (as on JAX)."""
    plan = [dict(window=1, kind="swap_stall", ticks=100),
            dict(window=3, kind="stall", ticks=50)]
    runs = _pair(2, plan, before=lambda eng, reqs: _suspend_first(eng, reqs),
                 **_kw(num_blocks=48, n=2, default_ttl=8))
    eng, inj, _, stats = runs["torch"]
    assert inj.swap_stalls > 0
    assert ShedReason.SWAPPED_TIMEOUT.value in {s.reason
                                                for s in stats["shed"]}
    assert eng.deadline_misses > 0
    assert eng.num_suspended == 0 and eng.swap.empty
    assert_parity(runs)


def test_swap_stall_defers_resume_then_recovers():
    n = 2
    runs = _pair(n, [dict(window=0, kind="swap_stall", ticks=3)],
                 before=lambda eng, reqs: _suspend_first(eng, reqs),
                 **_kw(num_blocks=48, n=n))
    eng, inj, reqs, stats = runs["torch"]
    assert inj.swap_stalls == 3, "each refused attempt burns one tick"
    assert stats["served"] == n and stats["swap_ins"] == 1
    ref = _reference_streams(n)
    for r in reqs:
        assert eng.generated[r.req_id] == ref[r.req_id]
    assert_parity(runs)


def test_host_pressure_shrinks_and_restores_tier():
    runs = _pair(4, [dict(window=1, kind="host_pressure", blocks=60),
                     dict(window=6, kind="host_pressure", blocks=0)],
                 **_kw(num_blocks=48, n=4))
    eng, inj, _, stats = runs["torch"]
    assert inj.host_pressure_events == 2
    assert eng.swap.capacity == 64, "restore must lift the squeeze"
    assert stats["served"] == 4
    assert_parity(runs)


def test_squeezed_tier_cannot_hold_new_images():
    tier = HostSwapTier(64, (2, 1, 2, 2, 1), torch.float32)
    tier.shrink(63)
    assert not tier.can_hold(2)
    tier.restore()
    assert tier.can_hold(2)


# ---------------------------------------------------------------------------
# sanitizer: cross-tier residency
# ---------------------------------------------------------------------------

def test_write_into_swap_held_block_raises():
    s = ShadowAllocator()
    s.on_allocate(0, [3])
    s.on_retain([3], SWAP_HOLDER)
    with pytest.raises(SwappedBlockError):
        s.check_write(0, [3])
    with pytest.raises(SharedWriteError):   # a SharedWriteError too
        s.check_write(0, [3])
    s.on_release([3], SWAP_HOLDER)
    s.check_write(0, [3])                   # hold gone: write is fine


def test_shadow_tracks_image_residency():
    s = ShadowAllocator()
    s.on_swap_out(42)
    assert 42 in s.swapped
    s.on_swap_in(42)
    assert not s.swapped


# ---------------------------------------------------------------------------
# property: random interleavings never corrupt KV
# ---------------------------------------------------------------------------

_PROP_BASE = {}


def _prop_reqs(side):
    """Shared-prefix workload (radix chains + COW tails), canonical per
    side."""
    if side not in _PROP_BASE:
        rs = SIDES[side][3].make_shared_prefix_dataset(
            6, n_apps=2, instr_words=10, input_words=4, gen_length=6,
            seed=3)
        for i, r in enumerate(rs):
            r.gen_length = 2 + (i * 3) % 6
            r.predicted_gen_length = r.gen_length
        _PROP_BASE[side] = rs
    return copy.deepcopy(_PROP_BASE[side])


_PROP_KW = dict(max_concurrency=4, num_blocks=96, block_tokens=BT,
                max_len=64, max_gen=8, prefix_cache=True)


def _interleave(side, ops):
    """Apply ``ops`` to ``side``'s engine, then drain; returns (engine,
    requests)."""
    reqs = _prop_reqs(side)
    pending = list(reqs)
    eng, _ = make_engine(side, swap_blocks=64, **_PROP_KW)

    def admit():
        while pending:
            if eng.join_many([pending[0]]) != 1:
                break
            pending.pop(0)

    admit()
    for arg, op in ops:
        live = [i for i, a in enumerate(eng.active) if a is not None]
        if op == "swap" and live:
            eng._swap_out(live[arg % len(live)])
        elif op == "evict" and live:
            pending.append(eng._evict(live[arg % len(live)]))
        elif op == "resume":
            eng._resume_swapped()
        elif op == "step":
            eng.step_window()
        admit()
    for _ in range(400):
        if not pending and not eng.num_active and not eng.num_suspended:
            break
        admit()
        eng.step_window()
    else:
        raise AssertionError("interleaving wedged the engine")
    return eng, reqs


@settings(max_examples=5, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3),
                          st.sampled_from(["swap", "evict", "resume",
                                           "step"])),
                min_size=3, max_size=12))
def test_random_interleavings_keep_streams_bitexact(ops):
    """Arbitrary interleavings of swap-out / swap-in / evict / COW /
    finish: nothing re-prefills after a suspension, every stream equals
    the fault-free run, both tiers and the shadow's residency registry
    drain, and JAX under the same interleaving agrees (the reference's
    property test, with no deadline)."""
    runs = {side: _interleave(side, ops) for side in SIDES}
    eng, reqs = runs["torch"]
    assert eng.reprefilled_swapped_tokens == 0
    ref_eng, _ = make_engine("torch", swap_blocks=0, **_PROP_KW)
    ref_reqs = _prop_reqs("torch")
    assert drive_paged(ref_eng, ref_reqs)["served"] == 6
    for r, q in zip(reqs, ref_reqs):
        assert eng.generated[r.req_id] == ref_eng.generated[q.req_id]
    assert eng.swap.empty and not eng.swap.device_holds()
    shadow = eng.allocator._shadow
    assert shadow is not None and not shadow.swapped
    assert_parity({side: (e, None, r, None) for side, (e, r)
                   in runs.items()})


# ---------------------------------------------------------------------------
# the tensors a captured decode graph reads keep their addresses
# ---------------------------------------------------------------------------

def _addresses(eng):
    return {"logits": eng.logits.data_ptr(),
            "positions": eng.positions.data_ptr(),
            "tables": eng.tables.data_ptr(),
            "active": eng.active_mask.data_ptr(),
            **{f"pages.{key}": v.data_ptr() for key, v in eng.pages.items()}}


def _write_everything(eng, reqs, inj):
    """Drive ``eng`` through every in-place write of the lifecycle and
    the swap tier, holding the addresses after each: the poison (window
    1's prologue), the quarantine (the same window's guard), a swap-out
    (``_release``), a resume (``scatter_pages`` and ``_restore_slot``),
    then a drain that requeues the quarantined request.  Returns the
    drive's stats."""
    want = _addresses(eng)
    assert eng.join_many(copy.deepcopy(reqs)) == len(reqs)
    poison = inj._poison

    def poisoned(engine, slot):
        poison(engine, slot)
        assert _addresses(engine) == want, "the poison rebound a tensor"
        assert not torch.isfinite(engine.logits[slot or 0]).all()

    inj._poison = poisoned
    _, evicted, _ = eng.step_window()
    assert eng.quarantined == 1 and len(evicted) == 1
    assert _addresses(eng) == want, "the quarantine rebound a tensor"
    live = next(s for s, a in enumerate(eng.active) if a is not None)
    assert eng._swap_out(live)
    assert _addresses(eng) == want, "the swap-out rebound a tensor"
    assert eng._resume_swapped() == 1
    assert eng.swap_ins == 1 and eng.num_suspended == 0
    assert _addresses(eng) == want, "the resume rebound a tensor"
    stats = drive_paged(eng, evicted)
    assert _addresses(eng) == want
    return stats


def _spec_addresses(eng):
    return {**_addresses(eng),
            "draft_logits": eng.draft_logits.data_ptr(),
            "draft_tables": eng.draft_tables.data_ptr(),
            **{f"draft_pages.{key}": v.data_ptr()
               for key, v in eng.draft_pages.items()}}


def test_spec_inplace_writes_keep_addresses():
    """A speculative engine: the draft poison (window 1's prologue), the
    draft guard's quarantine, a swap-out (the draft pool dropped) and a
    resume (the draft pool rebuilt by a draft wave) write the engine's
    tensors and both pools in place; the streams equal a spec-off
    engine's."""
    inj = FaultInjector([FaultEvent(window=1, kind="poison_draft_logits",
                                    slot=0)])
    kw = _kw(num_blocks=48, n=3)
    eng = PagedContinuousEngine(CFG, seed=0, device="cpu", faults=inj,
                                spec_decode=True, draft_k=2, **kw)
    want = _spec_addresses(eng)
    reqs = _reqs("torch", 3)
    for r in reqs:
        r.gen_length = MAX_GEN
    assert eng.join_many(copy.deepcopy(reqs)) == 3
    eng.step_window()
    assert inj.draft_poisoned == 1 and eng.draft_quarantined == 1
    assert eng.quarantined == 0
    assert _spec_addresses(eng) == want, "the draft quarantine rebound"
    live = next(s for s, a in enumerate(eng.active)
                if a is not None and not a.get("draft_cold"))
    assert eng._swap_out(live)
    assert _spec_addresses(eng) == want, "the swap-out rebound a tensor"
    assert eng._resume_swapped() == 1 and eng.draft_reprefill_tokens > 0
    assert _spec_addresses(eng) == want, "the resume rebound a tensor"
    stats = drive_paged(eng, [])
    assert _spec_addresses(eng) == want
    assert stats["unserved"] == [] and not stats["shed"]
    ref = PagedContinuousEngine(CFG, seed=0, device="cpu", **kw)
    drive_paged(ref, copy.deepcopy(reqs))
    assert [eng.generated[r.req_id] for r in reqs] == \
        [ref.generated[r.req_id] for r in reqs]
    eng.assert_drained()


def test_inplace_writes_keep_addresses():
    """The poison, the quarantine, a swap-out and a resume write the
    engine's tensors in place (the CPU half of the graph test below)."""
    inj = FaultInjector([FaultEvent(window=1, kind="poison_logits",
                                    slot=0)])
    eng = PagedContinuousEngine(CFG, seed=0, device="cpu", faults=inj,
                                **_kw(num_blocks=48, n=3))
    stats = _write_everything(eng, _reqs("torch", 3), inj)
    assert stats["unserved"] == [] and not stats["shed"]
    assert len(eng.generated) == 3
    eng.assert_drained()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and pinned memory")
    torch.backends.cuda.matmul.allow_tf32 = False


def _cuda_params():
    p = M.init_params(CFG, seed=0, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    return p, to(p, "cuda")


@pytest.mark.cuda
def test_cuda_writes_keep_the_graphs_addresses(card):
    """On the card the decode step is captured at the first window; the
    poison, the quarantine, a swap-out and a resume leave every tensor
    the graph bound at the address it captured, the graph is never
    captured again, and the tier's store is page-locked."""
    inj = FaultInjector([FaultEvent(window=2, kind="poison_logits",
                                    slot=0)])
    _, params = _cuda_params()
    eng = PagedContinuousEngine(CFG, params, device="cuda", faults=inj,
                                **_kw(num_blocks=48, n=3))
    reqs = _reqs("torch", 3)
    for r in reqs:
        r.gen_length = MAX_GEN
    assert eng.join_many(copy.deepcopy(reqs)) == 3
    eng.step_window(max_steps=1)               # window 1: the capture
    assert eng.graph_captures == 1
    g = eng._decode_graph.state
    bound = {"logits": g["logits"].data_ptr(),
             "positions": g["positions"].data_ptr(),
             "tables": g["tables"].data_ptr(),
             "active": g["active"].data_ptr(),
             **{f"pages.{key}": v.data_ptr() for key, v in eng.pages.items()}}
    assert _addresses(eng) == bound
    _, evicted, _ = eng.step_window()          # window 2: poison, guard
    assert inj.poisoned == 1 and eng.quarantined == 1
    assert _addresses(eng) == bound
    live = next(s for s, a in enumerate(eng.active) if a is not None)
    assert eng._swap_out(live)
    assert eng.swap._store.is_pinned()
    assert eng._resume_swapped() == 1
    assert _addresses(eng) == bound
    stats = drive_paged(eng, evicted)
    assert not stats["unserved"] and not stats["shed"]
    assert len(eng.generated) == 3
    assert _addresses(eng) == bound and eng.graph_captures == 1
    eng.assert_drained()


@pytest.mark.cuda
def test_cuda_graphed_engine_matches_cpu_under_faults(card):
    """A poison, a pool shrink and its restore, and a forced swap round
    trip: the graphed CUDA engine's streams, counters and sheds equal
    the CPU engine's on the same weights (f32, TF32 off)."""
    cpu_params, cuda_params = _cuda_params()
    plan = [FaultEvent(window=2, kind="poison_logits", slot=1),
            FaultEvent(window=3, kind="pool_shrink", blocks=12),
            FaultEvent(window=9, kind="pool_restore")]
    out = {}
    for dev, params in (("cpu", cpu_params), ("cuda", cuda_params)):
        inj = FaultInjector(list(plan))
        eng = PagedContinuousEngine(CFG, params, device=dev, faults=inj,
                                    **_kw(num_blocks=24, n=4))
        reqs = _reqs("torch", 6)
        assert eng.join_many(copy.deepcopy(reqs[:4])) == 4
        eng.step_window()
        assert eng._swap_out(0)
        stats = drive_paged(eng, copy.deepcopy(reqs[4:]))
        inj.release(eng.allocator)
        eng.assert_drained()
        out[dev] = ([eng.generated.get(r.req_id) for r in reqs],
                    {name: getattr(eng, name) for name in (
                        "host_syncs", "evictions", "swap_outs", "swap_ins",
                        "quarantined", "decode_steps", "prefill_tokens")},
                    [(s.req.req_id, s.reason) for s in stats["shed"]],
                    inj.counters())
    assert out["cuda"][1]["quarantined"] == 1
    assert out["cuda"][1]["swap_ins"] >= 1
    assert out["cuda"] == out["cpu"]
