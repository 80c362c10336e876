"""Speculative decoding on the port's paged engine (DESIGN.md §16), the
port of the reference's conformance suite (``tests/test_spec_decode.py``)
under ``REPRO_SANITIZE=1`` for the whole module (the shadow allocator
audits every draft-pool write too), with each engine run beside the JAX
reference's on the same weights (carried by ``params_from_numpy``; the
non-trivial draft's from the reference's ``draft_seed``) and the same
requests:

- speculation never changes greedy output: a spec-on engine's streams
  equal the port's spec-off engines' (per-token and fused) and JAX's
  spec engine's, for a self-draft (every proposal accepted) and for a
  smaller draft model (proposals rejected), for every ``draft_k`` in
  {1, 2, 4, 8}, across radix hit/miss mixes with mid-block
  copy-on-write tails;
- one packed readback a window: host syncs and every §16 counter equal
  JAX's;
- rollback is table truncation, which never frees or mutates a block
  another holder keeps (the hypothesis property, on both packages'
  allocators);
- the draft pool rides the engine's admission, grow and evict valves,
  and drains with the target pool (``assert_drained``).

``test_sim_spec_dispatch_pricing`` is not ported: it tests the ``sim``
backend, which the port does not have yet.  (A CPU engine runs the
speculative window eagerly; the captured window is tested on the card,
in ``test_torch_graphs.py``.)"""
import copy
import dataclasses
import functools
import os

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
from repro.core import types as jax_types
from repro.models import model as JM
from repro.serving import engine as jax_engine
from repro.serving import paged_cache as jax_cache
from repro.workload import apps as jax_apps
from repro_torch.configs import get_config
from repro_torch.core import types as torch_types
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy
from repro_torch.serving import engine as torch_engine
from repro_torch.serving import paged_cache as torch_cache
from repro_torch.workload import apps

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

JCFG = jax_config("smollm-135m").reduced(num_layers=2, d_model=64)
CFG = get_config("smollm-135m").reduced(num_layers=2, d_model=64)
JDRAFT = JCFG.reduced(num_layers=1, d_model=32)
DRAFT = CFG.reduced(num_layers=1, d_model=32)
MAX_GEN = 10
BT = 4

#: per side: engine module, paged-cache module, types module, apps module
SIDES = {"jax": (jax_engine, jax_cache, jax_types, jax_apps),
         "torch": (torch_engine, torch_cache, torch_types, apps)}
#: engine counters the two packages must agree on after every run
COUNTERS = ("host_syncs", "decode_steps", "prefill_dispatches",
            "prefill_tokens", "cow_copies", "evictions", "spec_windows",
            "spec_slot_windows", "spec_emitted", "spec_accepted",
            "spec_drafted", "draft_quarantined", "draft_prefill_tokens",
            "draft_reprefill_tokens", "quarantined")


@pytest.fixture(autouse=True, scope="module")
def _sanitize():
    old = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    yield
    if old is None:
        os.environ.pop("REPRO_SANITIZE", None)
    else:
        os.environ["REPRO_SANITIZE"] = old


@functools.lru_cache(maxsize=None)
def _params():
    """The target's weights and the draft's (the reference draws a
    draft config's weights from ``PRNGKey(draft_seed)``, 1 by default),
    JAX's and the port's copies."""
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0))
    jd = JM.init_params(JDRAFT, jax.random.PRNGKey(1))
    to = lambda tree: params_from_numpy(jax.tree.map(np.asarray, tree),
                                        device="cpu")
    return jp, to(jp), to(jd)


def _engine(side="torch", num_blocks=96, *, n=4, draft=False, **kw):
    """``side``'s paged engine at the tiny config; ``draft=True`` gives
    it the tiny draft model (its weights as the reference draws them)."""
    jp, tp, tdp = _params()
    kw = dict(max_concurrency=n, num_blocks=num_blocks, block_tokens=BT,
              max_len=64, max_gen=MAX_GEN, **kw)
    if side == "jax":
        return jax_engine.PagedContinuousEngine(
            JCFG, params=jp, **({"draft_cfg": JDRAFT} if draft else {}),
            **kw)
    return torch_engine.PagedContinuousEngine(
        CFG, params=tp, device="cpu",
        **({"draft_cfg": DRAFT, "draft_params": tdp} if draft else {}), **kw)


_REQ_CACHE = {}


def _reqs(n, seed=0, side="torch"):
    key = (n, seed, side)
    if key not in _REQ_CACHE:
        _REQ_CACHE[key] = [
            SIDES[side][2].Request(
                app=f"a{i % 3}", task="t",
                instruction=f"spec instruction {seed} {i} words",
                user_input=f"user input number {i} more text",
                length=14, gen_length=3 + (i * 3) % MAX_GEN,
                predicted_gen_length=1)
            for i in range(n)]
    return copy.deepcopy(_REQ_CACHE[key])


_REF_CACHE = {}


def _reference_streams(n, seed=0):
    """The per-token oracle: the port's engine with fuse=False, spec off,
    a roomy pool."""
    key = (n, seed)
    if key not in _REF_CACHE:
        eng = _engine(n=n, fuse=False)
        stats = torch_engine.drive_paged(eng, _reqs(n, seed=seed))
        assert stats["served"] == n
        eng.assert_drained()
        _REF_CACHE[key] = dict(eng.generated)
    return _REF_CACHE[key]


def _spec_pair(reqs, **kw):
    """The same requests (``reqs(side)``) through both packages' engines
    built with ``kw``: streams, counters and the drive's §16 keys equal,
    both engines drained.  Returns the port's (engine, requests,
    stats)."""
    out = {}
    for side in SIDES:
        eng = _engine(side, **kw)
        rs = reqs(side)
        stats = SIDES[side][0].drive_paged(eng, rs)
        eng.assert_drained()
        out[side] = (eng, rs, stats)
    (je, jr, js), (te, tr, ts) = out["jax"], out["torch"]
    assert [te.generated.get(r.req_id) for r in tr] == \
        [je.generated.get(r.req_id) for r in jr]
    for name in COUNTERS:
        assert getattr(te, name) == getattr(je, name), name
    for key in ("served", "steps", "host_syncs", "spec_windows",
                "spec_emitted", "spec_accepted", "spec_drafted",
                "draft_quarantined", "draft_prefill_tokens",
                "draft_reprefill_tokens", "accepted_per_dispatch",
                "acceptance_rate"):
        assert ts[key] == js[key], key
    return te, tr, ts


# ---------------------------------------------------------------------------
# the §16 invariant: speculation never changes greedy output
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_selfdraft_bitexact_across_draft_k(k):
    """A self-draft at every tested window matches the per-token loop,
    the spec-off fused window and JAX's spec engine, and the host syncs
    are one a window."""
    ref = _reference_streams(4)
    fused = _engine()
    torch_engine.drive_paged(fused, _reqs(4))
    fused.assert_drained()
    assert dict(fused.generated) == ref
    eng, _, stats = _spec_pair(lambda side: _reqs(4, side=side),
                               spec_decode=True, draft_k=k)
    assert stats["served"] == 4
    for rid, toks in ref.items():
        assert eng.generated[rid] == toks, f"req {rid} diverged at k={k}"
    assert stats["acceptance_rate"] == 1.0
    assert stats["accepted_per_dispatch"] > 1.0
    assert stats["host_syncs"] == eng.spec_windows
    assert eng.draft_params is eng.params      # a self-draft shares them


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_real_draft_model_bitexact_under_rejection(k):
    """A smaller draft with other weights mispredicts (acceptance < 1);
    verification still reproduces the target stream exactly, as JAX's
    engine does."""
    ref = _reference_streams(4, seed=3)
    eng, _, stats = _spec_pair(lambda side: _reqs(4, seed=3, side=side),
                               spec_decode=True, draft_k=k, draft=True)
    assert stats["served"] == 4
    for rid, toks in ref.items():
        assert eng.generated[rid] == toks
    assert stats["acceptance_rate"] < 1.0
    # even with every proposal rejected the window emits >= 1 token
    assert stats["accepted_per_dispatch"] >= 1.0


def test_radix_mixes_and_cow_tails_bitexact():
    """Radix hit/miss mixes with mid-block shared tails: the spec
    engine's verify crosses prefill-seeded carries, copy-on-write clones
    and published prefixes, and still matches the spec-off radix engine
    and JAX's spec engine."""
    def reqs(side):
        out = SIDES[side][3].make_shared_prefix_dataset(12, seed=5)
        for r in out:
            r.gen_length = min(r.gen_length, MAX_GEN)
        return out

    ref, rreqs = _engine(n=4, prefix_cache=True), reqs("torch")
    torch_engine.drive_paged(ref, rreqs)
    ref.assert_drained()
    eng, sreqs, stats = _spec_pair(reqs, n=4, prefix_cache=True,
                                   spec_decode=True, draft_k=4)
    assert stats["served"] == 12
    assert [eng.generated[r.req_id] for r in sreqs] == \
        [ref.generated[r.req_id] for r in rreqs]
    assert eng.prefix_cache.hits > 0


@pytest.mark.parametrize("k", [1, 4])
def test_batch_invariant_spec_serve_equals_spec_off(k):
    """Inside ``batch_invariant()`` (the arithmetic in which a card's f32
    spec serve equals its spec-off serve bit for bit), the radix mix with
    a self-draft still matches the spec-off radix engine of the same
    arithmetic and JAX's spec engine, stream for stream and counter for
    counter, with every proposal accepted."""
    def reqs(side):
        out = SIDES[side][3].make_shared_prefix_dataset(12, seed=5)
        for r in out:
            r.gen_length = min(r.gen_length, MAX_GEN)
        return out

    with M.batch_invariant():
        off, oreqs = _engine(n=4, prefix_cache=True), reqs("torch")
        torch_engine.drive_paged(off, oreqs)
        off.assert_drained()
        eng, sreqs, stats = _spec_pair(reqs, n=4, prefix_cache=True,
                                       spec_decode=True, draft_k=k)
    assert stats["served"] == 12
    assert [eng.generated[r.req_id] for r in sreqs] == \
        [off.generated[r.req_id] for r in oreqs]
    assert stats["acceptance_rate"] == 1.0
    assert eng.prefix_cache.hits > 0


def test_step_interleaving_matches_window():
    """step() (a max_steps=1 window) under speculation clamps emission to
    one token and still reproduces the reference streams; JAX's engine
    takes the same steps."""
    ref = _reference_streams(3, seed=7)
    out = {}
    for side in SIDES:
        eng = _engine(side, n=3, spec_decode=True, draft_k=4)
        eng.join_many(_reqs(3, seed=7, side=side))
        for _ in range(200):
            eng.step()
            if eng.num_active == 0:
                break
        eng.assert_drained()
        out[side] = eng
    assert dict(out["torch"].generated) == ref
    for name in COUNTERS:
        assert getattr(out["torch"], name) == getattr(out["jax"], name), name


# ---------------------------------------------------------------------------
# window accounting: one sync per window, counters add up
# ---------------------------------------------------------------------------

def test_one_sync_per_spec_window():
    eng = _engine(spec_decode=True, draft_k=4, warmup=False)
    eng.join_many(_reqs(4))
    syncs0 = eng.host_syncs
    finished, evicted, k = eng.step_window()
    assert eng.host_syncs - syncs0 == 1     # ONE packed readback
    assert evicted == [] and k >= 1
    assert eng.spec_windows == 1
    assert eng.spec_slot_windows == 4
    torch_engine.drive_paged(eng, [])
    eng.assert_drained()


def test_spec_counters_and_prefill_split():
    """Draft admission prefills are counted apart: the target wave
    discipline (one prefill dispatch a wave) is untouched; the counters
    equal JAX's."""
    eng, _, stats = _spec_pair(lambda side: _reqs(4, side=side),
                               spec_decode=True, draft_k=4)
    assert eng.prefill_dispatches == 1          # one admission wave
    assert eng.draft_prefill_tokens == eng.prefill_tokens
    assert stats["spec_emitted"] == sum(
        len(t) for t in eng.generated.values())
    assert stats["spec_accepted"] == (stats["spec_emitted"]
                                      - eng.spec_slot_windows)


# ---------------------------------------------------------------------------
# rollback = truncation: unit + property (never frees/mutates shared)
# ---------------------------------------------------------------------------

def test_truncate_unit():
    alloc = torch_cache.BlockAllocator(num_blocks=8, block_tokens=2)
    table = list(alloc.allocate(0, 8))             # 4 blocks
    released = alloc.truncate(0, 2)
    assert released == table[2:]
    assert list(alloc.tables[0]) == table[:2]
    assert set(released) <= set(alloc.free)
    assert alloc.truncate(0, 2) == []              # idempotent
    assert alloc.truncate(99, 0) == []             # missing seq: no-op
    with pytest.raises(ValueError):
        alloc.truncate(0, -1)
    alloc.free_seq(0)
    assert alloc.used_blocks == 0


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=4, max_value=12),
       st.integers(min_value=0, max_value=12),
       st.lists(st.integers(min_value=0, max_value=12),
                min_size=1, max_size=6))
def test_truncate_never_frees_or_mutates_shared(n_blocks, shared_n, keeps):
    """Random accept/reject rollback patterns: truncating a seq whose
    tail a radix-like sharer still holds releases only THIS seq's
    references, the shared blocks stay allocated for the other holder,
    refcounts are conserved, and JAX's allocator makes the same moves."""
    shared_n = min(shared_n, n_blocks)
    allocs = [m.BlockAllocator(num_blocks=16, block_tokens=2)
              for m in (torch_cache, jax_cache)]
    tables = [list(a.allocate(0, n_blocks * 2)) for a in allocs]
    for a, table in zip(allocs, tables):
        if shared_n:
            a.share(1, table[:shared_n])           # the "radix holder"
    for keep in keeps:
        # the engine floors rollback at the accepted stream, which always
        # covers the published/shared span: mirror that contract here
        keep = min(max(keep, shared_n), n_blocks)
        released = [a.truncate(0, keep) for a in allocs]
        assert released[0] == released[1] == tables[0][keep:]
        kept = tables[0][:keep]
        for b in tables[0][:shared_n]:
            # the sharer's blocks are never freed out from under it
            assert allocs[0].refcount.get(b, 0) >= 1
        assert allocs[0].refcount == allocs[1].refcount
        assert allocs[0].free == allocs[1].free
        # regrow to the full size: fresh blocks append, the kept prefix
        # is untouched (same physical ids, so nothing mutated)
        tables = [list(a.allocate(0, n_blocks * 2)) for a in allocs]
        assert tables[0] == tables[1]
        assert tables[0][:keep] == kept and len(tables[0]) == n_blocks
    alloc, table = allocs[0], tables[0]
    alloc.free_seq(0)
    if shared_n:
        for b in table[:shared_n]:
            assert alloc.refcount.get(b, 0) == 1   # the holder survives
        alloc.free_seq(1)
    assert alloc.used_blocks == 0


# ---------------------------------------------------------------------------
# draft guard + draft pool lifecycle
# ---------------------------------------------------------------------------

def test_poisoned_draft_quarantines_not_the_request():
    """NaN draft logits ice the slot's DRAFT for good; the request keeps
    serving one verified token a window, exactly (the port writes the
    poison in place, as the injector does; JAX rebinds the row)."""
    ref = _reference_streams(2, seed=9)
    out = {}
    for side in SIDES:
        eng = _engine(side, n=2, spec_decode=True, draft_k=4, nan_guard=True)
        eng.join_many(_reqs(2, seed=9, side=side))
        eng.step_window()
        live = next(s for s, a in enumerate(eng.active) if a is not None)
        if side == "jax":
            eng.draft_logits = eng.draft_logits.at[live].set(float("nan"))
        else:
            eng.draft_logits[live] = float("nan")
        SIDES[side][0].drive_paged(eng, [])
        eng.assert_drained()
        out[side] = eng
    eng = out["torch"]
    assert eng.draft_quarantined == 1
    assert eng.quarantined == 0                    # the request survived
    assert dict(eng.generated) == ref
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(out["jax"], name), name


def test_draft_pool_drains_with_target_pool():
    """assert_drained covers the draft band: a leaked draft seq (or a
    draft block surviving finish) fails the drain check."""
    eng = _engine(spec_decode=True, draft_k=2)
    torch_engine.drive_paged(eng, _reqs(4))
    eng.assert_drained()
    stray = [s for s in eng.allocator.tables
             if s <= eng._DRAFT_SEQ_BASE and eng.allocator.tables[s]]
    assert stray == []
    # and the check bites: a planted draft-band seq trips it
    eng.allocator.allocate(eng._draft_seq(0), 1)
    with pytest.raises(Exception):
        eng.assert_drained()
    eng.allocator.free_seq(eng._draft_seq(0))


def test_spec_rejects_unfused_and_mismatched_vocab():
    with pytest.raises(ValueError):
        _engine(spec_decode=True, fuse=False)
    with pytest.raises(ValueError):
        _engine(spec_decode=True, draft_k=0)
    with pytest.raises(ValueError):
        _engine(spec_decode=True, draft_cfg=dataclasses.replace(
            DRAFT, vocab_size=CFG.vocab_size // 2))


# ---------------------------------------------------------------------------
# the port's own: warmup and the window's inputs
# ---------------------------------------------------------------------------

def _state(eng):
    """Everything a request can read, on both pools: the pools outside
    the null block, both table sets, positions, the active mask and both
    carried logits."""
    keep = torch.ones(eng.allocator.num_blocks, dtype=torch.bool)
    keep[eng.null_block] = False
    return ([p[:, keep].clone() for pages in (eng.pages, eng.draft_pages)
             for p in pages.values()]
            + [t.clone() for t in (eng.tables, eng.positions,
                                   eng.active_mask, eng.logits,
                                   eng.draft_tables, eng.draft_logits)])


def test_spec_warmup_writes_nothing_and_serves_like_jax():
    """``warmup()`` on a spec engine mid-serve (the draft waves at every
    shape, then the speculative window on an idle state) leaves every
    tensor a request can read bit-equal, twice; a CPU engine captures
    nothing, and the serve goes on as JAX's engine's does."""
    out = {}
    for side in SIDES:
        eng = _engine(side, n=4, prefix_cache=True, spec_decode=True,
                      draft_k=2)
        reqs = _reqs(6, seed=4, side=side)
        assert eng.join_many(reqs[:3]) == 3
        eng.step_window(max_steps=2)
        if side == "torch":
            before = _state(eng)
            eng.warmup()
            once = _state(eng)
            eng.warmup()
            for a, b, c in zip(before, once, _state(eng)):
                assert torch.equal(a, b) and torch.equal(b, c)
            assert eng.graph_captures == 0
        SIDES[side][0].drive_paged(eng, reqs[3:])
        eng.assert_drained()
        out[side] = [eng.generated[r.req_id] for r in reqs]
    assert out["torch"] == out["jax"]


def test_max_emit_clamps_the_window_at_a_finish():
    """A slot one token from its target emits exactly one token however
    many its self-draft proposes (the host's budget, ``max_emit``), and
    its proposals past the budget are not counted as drafted."""
    eng = _engine(n=2, spec_decode=True, draft_k=4)
    reqs = _reqs(2)
    reqs[0].gen_length = 1
    reqs[1].gen_length = 9
    assert eng.join_many(reqs) == 2
    finished, _, k = eng.step_window()
    assert [r.req_id for r in finished] == [reqs[0].req_id]
    assert len(eng.generated[reqs[0].req_id]) == 1
    assert k == 5 and eng.spec_emitted == 6
    assert eng.spec_drafted == 4              # row 0's budget allowed none
    torch_engine.drive_paged(eng, [])
    eng.assert_drained()
