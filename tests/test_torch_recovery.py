"""The port's §17 crash-safe serving against the JAX reference on the
CPU: the reference's kill-and-recover harness (``tests/test_recovery.py``)
run on the port, and the two packages' snapshots and journals read by
each other.

A scripted ``crash`` fault hard-stops the port's engine at a seam
(mid-wave, mid-window, mid-swap, mid-publish); the checkpoint directory
(last snapshot + write-ahead journal tail) is all that survives.
Recovery must then finish every journaled request with streams equal to
both the port's and JAX's uncrashed runs (same weights, carried by
``params_from_numpy``, and the same requests), re-prefill zero tokens
for snapshot-covered requests, drain both tiers with the §13 shadow
rebuilt from the snapshot, and re-derive the streams the crashed run had
journaled as finished (``journal_mismatches == 0``).

Across packages: a snapshot written by either package (f32 and bf16,
with a radix tree and a suspended swap image) restores into the other's
engine, whose streams then finish as the writer's uncrashed run does; a
journal written by either is recovered by the other with the writer's
own report and streams; the launchers' restore-on-start gives the same
counts; bf16 arrays cross as bit patterns (``torch.bfloat16`` on the
port's side, no ``ml_dtypes``).  The restore writes the engine's tensors
and the tier's store in place (``test_restore_keeps_addresses``; the
captured graph's own addresses are held on the card in
``test_torch_graphs.py``).

Left out, waiting for later items: the reference's
``test_sim_recovery_time_pricing`` and the ``sim.events.Metrics`` lines
of ``test_downtime_expires_journaled_requests`` (the ``sim`` backend),
and all of ``test_checkpoint_restore_validates_template`` but its
flatten convention (training)."""
import copy
import json
import os
import pathlib
import shutil
import tempfile
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from repro.testing import given, settings
    from repro.testing import strategies as st

from repro.serving import engine as jax_engine
from repro.serving import faults as jax_faults
from repro.serving import snapshot as jax_snap
from repro.serving.paged_cache import HostSwapTier as JaxSwapTier
from repro.workload import apps as jax_apps
from repro_torch.core.types import SHED_REASONS
from repro_torch.serving import engine as torch_engine
from repro_torch.serving import faults as torch_faults
from repro_torch.serving import snapshot as snaplib
from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
from repro_torch.serving.faults import (EngineCrash, FaultEvent,
                                        FaultInjector, SEAMS)
from repro_torch.serving.paged_cache import (BlockAllocator, HostSwapTier,
                                             RadixPrefixCache)
from repro_torch.workload import apps

from test_torch_chaos import CFG, JCFG, params

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

MAX_GEN = 10
BT = 4
N = 6

#: per side: engine module, faults module, apps module, snapshot module
SIDES = {"jax": (jax_engine, jax_faults, jax_apps, jax_snap),
         "torch": (torch_engine, torch_faults, apps, snaplib)}
DTYPES = {"f32": {"jax": jnp.float32, "torch": torch.float32},
          "bf16": {"jax": jnp.bfloat16, "torch": torch.bfloat16}}


_REQ_CACHE = {}


def _reqs(side, n=N, seed=0, underpredict=False, shared=False):
    """One canonical request list per (side, n, seed, kind), deep-copied
    per run (the streams are compared in request order).  With
    ``underpredict`` every request predicts 1 token (pool pressure, so
    swap traffic); ``shared`` draws two apps' shared instructions (radix
    hits and a tree in every snapshot)."""
    key = (side, n, seed, underpredict, shared)
    if key not in _REQ_CACHE:
        mod = SIDES[side][2]
        reqs = (mod.make_shared_prefix_dataset(
                    n, n_apps=2, instr_words=14, input_words=5,
                    gen_length=MAX_GEN, seed=seed) if shared
                else mod.make_dataset(2, seed=seed)[:n])
        for i, r in enumerate(reqs):
            r.user_input = " ".join(r.user_input.split()[:6])
            r.gen_length = 3 + (i * 3) % MAX_GEN
            r.predicted_gen_length = 1 if underpredict else r.gen_length
        _REQ_CACHE[key] = reqs
    return copy.deepcopy(_REQ_CACHE[key])


def _engine(side, faults=None, num_blocks=48, n=4, dtype="f32", **kw):
    """``side``'s paged engine at the tiny config, on the shared weights."""
    jp, tp = params()
    kw = dict(max_concurrency=n, num_blocks=num_blocks, block_tokens=BT,
              max_len=64, max_gen=MAX_GEN, faults=faults,
              dtype=DTYPES[dtype][side], **kw)
    if side == "jax":
        return jax_engine.PagedContinuousEngine(JCFG, params=jp, **kw)
    return PagedContinuousEngine(CFG, params=tp, device="cpu", **kw)


def _injector(side, events):
    faults = SIDES[side][1]
    return faults.FaultInjector([faults.FaultEvent(**e) for e in events])


_REF_CACHE = {}


def _uncrashed(side, seed=0, underpredict=False, shared=False,
               **engine_kw):
    """``side``'s fault-free streams, in request order."""
    key = (side, seed, underpredict, shared,
           tuple(sorted(engine_kw.items())))
    if key not in _REF_CACHE:
        eng = _engine(side, **engine_kw)
        reqs = _reqs(side, seed=seed, underpredict=underpredict,
                     shared=shared)
        stats = SIDES[side][0].drive_paged(eng, reqs)
        assert stats["served"] == N, stats
        eng.assert_drained()
        _REF_CACHE[key] = [eng.generated[r.req_id] for r in reqs]
    return _REF_CACHE[key]


def _references(**kw):
    """The port's and JAX's uncrashed streams, which must agree."""
    ref = _uncrashed("torch", **kw)
    assert _uncrashed("jax", **kw) == ref
    return ref


def _crash(side, ckpt, seam, window, *, seed=0, underpredict=False,
           shared=False, snapshot_every=2, extra_events=(), **engine_kw):
    """Run ``side``'s engine into its scripted crash under a
    RecoveryManager.  Returns (crashed, stats, injector, engine)."""
    eng_mod, _, _, snap = SIDES[side]
    inj = _injector(side, [*extra_events, dict(window=window, kind="crash",
                                               seam=seam)])
    eng = _engine(side, faults=inj, **engine_kw)
    mgr = snap.RecoveryManager(str(ckpt), snapshot_every=snapshot_every)
    crashed, stats = False, None
    try:
        stats = eng_mod.drive_paged(
            eng, _reqs(side, seed=seed, underpredict=underpredict,
                       shared=shared), recovery=mgr)
    except SIDES[side][1].EngineCrash as e:
        crashed = True
        assert e.seam == seam
    mgr.close()
    return crashed, stats, inj, eng


def _crash_and_recover(tmp_path, seam, window, *, seed=0,
                       underpredict=False, snapshot_every=2,
                       extra_events=(), **engine_kw):
    """The port's crash at (``seam``, ``window``), recovered by the port,
    against both uncrashed runs: the reference's ``_crash_and_recover``.
    Returns (recovered_engine, report), or None if the seam was never
    crossed (then the run must have completed normally)."""
    ref = _references(seed=seed, underpredict=underpredict, **engine_kw)
    ckpt = tmp_path / f"ckpt-{seam}-{window}"
    crashed, stats, inj, eng = _crash(
        "torch", ckpt, seam, window, seed=seed, underpredict=underpredict,
        snapshot_every=snapshot_every, extra_events=extra_events,
        **engine_kw)
    reqs = _reqs("torch", seed=seed, underpredict=underpredict)
    if not crashed:
        inj.release(eng.allocator)
        assert stats["served"] == N
        assert [eng.generated[r.req_id] for r in reqs] == ref
        eng.assert_drained()
        return None
    eng2, report = snaplib.recover(
        lambda: _engine("torch", **engine_kw), str(ckpt),
        snapshot_every=snapshot_every)
    assert report["journaled"] == N
    assert report["recovered"] == N, report
    assert [eng2.generated.get(r.req_id) for r in reqs] == ref, \
        f"seam={seam} w={window}: a stream diverged after recovery"
    assert report["replayed_reprefill_tokens"] == 0, \
        "snapshot-covered request re-prefilled target tokens"
    assert report["journal_mismatches"] == 0
    eng2.assert_drained()
    return eng2, report


# ---------------------------------------------------------------------------
# the kill-and-recover acceptance seams
# ---------------------------------------------------------------------------

def test_crash_mid_wave(tmp_path):
    """Crash between reservation and prefill dispatch: the WAL already
    holds the admits, so recovery replays the whole wave."""
    assert _crash_and_recover(tmp_path, "wave", 0) is not None


def test_crash_mid_window_early_and_late(tmp_path):
    """Mid-window crashes before AND after the first snapshot landed:
    the early one recovers from journal-only replay, the late one from
    snapshot + journal tail with restored in-flight decode state."""
    assert _crash_and_recover(tmp_path, "window", 1) is not None
    out = _crash_and_recover(tmp_path, "window", 5)
    assert out is not None
    _, report = out
    assert report["snapshot_used"] is not None, \
        "window-5 crash with snapshot_every=2 must restore from a snapshot"
    assert report["journal_confirmed"] >= 1, \
        "some stream finished pre-crash and must re-derive identically"


def test_crash_mid_publish(tmp_path):
    """Crash inside the deferred radix publish flush: queued spans are
    an optimization, not durable state, so recovery (radix tree restored
    from the snapshot) still serves everything exactly."""
    assert _crash_and_recover(tmp_path, "publish", 1,
                              prefix_cache=True) is not None


def test_crash_mid_swap(tmp_path):
    """Crash after the tier committed to a suspension but before the
    image readback: nothing of the half-swap survives, and the restored
    swap tier's books round-trip (dedup slots included)."""
    out = _crash_and_recover(
        tmp_path, "swap", 2, seed=1, underpredict=True,
        num_blocks=24, swap_blocks=16,
        extra_events=(dict(window=2, kind="pool_shrink", blocks=12),))
    assert out is not None
    eng2, _ = out
    assert eng2.swap is not None and eng2.swap.empty


@given(seam=st.sampled_from(SEAMS), window=st.integers(0, 6))
@settings(max_examples=6, deadline=None)
def test_crash_random_seam_property(seam, window):
    """Any (seam, window) either never fires (the run completes
    normally, with the uncrashed streams) or recovers them with zero
    replayed re-prefill and both tiers drained."""
    with tempfile.TemporaryDirectory() as d:
        _crash_and_recover(pathlib.Path(d), seam, window, seed=1,
                           num_blocks=20, swap_blocks=16,
                           prefix_cache=True)


def test_recovery_under_sanitizer_rebuilds_shadow(tmp_path):
    """With REPRO_SANITIZE on for the factory engine, load_engine
    rebuilds the ShadowAllocator from the snapshot; check_allocator
    (always run) cross-checks it against the restored books."""
    old = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        out = _crash_and_recover(tmp_path, "window", 5, prefix_cache=True)
        assert out is not None
        eng2, _ = out
        assert eng2.allocator._shadow is not None, \
            "sanitizing restore must carry a rebuilt shadow"
    finally:
        if old is None:
            os.environ.pop("REPRO_SANITIZE", None)
        else:
            os.environ["REPRO_SANITIZE"] = old


# ---------------------------------------------------------------------------
# snapshot container round-trip units
# ---------------------------------------------------------------------------

def test_snapshot_checksum_rejects_corruption(tmp_path):
    path = str(tmp_path / "snap.npz")
    meta = {"version": 1, "who": "unit"}
    arrays = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
              "b": np.linspace(0, 1, 5, dtype=np.float32)}
    snaplib.write_snapshot(path, meta, arrays)
    m2, a2 = snaplib.read_snapshot(path)
    assert m2["who"] == "unit"
    np.testing.assert_array_equal(a2["a"], arrays["a"])
    # the reference reads the port's file, checksum included
    m3, a3 = jax_snap.read_snapshot(path)
    assert m3 == m2
    np.testing.assert_array_equal(a3["b"], arrays["b"])
    # corrupt one stored array but keep the OLD checksum: rewriting the
    # zip keeps the container readable, so the typed checksum error,
    # not a zip error, must fire
    with np.load(path) as data:
        members = {k: data[k] for k in data.files}
    members["['a']"] = members["['a']"] + 1
    np.savez(path[:-4], **members)
    with pytest.raises(snaplib.SnapshotChecksumError):
        snaplib.read_snapshot(path)


def test_snapshot_geometry_mismatch_is_typed(tmp_path):
    """A snapshot from a different pool geometry refuses to restore."""
    path = str(tmp_path / "geo.npz")
    eng = _engine("torch")
    eng.snapshot(path)
    other = _engine("torch", num_blocks=32)
    with pytest.raises(snaplib.SnapshotMismatchError):
        other.restore(path)


def test_bfloat16_arrays_round_trip(tmp_path):
    """A torch bf16 tensor goes to disk as its bit pattern under the
    ``"bfloat16"`` tag and comes back a bf16 tensor, bit for bit; the
    reference reads it as an ml_dtypes bf16 array with the same bits, and
    the port reads the reference's file the same way."""
    import ml_dtypes
    path = str(tmp_path / "bf16.npz")
    arr = torch.linspace(-3, 5, 8).to(torch.bfloat16)
    snaplib.write_snapshot(path, {}, {"kv": arr})
    _, arrays = snaplib.read_snapshot(path)
    assert arrays["kv"].dtype == torch.bfloat16
    assert torch.equal(arrays["kv"].view(torch.int16), arr.view(torch.int16))
    _, jarrays = jax_snap.read_snapshot(path)
    assert jarrays["kv"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(jarrays["kv"].view(np.uint16),
                                  arr.view(torch.int16).numpy()
                                  .view(np.uint16))
    jpath = str(tmp_path / "bf16-jax.npz")
    jarr = np.arange(8, dtype=np.float32).astype(ml_dtypes.bfloat16)
    jax_snap.write_snapshot(jpath, {}, {"kv": jarr})
    _, back = snaplib.read_snapshot(jpath)
    assert back["kv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back["kv"].view(torch.int16).numpy().view(np.uint16),
        jarr.view(np.uint16))
    assert torch.equal(back["kv"].float(), torch.arange(8.0))


# ---------------------------------------------------------------------------
# radix / swap-tier round-trip units
# ---------------------------------------------------------------------------

def _walk(cache):
    out = {}
    for node in cache.nodes():
        out[tuple(node.tokens)] = (node.block, node.pins, node.last_used,
                                   tuple(sorted(node.children)),
                                   tuple(sorted(node.partials)))
    return out


def test_radix_round_trip_preserves_structure_and_lru():
    """Serialize/deserialize keeps every node (full AND partial-tail),
    pins, per-node LRU stamps, the tree clock, and, because restore is
    structural, leaves the allocator's refcounts untouched."""
    alloc = BlockAllocator(32, BT)
    cache = RadixPrefixCache(alloc)
    t1 = alloc.allocate(0, 3 * BT)
    cache.insert(list(range(10)), t1)         # 2 full + 1 partial tail
    t2 = alloc.allocate(1, 2 * BT)
    cache.insert(list(range(8)), t2)          # shares the full prefix
    m = cache.match(list(range(10)))
    cache.pin(m.node)
    ref_before = dict(alloc.refcount)
    shape_before = _walk(cache)
    clock_before = cache._clock

    data, index = snaplib.snapshot_radix(cache)
    assert index[id(m.node)] >= 0
    restored = RadixPrefixCache(alloc)
    objs = snaplib.restore_radix(restored, data)
    assert _walk(restored) == shape_before
    assert restored._clock == clock_before
    assert alloc.refcount == ref_before, \
        "structural restore must not touch refcounts"
    assert sorted(restored.retained_blocks()) \
        == sorted(cache.retained_blocks())
    ridx = data["nodes"][index[id(m.node)]]
    assert objs[index[id(m.node)]].pins == m.node.pins == 1
    assert tuple(ridx["tokens"]) == tuple(m.node.tokens)
    cache.unpin(m.node)
    restored.unpin(objs[index[id(m.node)]])


def test_swap_tier_round_trip_preserves_dedup_slots():
    """Tier books (free-list order, slot_ref, by_block dedup map, FIFO
    resume order) and the used host pages round-trip exactly, through
    the reference's ``[P, L, n_used, ...]`` layout, into the restored
    tier's own (slot-major) store; the reference's tier restores the
    port's image to the same books and pages."""
    page = (2, 2, BT, 2, 4)
    tier = HostSwapTier(8, page, torch.float32)
    alloc = BlockAllocator(16, BT)
    t1 = list(alloc.allocate(0, 2 * BT))
    alloc.share(1, [t1[0]])                    # seq 1 shares t1's head
    t2 = list(alloc.allocate(1, 2 * BT))
    vals = torch.arange(2 * 2 * 2 * BT * 2 * 4, dtype=torch.float32) \
        .reshape(2, 2, 2, BT, 2, 4)
    fresh1 = tier.fresh_blocks(t1)
    alloc.free_seq(0)
    tier.swap_out(7, t1, fresh1, vals, alloc)
    fresh2 = tier.fresh_blocks(t2)             # t1[0] already host-resident
    alloc.free_seq(1)
    tier.swap_out(9, t2, fresh2, vals[:, :, :len(fresh2)], alloc)
    assert tier.deduped_blocks >= 1

    meta, store = snaplib.snapshot_swap_tier(tier)
    assert tuple(store.shape) == (2, 2, len(meta["used"]), BT, 2, 4)
    clone = HostSwapTier(8, page, torch.float32)
    store_ptr = clone._store.data_ptr()
    snaplib.restore_swap_tier(clone, meta, store)
    assert clone._store.data_ptr() == store_ptr, "the store was rebound"
    assert clone.free == tier.free
    assert clone.slot_ref == tier.slot_ref
    assert clone.by_block == tier.by_block
    assert list(clone.maps) == list(tier.maps)      # FIFO resume order
    assert clone.deduped_blocks == tier.deduped_blocks
    jclone = JaxSwapTier(8)
    jax_snap.restore_swap_tier(jclone, meta, store.numpy())
    assert jclone.free == tier.free and jclone.maps == tier.maps
    for rid in tier.maps:
        assert torch.equal(clone.read(tier.maps[rid]),
                           tier.read(tier.maps[rid]))
        np.testing.assert_array_equal(jclone.read(tier.maps[rid]),
                                      tier.read(tier.maps[rid]).numpy())
    with pytest.raises(snaplib.SnapshotMismatchError):
        snaplib.restore_swap_tier(HostSwapTier(4, page, torch.float32),
                                  meta, store)


# ---------------------------------------------------------------------------
# journal units
# ---------------------------------------------------------------------------

def test_journal_tolerates_torn_tail_only(tmp_path):
    path = str(tmp_path / "journal.wal")
    j = snaplib.AdmissionJournal(path)
    j.append("admit", rid=1)
    j.append("finish", rid=1, tokens=[5, 6])
    j.sync()
    j.close()
    with open(path, "a") as fh:
        fh.write('deadbeef {"kind": "admit", "rid"')   # torn mid-write
    records, torn = snaplib.AdmissionJournal.read(path)
    assert [r["kind"] for r in records] == ["admit", "finish"]
    assert torn == 1
    assert jax_snap.AdmissionJournal.read(path) == (records, torn)
    with pytest.raises(snaplib.JournalTornError):
        snaplib.AdmissionJournal.read(path, allow_torn=False)


def test_journal_midfile_corruption_is_fatal(tmp_path):
    path = str(tmp_path / "journal.wal")
    j = snaplib.AdmissionJournal(path)
    for rid in range(3):
        j.append("admit", rid=rid)
    j.close()
    lines = open(path).read().splitlines()
    payload = json.dumps({"kind": "admit", "rid": 99}, sort_keys=True)
    lines[1] = f"{zlib.crc32(b'not the payload'):08x} {payload}"
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with pytest.raises(snaplib.JournalCorruptError):
        snaplib.AdmissionJournal.read(path)     # even with allow_torn


# ---------------------------------------------------------------------------
# JOURNAL_EXPIRED: TTLs elapse across crash downtime
# ---------------------------------------------------------------------------

def test_downtime_expires_journaled_requests(tmp_path):
    """TTL'd requests whose deadline elapsed while the process was dead
    are typed ``journal_expired`` sheds, not replays, and the reason is
    a first-class ShedReason that the port's sim Metrics accept, as the
    reference's do."""
    from repro.sim.events import Metrics as JaxMetrics
    from repro_torch.sim.events import Metrics

    assert "journal_expired" in SHED_REASONS
    for metrics in (Metrics(), JaxMetrics()):
        metrics.record_shed("journal_expired")
        assert metrics.shed_reasons["journal_expired"] == 1
        with pytest.raises(ValueError):
            metrics.record_shed("journal_imploded")
    ckpt = str(tmp_path / "ckpt-ttl")
    reqs = _reqs("torch", seed=2)
    for r in reqs:
        r.ttl_steps = 40
    inj = FaultInjector([FaultEvent(window=1, kind="crash", seam="window")])
    eng = _engine("torch", faults=inj)
    mgr = snaplib.RecoveryManager(ckpt, snapshot_every=2)
    with pytest.raises(EngineCrash):
        drive_paged(eng, copy.deepcopy(reqs), recovery=mgr)
    mgr.close()
    eng2, report = snaplib.recover(lambda: _engine("torch"), ckpt,
                                   downtime_ticks=10_000)
    assert report["expired"] > 0
    reasons = {s.reason for s in eng2.shed_log}
    assert reasons <= {"journal_expired"}, reasons
    assert report["expired"] + len(eng2.generated) == report["journaled"]
    eng2.assert_drained()


# ---------------------------------------------------------------------------
# the flatten convention shared with the reference
# ---------------------------------------------------------------------------

def test_flatten_tree_keys_match_jax():
    """The port's torch/numpy flattener names every leaf as the
    reference's ``jax.tree_util`` one does (the engine snapshot's keys),
    in the same order, with the same values."""
    from repro.train.checkpoint import flatten_tree as jax_flatten
    from repro_torch.train.checkpoint import flatten_tree
    tree = {"w": np.ones((2, 3), np.float32), "b": np.zeros(3, np.float32),
            "opt": {"mu": [np.arange(2.0), (np.arange(3),)], "n": None,
                    "count": np.int64(7)}}
    want = jax_flatten(tree)
    got = flatten_tree(tree)
    assert list(got) == list(want)
    assert set(flatten_tree({"x": np.zeros(1)})) == {"['x']"}
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    t = flatten_tree({"logits": torch.ones(2, dtype=torch.bfloat16)})
    assert t["['logits']"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# across packages: snapshots and journals
# ---------------------------------------------------------------------------

#: an under-predicted shared-prefix run on a tight pool with a host tier
#: and the radix cache: the snapshot at window 6 holds an active row, a
#: suspended swap image and a radix tree (the reference refuses a
#: snapshot after an admitting window with the radix cache, so every 3)
CROSS = dict(num_blocks=24, swap_blocks=16, prefix_cache=True)
CROSS_RUN = dict(seed=1, underpredict=True, shared=True)
CROSS_EVENTS = (dict(window=2, kind="pool_shrink", blocks=12),)
CROSS_EVERY = 3

_SNAP_CACHE = {}


def _writer_snapshots(side, dtype, tmp):
    """``side``'s uncrashed CROSS run under a RecoveryManager, snapshotting
    every ``CROSS_EVERY`` windows into ``tmp``.  Returns the path of the
    first snapshot holding an active row, a suspended image and a radix
    tree, and the run's streams in request order."""
    key = (side, dtype)
    if key not in _SNAP_CACHE:
        eng_mod, _, _, snap = SIDES[side]
        inj = _injector(side, CROSS_EVENTS)
        eng = _engine(side, faults=inj, dtype=dtype, **CROSS)
        mgr = snap.RecoveryManager(tmp, snapshot_every=CROSS_EVERY)
        reqs = _reqs(side, **CROSS_RUN)
        stats = eng_mod.drive_paged(eng, reqs, recovery=mgr)
        mgr.close()
        assert stats["served"] == N and stats["swap_outs"] >= 1, stats
        inj.release(eng.allocator)
        eng.assert_drained()
        pick = None
        for name in sorted(os.listdir(tmp)):
            if not name.startswith("snap-"):
                continue
            meta, _ = snaplib.read_snapshot(os.path.join(tmp, name))
            if meta["swapped"] and meta["radix"]["nodes"] \
                    and any(a is not None for a in meta["active"]):
                pick = os.path.join(tmp, name)
                break
        assert pick is not None, "no snapshot with a swap image"
        _SNAP_CACHE[key] = (pick, [eng.generated[r.req_id] for r in reqs])
    return _SNAP_CACHE[key]


@pytest.fixture(scope="module")
def cross_dir():
    d = tempfile.mkdtemp(prefix="torch-recovery-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _finish_restored(side, path, dtype):
    """Restore ``path`` into a fresh ``side`` engine (no faults: the
    writer's fault-held blocks are freed) and serve what it holds to
    the end.  Returns the streams in the writer's request order (None
    for a request the snapshot does not hold) and the engine."""
    eng = _engine(side, dtype=dtype, **CROSS)
    eng.restore(path)
    meta, _ = snaplib.read_snapshot(path)
    held = {a["req"]["req_id"] for a in meta["active"] if a is not None}
    held |= {img["rid"] for img in meta["swapped"]}
    held |= {rid for rid, _ in meta["generated"]}
    assert eng.num_suspended >= 1 and eng.num_active >= 1
    SIDES[side][0].drive_paged(eng, [])
    assert eng.replayed_reprefill_tokens == 0
    eng.assert_drained()
    assert eng.swap.empty
    return held, eng


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_restores_across_packages(cross_dir, writer, dtype):
    """A snapshot written by ``writer`` (a radix tree, an active row and
    a suspended swap image) restores into the other package's engine,
    which serves every request it holds to the streams of the writer's
    uncrashed run, with nothing re-prefilled and both tiers drained."""
    reader = "torch" if writer == "jax" else "jax"
    path, streams = _writer_snapshots(
        writer, dtype, os.path.join(cross_dir, f"{writer}-{dtype}"))
    held, eng = _finish_restored(reader, path, dtype)
    wreqs = _reqs(writer, **CROSS_RUN)
    rreqs = _reqs(reader, **CROSS_RUN)
    assert len(held) >= 2
    for i, (w, r) in enumerate(zip(wreqs, rreqs)):
        if w.req_id in held:
            assert eng.generated[w.req_id] == streams[i], \
                f"request {i} diverged from the writer's run"


def _recover_with(side, ckpt, **engine_kw):
    eng, report = SIDES[side][3].recover(
        lambda: _engine(side, **engine_kw), ckpt, snapshot_every=2)
    eng.assert_drained()
    return eng, report


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_recover_journal_across_packages(tmp_path, writer):
    """A crash mid-window after two snapshots, on the radix cache:
    ``writer``'s journal and snapshot are recovered by both packages,
    with the same report and the uncrashed streams (which both
    packages' uncrashed runs give)."""
    kw = dict(prefix_cache=True)
    ref = _references(**kw)
    ckpt = tmp_path / "ckpt"
    crashed, _, _, _ = _crash(writer, ckpt, "window", 5, **kw)
    assert crashed
    out = {}
    for side in ("jax", "torch"):
        d = str(tmp_path / f"recover-{side}")
        shutil.copytree(ckpt, d)
        eng, report = _recover_with(side, d, **kw)
        reqs = _reqs(writer)
        out[side] = ({k: report[k] for k in (
            "journaled", "outstanding", "expired", "recovered",
            "replayed_reprefill_tokens", "torn_records",
            "journal_confirmed", "journal_mismatches")},
            os.path.basename(report["snapshot_used"]),
            [eng.generated.get(r.req_id) for r in reqs])
    assert out["torch"] == out["jax"]
    report, used, streams = out["torch"]
    assert used is not None and report["recovered"] == N
    assert report["replayed_reprefill_tokens"] == 0
    assert report["journal_mismatches"] == 0
    assert streams == ref


# ---------------------------------------------------------------------------
# in place
# ---------------------------------------------------------------------------

def _addresses(eng):
    return {"logits": eng.logits.data_ptr(),
            "positions": eng.positions.data_ptr(),
            "tables": eng.tables.data_ptr(),
            "active": eng.active_mask.data_ptr(),
            "store": eng.swap._store.data_ptr(),
            **{f"pages.{key}": v.data_ptr() for key, v in eng.pages.items()}}


def test_restore_keeps_addresses(cross_dir):
    """The restore writes the logits, positions, tables, active mask,
    both pools and the tier's store in place (a decode graph captured
    before it replays on those addresses), on an engine that
    ``warmup()`` ran on; the restored slot state is the file's, and the
    served streams are the writer's."""
    path, streams = _writer_snapshots(
        "torch", "f32", os.path.join(cross_dir, "torch-f32"))
    eng = _engine("torch", warmup=True, **CROSS)
    want = _addresses(eng)
    eng.restore(path)
    assert _addresses(eng) == want, "the restore rebound a tensor"
    meta, arrays = snaplib.read_snapshot(path)
    assert torch.equal(eng.logits, torch.from_numpy(arrays["logits"]))
    blocks = torch.tensor(meta["page_blocks"])
    from repro_torch.models import model as M
    assert torch.equal(M.gather_pages(eng.pages, blocks),
                       torch.from_numpy(arrays["page_values"]))
    for slot, a in enumerate(meta["active"]):
        assert bool(eng.active_mask[slot]) == (a is not None)
        if a is not None:
            assert int(eng.positions[slot]) == a["pos"]
    drive_paged(eng, [])
    assert _addresses(eng) == want
    reqs = _reqs("torch", **CROSS_RUN)
    for i, r in enumerate(reqs):
        if r.req_id in eng.generated:
            assert eng.generated[r.req_id] == streams[i]
    eng.assert_drained()


# ---------------------------------------------------------------------------
# the launcher, and what §17 refuses
# ---------------------------------------------------------------------------

def test_launcher_restores_on_start_like_jax(tmp_path):
    """Two launcher runs on one checkpoint directory, the second
    recovering the first's journal before it serves: the port's counts
    and §17 keys equal the reference launcher's on the same inputs."""
    from repro.configs import get_config as jax_config
    from repro.launch.serve import run_paged_engine_backend as jax_run
    from repro.models import model as JM
    from repro_torch.launch.serve import run_paged_engine_backend
    from repro_torch.params import params_from_numpy

    jcfg = jax_config("smollm-135m").reduced()
    tp = params_from_numpy(jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))),
        device="cpu")
    keys = ("requests", "steps", "snapshots_taken", "journal_records",
            "replayed_reprefill_tokens", "swap_outs")
    runs = {}
    for side in ("jax", "torch"):
        ckpt = str(tmp_path / side)
        runs[side] = []
        for _ in range(2):
            if side == "jax":
                out = jax_run("smollm-135m", 3.0, 3.0, "magnus-paged",
                              checkpoint_dir=ckpt, snapshot_every=2)
            else:
                out = run_paged_engine_backend(
                    "smollm-135m", 3.0, 3.0, "magnus-paged", device="cpu",
                    params=tp, checkpoint_dir=ckpt, snapshot_every=2)
                out.pop("engine").assert_drained()
            rec = out["recovered_on_start"]
            runs[side].append(({k: out[k] for k in keys},
                               None if rec is None else
                               {k: v for k, v in rec.items()
                                if k != "restore_s"}))
    assert runs["torch"] == runs["jax"]
    first, second = runs["torch"]
    assert first[0]["requests"] > 0 and first[0]["snapshots_taken"] > 0
    assert first[1] is None
    assert second[1] == {"journaled": first[0]["requests"], "outstanding": 0,
                         "recovered": first[0]["requests"],
                         "replayed_reprefill_tokens": 0, "torn_records": 0}


def test_spec_engines_are_refused(tmp_path):
    """§17 does not cover speculative engines: the launcher refuses
    ``spec_decode`` with a checkpoint directory, and a spec engine
    refuses to snapshot and to restore."""
    from repro_torch.launch.serve import main, run_paged_engine_backend
    with pytest.raises(ValueError, match="speculative"):
        run_paged_engine_backend("smollm-135m", 1.0, 1.0, "magnus-paged",
                                 device="cpu", spec_decode=True,
                                 checkpoint_dir=str(tmp_path / "c"))
    with pytest.raises(SystemExit):
        main(["--strategy", "magnus-paged", "--backend", "engine",
              "--spec-decode",
              "--checkpoint-dir", str(tmp_path / "c"), "--device", "cpu"])
    spec = _engine("torch", spec_decode=True, draft_k=2)
    with pytest.raises(snaplib.SnapshotError, match="speculative"):
        spec.snapshot(str(tmp_path / "spec.npz"))
    path = _engine("torch").snapshot(str(tmp_path / "plain.npz"))
    with pytest.raises(snaplib.SnapshotError, match="speculative"):
        _engine("torch", spec_decode=True, draft_k=2).restore(path)
