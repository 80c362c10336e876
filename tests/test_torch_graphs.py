"""The paged engine's decode step as a captured CUDA graph
(``repro_torch/serving/graphs.py``), the port's counterpart of the
reference's compiled decode window.

On the CPU: the captured unit, ``decode_step_paged_into`` (one greedy
step written in place), repeated ``k`` times equals ``decode_multi_paged(k)``
bit for bit and the JAX ``decode_multi_paged`` at f32 on the same
weights; and a private split-counter buffer is what a capture's
launches get, and outlives the shared buffer's growth.

On the card (``cuda``-marked, a reduced chatglm-6b in f32 and bf16):
the replayed window equals ``decode_multi_paged`` run eagerly on cloned
state (tokens, logits, positions and pages bit-equal; also for a reduced
olmoe-1b-7b, its MoE FFN inside the graph), the kernels'
launch counts grow under replay as they do eagerly, a warmed engine
serves mixed, under-predicted lengths with no capture (the torch side of
the reference's ``test_recompile.py``), a later eager launch that grows
the shared counter buffer leaves a captured graph right, a replayed
window reads nothing on the host, and an engine warmed before it
restores a §17 snapshot replays its graph on the restored state (the
addresses the graph bound kept, no capture after the warmup's, streams
equal to the CPU engine's recovery)."""
import copy
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.analysis.sanitizer import count_host_reads
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import kernel as dkernel
from repro_torch.kernels.decode_attention import ops, ref
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
from repro_torch.serving.faults import FaultEvent, FaultInjector
from repro_torch.workload.apps import make_dataset

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

TOL = 2e-4          # f32, of the reference's largest magnitude
CFG = get_config("chatglm-6b").reduced()
ENGINE_KW = dict(max_concurrency=4, num_blocks=64, block_tokens=16,
                 max_len=64, max_gen=16)
DTYPES = [torch.float32, torch.bfloat16]


@functools.lru_cache(maxsize=None)
def _jax_setup():
    jcfg = jax_config("chatglm-6b").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _decode_inputs(cfg, seed=1):
    """Three rows at mixed positions in distinct random pages, one idle
    row (null table, position 0), random carried logits."""
    rng = np.random.default_rng(seed)
    b, nb, bt, mb, null = 4, 48, 8, 6, 47
    tables = np.full((b, mb), null, np.int32)
    tables[:3] = rng.permutation(np.arange(null))[:3 * mb].reshape(3, mb)
    shape = (cfg.num_layers, nb, bt, cfg.num_kv_heads, cfg.head_dim)
    return {"pages": {key: rng.normal(size=shape).astype(np.float32)
                      for key in ("k", "v")},
            "logits": rng.normal(size=(b, cfg.padded_vocab))
            .astype(np.float32),
            "positions": np.array([5, 17, 30, 0], np.int32),
            "tables": tables, "active": np.array([1, 1, 1, 0], bool)}


def test_decode_step_into_matches_fused_decode_and_jax():
    """The captured unit, k times in place, against the port's fused
    window (bit for bit) and the JAX fused window (tokens and positions
    equal, logits and pages at f32's 2e-4; the null block is the idle
    row's write sink and is left out)."""
    jcfg, jp, tp = _jax_setup()
    x = _decode_inputs(CFG)
    k, null = 3, 47
    t = lambda a: torch.from_numpy(np.array(a))
    state = {key: t(x[key]) for key in ("logits", "positions", "tables",
                                         "active")}
    pages = {key: t(v) for key, v in x["pages"].items()}
    tok = torch.zeros(4, dtype=torch.int32)
    toks = []
    for _ in range(k):
        M.decode_step_paged_into(tp, CFG, pages, state, tok,
                                 act_dtype=torch.float32)
        toks.append(tok.clone())
    toks = torch.stack(toks, 1)
    flog, fpages, fpos, ftoks = M.decode_multi_paged(
        tp, CFG, {key: t(v) for key, v in x["pages"].items()},
        {"logits": t(x["logits"]), "positions": t(x["positions"]),
         "block_tables": t(x["tables"]), "active": t(x["active"])},
        num_steps=k, act_dtype=torch.float32)
    assert torch.equal(toks, ftoks)
    assert torch.equal(state["logits"], flog)
    assert torch.equal(state["positions"], fpos)
    for key in ("k", "v"):
        assert torch.equal(pages[key], fpages[key])
    jdec = jax.jit(functools.partial(JM.decode_multi_paged, cfg=jcfg,
                                     act_dtype=jnp.float32),
                   static_argnames=("num_steps",))
    jlog, jpages, jpos, jtoks = jdec(
        jp, pages=jax.tree.map(jnp.asarray, x["pages"]),
        batch={"logits": x["logits"], "positions": x["positions"],
               "block_tables": x["tables"], "active": x["active"]},
        num_steps=k)
    assert np.array_equal(toks.numpy(), np.asarray(jtoks))
    assert np.array_equal(state["positions"].numpy(), np.asarray(jpos))
    live = x["active"]
    for got, want in ([state["logits"][live], np.asarray(jlog)[live]],
                      *([pages[key][:, :null], np.asarray(jpages[key])
                         [:, :null]] for key in ("k", "v"))):
        want = np.asarray(want, np.float64)
        err = np.abs(got.numpy().astype(np.float64) - want).max()
        assert err <= TOL * max(1.0, np.abs(want).max())


def test_private_split_counters_outlive_the_shared_buffer():
    """Inside ``private_split_counters`` a split launch's plan takes the
    private buffer (and refuses one too small); after the block a launch
    that needs more counters than the shared buffer holds replaces it,
    and the private buffer is untouched."""
    b, hq, d, bt, mb = 2, 4, 64, 16, 8
    q = torch.zeros(b, hq, d)
    pages = torch.zeros(8, bt, hq, d)
    tables = torch.zeros(b, mb, dtype=torch.int32)
    lengths = torch.ones(b, dtype=torch.int32)
    with dkernel.private_split_counters(q.device, b * hq) as mine:
        splits, *_, counters = dkernel.paged_decode_plan(
            q, pages, tables, lengths, sms=64)
        assert splits > 1 and counters is mine
        big = torch.zeros(4096, hq, d)
        with pytest.raises(ValueError, match="private split counters"):
            dkernel.paged_decode_plan(big, pages, torch.zeros(
                4096, mb, dtype=torch.int32), torch.ones(
                    4096, dtype=torch.int32), sms=16384)
    *_, shared = dkernel.paged_decode_plan(
        torch.zeros(4096, hq, d), pages,
        torch.zeros(4096, mb, dtype=torch.int32),
        torch.ones(4096, dtype=torch.int32), sms=16384)
    assert shared is not mine and shared.numel() >= 4096 * hq
    assert mine.numel() == 1024 and not mine.any()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _requests(n, seed, gen, undershoot=False, words=(2, 9, 30)):
    reqs = make_dataset(3, seed=seed)[:n]
    for i, r in enumerate(reqs):
        w = r.user_input.split() * 8
        r.user_input = " ".join(w[:words[i % len(words)]])
        r.gen_length = gen if isinstance(gen, int) else gen(i)
        r.predicted_gen_length = 1 if undershoot else r.gen_length
    return reqs


def _engine(dtype, cfg=CFG, **kw):
    return PagedContinuousEngine(cfg, seed=0, device="cuda", dtype=dtype,
                                 **{**ENGINE_KW, **kw})


def _snapshot(eng):
    return ({key: v.clone() for key, v in eng.pages.items()},
            {"logits": eng.logits.clone(), "positions": eng.positions.clone(),
             "block_tables": eng.tables.clone(),
             "active": eng.active_mask.clone()})


def _assert_window_equals_eager(eng, pages, batch, k, toks):
    """The engine's state after a replayed k-step window against
    ``decode_multi_paged`` on the snapshot taken before it; the null
    block (idle rows' write sink, written in no fixed order) is left
    out."""
    keep = torch.ones(eng.allocator.num_blocks, dtype=torch.bool,
                      device="cuda")
    keep[eng.null_block] = False
    n0 = ops.paged_decode_attention.launches
    logits, pages, positions, want = M.decode_multi_paged(
        eng.params, eng.cfg, pages, batch, num_steps=k, act_dtype=eng.dtype)
    assert ops.paged_decode_attention.launches - n0 == \
        eng.cfg.num_layers * k
    live = batch["active"]
    assert torch.equal(toks[live.cpu()], want[live].cpu())
    assert torch.equal(eng.logits, logits)
    assert torch.equal(eng.positions, positions)
    for key in ("k", "v"):
        assert torch.equal(eng.pages[key][:, keep], pages[key][:, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_captured_window_equals_eager_window(card, dtype):
    """Lazy capture (the first window's first step is the warm-up step),
    then a window of replays: each equals the eager fused window on a
    snapshot of the state, and each wrapper's launch count grows by
    layers x steps, as it does eagerly."""
    eng = _engine(dtype)
    reqs = _requests(3, seed=1, gen=16)
    assert eng.join_many(reqs) == 3
    for _ in range(2):
        pages, batch = _snapshot(eng)
        n0 = ops.paged_decode_attention.launches
        before = [a and len(a["generated"]) for a in eng.active]
        _, _, k = eng.step_window(max_steps=4)
        assert k == 4 and eng.graph_captures == 1
        assert ops.paged_decode_attention.launches - n0 == \
            CFG.num_layers * k
        toks = torch.full((eng.slots, k), -1, dtype=torch.int32)
        for slot, a in enumerate(eng.active):
            if a is not None:
                g = a["generated"]
                assert len(g) == before[slot] + k
                toks[slot] = torch.tensor(g[-k:], dtype=torch.int32)
        _assert_window_equals_eager(eng, pages, batch, k, toks)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_moe_window_captured_once_equals_eager(card, dtype):
    """A reduced olmoe-1b-7b engine: the capacity-dispatch FFN of every
    slot (the idle one included) inside the captured step.  One capture,
    one host sync a window as for the dense family, and each replayed
    window equals the eager fused window bit for bit."""
    eng = _engine(dtype, cfg=get_config("olmoe-1b-7b").reduced())
    assert eng.join_many(_requests(3, seed=1, gen=16)) == 3
    for _ in range(2):
        pages, batch = _snapshot(eng)
        syncs = eng.host_syncs
        _, _, k = eng.step_window(max_steps=4)
        assert k == 4 and eng.graph_captures == 1
        assert eng.host_syncs == syncs + 1
        toks = torch.full((eng.slots, k), -1, dtype=torch.int32)
        for slot, a in enumerate(eng.active):
            if a is not None:
                toks[slot] = torch.tensor(a["generated"][-k:],
                                          dtype=torch.int32)
        _assert_window_equals_eager(eng, pages, batch, k, toks)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_warmed_serve_captures_nothing(card, dtype):
    """``warmup()`` captures the step once; a mixed-length serve, then an
    under-predicted one (mid-serve table grows), adds no capture, and a
    second ``warmup()`` adds none.  The warmed engine's streams equal a
    lazily capturing engine's."""
    warm = _engine(dtype, warmup=True)
    assert warm.graph_captures == 1
    lazy = _engine(dtype)
    streams = {}
    for eng in (warm, lazy):
        out = []
        for seed, words, under in ((1, (2, 9, 30), False),
                                   (4, (4, 14, 55), True)):
            reqs = _requests(6, seed, lambda i: 1 + (seed + 5 * i) % 16,
                             undershoot=under, words=words)
            st = drive_paged(eng, reqs)
            assert st["served"] == len(reqs)
            out.append([eng.generated[r.req_id] for r in reqs])
        eng.assert_drained()
        streams[eng is warm] = out
    assert warm.graph_captures == lazy.graph_captures == 1
    warm.warmup()
    assert warm.graph_captures == 1
    assert streams[True] == streams[False]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_capture_survives_a_larger_eager_launch(card, dtype, monkeypatch):
    """The counter-buffer regression: capture, then an eager split launch
    that needs more counters than the shared buffer holds (so the buffer
    is replaced and the old one freed, and the freed memory is filled
    with junk), then replay: the window is still right."""
    eng = _engine(dtype, warmup=True)
    assert eng.join_many(_requests(3, seed=2, gen=16)) == 3
    eng.step_window(max_steps=2)
    b, hq, d = 512, 8, 64
    q = torch.randn(b, hq, d, device="cuda").to(dtype)
    pages = torch.randn(64, 16, hq, d, device="cuda").to(dtype)
    tables = torch.randint(0, 64, (b, 8), dtype=torch.int32, device="cuda")
    lengths = torch.full((b,), 100, dtype=torch.int32, device="cuda")
    shared = torch.zeros(1024, dtype=torch.int32, device="cuda")
    monkeypatch.setitem(dkernel._COUNTERS, q.device, shared)
    monkeypatch.setattr(dkernel, "_sm_count", lambda index: 4096)
    out = ops.paged_decode_attention(q, pages, pages, tables, lengths)
    assert dkernel._COUNTERS[q.device] is not shared
    monkeypatch.undo()
    del shared
    junk = torch.full((4096,), 7, dtype=torch.int32, device="cuda")
    want = ref.paged_decode_attention_ref(q, pages, pages, tables, lengths)
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    pages, batch = _snapshot(eng)
    _, _, k = eng.step_window(max_steps=4)
    assert k == 4
    toks = torch.full((eng.slots, k), -1, dtype=torch.int32)
    for slot, a in enumerate(eng.active):
        if a is not None:
            toks[slot] = torch.tensor(a["generated"][-k:], dtype=torch.int32)
    _assert_window_equals_eager(eng, pages, batch, k, toks)
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_replayed_window_reads_nothing(card, dtype):
    """A whole window, replays and the engine's bookkeeping, reads no
    tensor value on the host; its one readback is the one host sync."""
    eng = _engine(dtype, warmup=True)
    assert eng.join_many(_requests(4, seed=3, gen=16)) == 4
    eng.step_window(max_steps=1)
    syncs = eng.host_syncs
    with count_host_reads() as reads:
        _, _, k = eng.step_window(max_steps=8)
    assert k == 8 and reads["reads"] == 0
    assert eng.host_syncs == syncs + 1


@pytest.mark.cuda
def test_restored_engine_replays_its_graph_on_the_restored_state(
        card, tmp_path):
    """§17 under the captured graph: a CPU engine crashes mid-window
    after two snapshots; a CUDA engine built with ``warmup=True`` (its
    decode step captured before the restore) recovers the run: the
    restore keeps every address the graph bound, no window captures
    again, and every stream equals the CPU engine's recovery at f32."""
    from repro_torch.serving import snapshot as snaplib
    from repro_torch.serving.faults import EngineCrash
    tp, _ = _spec_params()
    kw = dict(ENGINE_KW, swap_blocks=16)
    reqs = _requests(6, 4, lambda i: 1 + (4 + 5 * i) % 16,
                     undershoot=True, words=(4, 14, 55))
    ckpt = tmp_path / "ckpt"
    crashed = PagedContinuousEngine(
        CFG, tp, device="cpu", faults=FaultInjector([FaultEvent(
            window=5, kind="crash", seam="window")]), **kw)
    mgr = snaplib.RecoveryManager(str(ckpt), snapshot_every=2)
    with pytest.raises(EngineCrash):
        drive_paged(crashed, [copy.deepcopy(r) for r in reqs], recovery=mgr)
    mgr.close()
    assert mgr.snapshots_taken == 2
    out, made = {}, []

    def build(device):
        eng = PagedContinuousEngine(CFG, _to(tp, device), device=device,
                                    warmup=device == "cuda", **kw)
        if device == "cuda":
            assert eng.graph_captures == 1
            g = eng._decode_graph
            made.append((eng, g, {
                **{key: t.data_ptr() for key, t in g.state.items()},
                **{f"pages.{k}": v.data_ptr() for k, v in eng.pages.items()}}))
        return eng

    for device in ("cpu", "cuda"):
        d = tmp_path / device
        shutil.copytree(ckpt, d)
        eng, report = snaplib.recover(lambda: build(device), str(d),
                                      snapshot_every=2)
        assert report["snapshot_used"] is not None
        assert report["recovered"] == len(reqs)
        assert report["replayed_reprefill_tokens"] == 0
        assert report["journal_mismatches"] == 0
        eng.assert_drained()
        out[device] = [eng.generated[r.req_id] for r in reqs]
    eng, graph, bound = made[0]
    assert eng.graph_captures == 1 and eng._decode_graph is graph
    assert {**{key: t.data_ptr() for key, t in {
        "logits": eng.logits, "positions": eng.positions,
        "tables": eng.tables, "active": eng.active_mask}.items()},
        **{f"pages.{k}": v.data_ptr() for k, v in eng.pages.items()}} \
        == bound
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------------------
# the speculative window (§16) as one captured graph
# ---------------------------------------------------------------------------

DRAFT = CFG.reduced(num_layers=1, d_model=128)      # head size 32


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@functools.lru_cache(maxsize=None)
def _spec_params():
    """The target's and a smaller draft's f32 weights, on the CPU (drawn
    there, so that both devices get the same values)."""
    return (M.init_params(CFG, seed=0, device="cpu"),
            M.init_params(DRAFT, seed=1, device="cpu"))


def _spec_engine(device, *, draft=False, **kw):
    tp, dp = _spec_params()
    extra = ({"draft_cfg": DRAFT, "draft_params": _to(dp, device)}
             if draft else {})
    return PagedContinuousEngine(CFG, _to(tp, device), device=device,
                                 dtype=torch.float32, spec_decode=True,
                                 draft_k=4, **extra, **{**ENGINE_KW, **kw})


def _spec_bound(eng):
    g = eng._spec_graph.state
    return {**{key: t.data_ptr() for key, t in g.items()},
            **{f"pages.{k}": v.data_ptr() for k, v in eng.pages.items()},
            **{f"draft_pages.{k}": v.data_ptr()
               for k, v in eng.draft_pages.items()}}


def _spec_addresses(eng):
    return {"logits": eng.logits.data_ptr(),
            "positions": eng.positions.data_ptr(),
            "tables": eng.tables.data_ptr(),
            "active": eng.active_mask.data_ptr(),
            "draft_logits": eng.draft_logits.data_ptr(),
            "draft_tables": eng.draft_tables.data_ptr(),
            "max_emit": eng._spec_graph.max_emit.data_ptr(),
            **{f"pages.{k}": v.data_ptr() for k, v in eng.pages.items()},
            **{f"draft_pages.{k}": v.data_ptr()
               for k, v in eng.draft_pages.items()}}


@pytest.mark.cuda
@pytest.mark.parametrize("draft", [False, True], ids=["self", "small"])
def test_spec_engine_captures_once_and_serves_like_cpu(card, draft):
    """A spec engine captures its window once (at its first window), a
    warmed one before its serve and never in it, and neither captures
    the plain decode step; both serve mixed, under-predicted lengths
    with the streams and counters of the eager CPU engine (f32, TF32
    off), which equal a spec-off engine's streams."""
    out = {}
    for name, dev, kw in (("cpu", "cpu", {}), ("lazy", "cuda", {}),
                          ("warm", "cuda", {"warmup": True})):
        eng = _spec_engine(dev, draft=draft, **kw)
        captures0 = eng.graph_captures
        reqs = _requests(6, 4, lambda i: 1 + (4 + 5 * i) % 16,
                         undershoot=True, words=(4, 14, 55))
        st = drive_paged(eng, reqs)
        assert st["served"] == len(reqs)
        eng.assert_drained()
        assert eng._decode_graph is None
        out[name] = ([eng.generated[r.req_id] for r in reqs],
                     {n: getattr(eng, n) for n in (
                         "host_syncs", "spec_windows", "spec_emitted",
                         "spec_accepted", "spec_drafted", "decode_steps",
                         "evictions", "prefill_tokens")},
                     (captures0, eng.graph_captures))
    assert out["cpu"][2] == (0, 0)
    assert out["lazy"][2] == (0, 1) and out["warm"][2] == (1, 1)
    assert out["lazy"][:2] == out["cpu"][:2] == out["warm"][:2]
    assert out["lazy"][1]["host_syncs"] == out["lazy"][1]["spec_windows"]
    tp, _ = _spec_params()
    ref = PagedContinuousEngine(CFG, tp, device="cpu", **ENGINE_KW)
    reqs = _requests(6, 4, lambda i: 1 + (4 + 5 * i) % 16,
                     undershoot=True, words=(4, 14, 55))
    drive_paged(ref, reqs)
    assert out["lazy"][0] == [ref.generated[r.req_id] for r in reqs]


@pytest.mark.cuda
def test_spec_graph_keeps_addresses_and_equals_eager(card):
    """After the capture, a draft quarantine, a swap-out (the draft pool
    dropped) and a resume (rebuilt) leave every tensor the window graph
    bound at its captured address; a replayed window then equals
    ``spec_window_into`` run eagerly on a snapshot of the state, bit for
    bit (packed tokens and counts, both logits, positions, both pools
    outside their null blocks)."""
    from repro_torch.serving.graphs import spec_window_into
    inj = FaultInjector([FaultEvent(window=2, kind="poison_draft_logits",
                                    slot=0)])
    eng = _spec_engine("cuda", draft=True, faults=inj, swap_blocks=32)
    reqs = _requests(3, seed=1, gen=16)
    assert eng.join_many(reqs) == 3
    eng.step_window(max_steps=2)                   # window 1: the capture
    assert eng.graph_captures == 1
    bound = _spec_bound(eng)
    assert _spec_addresses(eng) == bound
    eng.step_window(max_steps=2)                   # window 2: the guard
    assert inj.draft_poisoned == 1 and eng.draft_quarantined == 1
    live = next(s for s, a in enumerate(eng.active)
                if a is not None and not a.get("draft_cold"))
    assert eng._swap_out(live) and eng._resume_swapped() == 1
    assert _spec_addresses(eng) == bound and eng.graph_captures == 1
    snaps, speculate = [], eng._speculate

    def spy(max_emit):
        # the state the window starts from, after the window's grows
        snaps.append(({k: t.clone() for k, t in
                       eng._spec_graph.state.items()},
                      {k: v.clone() for k, v in eng.pages.items()},
                      {k: v.clone() for k, v in eng.draft_pages.items()},
                      torch.from_numpy(max_emit.copy()).cuda()))
        return speculate(max_emit)

    eng._speculate = spy
    _, _, k = eng.step_window()
    del eng._speculate
    assert k > 0 and eng.num_active == 3       # nobody finished
    snap, pages, dpages, max_emit = snaps[0]
    snap["max_emit"] = max_emit
    b, w = eng.slots, eng.spec_w
    want = torch.zeros((b, w + 1), dtype=torch.int32, device="cuda")
    spec_window_into(eng.params, eng.cfg, pages, eng.draft_params,
                     eng.draft_cfg, dpages, snap,
                     torch.zeros((b, w), dtype=torch.int32, device="cuda"),
                     want, null_block=eng.null_block,
                     act_dtype=torch.float32)
    live = eng.active_mask
    assert torch.equal(eng._spec_graph.packed[live], want[live])
    for key in ("logits", "positions", "draft_logits"):
        assert torch.equal(eng._spec_graph.state[key], snap[key]), key
    keep = torch.ones(eng.allocator.num_blocks, dtype=torch.bool,
                      device="cuda")
    keep[eng.null_block] = False
    for mine, theirs in ((eng.pages, pages), (eng.draft_pages, dpages)):
        for key in ("k", "v"):
            assert torch.equal(mine[key][:, keep], theirs[key][:, keep])
    st = drive_paged(eng, [])
    assert not st["unserved"] and len(eng.generated) == 3
    assert _spec_addresses(eng) == bound and eng.graph_captures == 1
    eng.assert_drained()


@pytest.mark.cuda
def test_batch_invariant_is_bit_exact_on_the_card(card):
    """Inside ``batch_invariant()`` on the card (f32, TF32 off): a verify
    of the W tokens that W decode steps consume gives the steps' final
    logits and pool writes bit for bit (the default arithmetic rounds
    the two apart, even in f32); and a graphed self-draft spec serve's
    streams equal a graphed spec-off serve's, every proposal accepted,
    with one capture."""
    tp, _ = _spec_params()
    params = _to(tp, "cuda")
    rng = np.random.default_rng(3)
    b, nb, bt, w = 4, 64, 16, 5
    tables = torch.from_numpy(
        rng.permutation(np.arange(1, nb))[:b * 3].reshape(b, 3)
        .astype(np.int32)).cuda()
    shape = (CFG.num_layers, nb, bt, CFG.num_kv_heads, CFG.head_dim)
    pages = {key: torch.from_numpy(rng.normal(size=shape)
                                   .astype(np.float32)).cuda()
             for key in ("k", "v")}
    batch = {"logits": torch.from_numpy(rng.normal(
                 size=(b, CFG.padded_vocab)).astype(np.float32)).cuda(),
             "positions": torch.tensor([3, 17, 30, 9], dtype=torch.int32,
                                       device="cuda"),
             "block_tables": tables,
             "active": torch.ones(b, dtype=torch.bool, device="cuda")}
    keep = torch.ones(nb, dtype=torch.bool, device="cuda")
    keep[0] = False
    with M.batch_invariant():
        spages = {key: v.clone() for key, v in pages.items()}
        slog, spages, spos, stoks = M.decode_multi_paged(
            params, CFG, spages, batch, num_steps=w,
            act_dtype=torch.float32)
        vpages = {key: v.clone() for key, v in pages.items()}
        vlog, vpages, vpos, packed = M.verify_window(
            params, CFG, vpages,
            dict(batch, proposed=stoks, max_emit=torch.full(
                (b,), w, dtype=torch.int32, device="cuda")),
            null_block=0, act_dtype=torch.float32)
        assert packed[:, w].tolist() == [w] * b
        assert torch.equal(vlog, slog) and torch.equal(vpos, spos)
        for key in ("k", "v"):
            assert torch.equal(vpages[key][:, keep], spages[key][:, keep])
        streams = {}
        for name, kw in (("off", {}), ("on", {"spec_decode": True,
                                              "draft_k": 4})):
            eng = PagedContinuousEngine(CFG, params, device="cuda",
                                        dtype=torch.float32,
                                        **{**ENGINE_KW, **kw})
            reqs = _requests(6, 4, lambda i: 1 + (4 + 5 * i) % 16,
                             undershoot=True, words=(4, 14, 55))
            st = drive_paged(eng, reqs)
            assert st["served"] == len(reqs)
            eng.assert_drained()
            streams[name] = [eng.generated[r.req_id] for r in reqs]
        assert eng.graph_captures == 1
        assert st["acceptance_rate"] == 1.0
    assert streams["on"] == streams["off"]
