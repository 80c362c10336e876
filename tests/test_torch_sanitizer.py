"""The port's serve-sanitizer (``repro_torch/analysis/sanitizer.py``)
against the reference's ``tests/test_sanitizer.py`` on the CPU:

- the shadow allocator: writes into cache-held or materialized-shared
  blocks raise ``SharedWriteError`` with provenance, publish-then-admit
  sharing (§12) stays legal, a double release is caught, and the drain
  audit catches a leaked retain with the sanitizer off;
- engine level: breaking copy-on-write makes the next radix-hit
  admission fail loudly, on the port as on JAX;
- the ``REPRO_SANITIZE`` sync ledger sums to the engine's
  ``host_syncs``, and under faults and the swap tier its (file,
  function) sites and counts equal the JAX engine's, and lie within the
  static sync sites of the port's lint (``hotlint.collect_sync_sites``),
  as the reference's lie within its own lint's.

The reference's donation test checks a JAX buffer rule that PyTorch has
no counterpart of."""
from pathlib import Path

import pytest

from repro.analysis import sanitizer as jax_sanitizer
from repro.core.types import Request as JaxRequest
from repro_torch.analysis import hotlint, sanitizer
from repro_torch.analysis.sanitizer import (BlockLeakError, DoubleFreeError,
                                            SharedWriteError)
from repro_torch.core.types import Request
from repro_torch.serving.paged_cache import BlockAllocator

from test_torch_chaos import SIDES, make_engine, run_pair

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# shadow allocator units
# ---------------------------------------------------------------------------

def test_shadow_flags_write_into_cache_held_block(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    a = BlockAllocator(num_blocks=8, block_tokens=4)
    t = a.allocate(0, 8)
    a.retain([t[1]], holder=sanitizer.CACHE_HOLDER)
    a._shadow.check_write(0, [t[0]])          # sole holder: fine
    with pytest.raises(SharedWriteError):
        a._shadow.check_write(0, [t[1]])      # cache still references it


def test_shadow_permits_publish_then_admit_until_materialized(monkeypatch):
    """§12: a publisher's blocks may be shared with same-wave sharers
    before the wave writes KV; the write becomes illegal only once the
    publisher's pages hold real data."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    a = BlockAllocator(num_blocks=8, block_tokens=4)
    t = a.allocate(0, 4)
    a.share(1, [t[0]])
    a._shadow.check_write(1, [t[0]])          # pre-dispatch: legal
    a._shadow.mark_materialized(0)
    with pytest.raises(SharedWriteError):
        a._shadow.check_write(1, [t[0]])      # would clobber live KV


def test_shadow_flags_double_release(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    a = BlockAllocator(num_blocks=8, block_tokens=4)
    t = a.allocate(0, 4)
    a.free_seq(0)
    with pytest.raises(DoubleFreeError):
        a._shadow.on_release([t[0]], 0)


def test_drain_accounting_catches_leaked_retain(monkeypatch):
    """check_allocator works with the sanitizer OFF: a holder-less stray
    retain survives free_seq and unbalances the books."""
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    a = BlockAllocator(num_blocks=8, block_tokens=4)
    assert a._shadow is None
    t = a.allocate(0, 8)
    sanitizer.check_allocator(a)              # balanced while live
    a.retain([t[0]])                          # leaked reference
    a.free_seq(0)
    with pytest.raises(BlockLeakError):
        sanitizer.check_allocator(a)


# ---------------------------------------------------------------------------
# engine level: broken COW is caught at the next admission
# ---------------------------------------------------------------------------

_INSTR = "alpha beta gamma delta epsilon zeta eta theta"   # +BOS = 9 toks


def _radix_req(cls, i, user_input):
    n_in = len(user_input.split())
    return cls(app=f"app{i}", task=f"app{i}", instruction=_INSTR,
               user_input=user_input,
               length=len(_INSTR.split()) + 1 + n_in,
               user_input_length=n_in, gen_length=4,
               predicted_gen_length=4)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_broken_cow_raises_shared_write_on_radix_hit(side, monkeypatch):
    """Disable copy-on-write and admit a radix hit whose shared prefix
    ends mid-block (9 tokens, block_tokens=4): the wave would append
    suffix KV into the cache-held partial tail, and the shadow stops the
    dispatch before the write, on both sides."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    cache_mod = SIDES[side][2]
    monkeypatch.setattr(cache_mod.BlockAllocator, "cow_if_not_appendable",
                        lambda self, seq_id, idx: None)
    errors = {"jax": jax_sanitizer.SharedWriteError,
              "torch": SharedWriteError}
    cls = JaxRequest if side == "jax" else Request
    eng, _ = make_engine(side, max_concurrency=4, num_blocks=64,
                         block_tokens=4, max_len=64, max_gen=8,
                         prefix_cache=True)
    eng.join(_radix_req(cls, 0, "foo bar baz"))   # publishes the 9-token head
    with pytest.raises(errors[side]):
        eng.join(_radix_req(cls, 1, "qux quux corge"))


# ---------------------------------------------------------------------------
# the host-sync ledger
# ---------------------------------------------------------------------------

def _ledger_reqs(mod):
    reqs = mod.make_dataset(2, seed=2)[:4]
    for i, r in enumerate(reqs):
        r.user_input = " ".join(r.user_input.split()[:6])
        r.gen_length = 3 + (i * 3) % 10
        r.predicted_gen_length = max(1, r.gen_length // 3)
    return reqs


def test_sync_ledger_matches_counter_and_jax(monkeypatch):
    """Under ``REPRO_SANITIZE=1`` every counted readback is tallied at
    its (file, function) site: the ledger sums to ``host_syncs``, and
    under a poison, a pool shrink and the swap tier (window readbacks,
    the NaN guard's, the swap-outs' page and logits copies) its sites
    and counts equal the JAX engine's."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    plan = [dict(window=2, kind="poison_logits", slot=1),
            dict(window=3, kind="pool_shrink", blocks=10),
            dict(window=7, kind="pool_restore")]
    jax_sanitizer.reset_sync_ledger()
    sanitizer.reset_sync_ledger()
    runs = run_pair(_ledger_reqs, plan, max_concurrency=4, num_blocks=20,
                    block_tokens=4, max_len=64, max_gen=10, swap_blocks=32)
    ledgers = {"jax": jax_sanitizer.sync_ledger(),
               "torch": sanitizer.sync_ledger()}
    for side, ledger in ledgers.items():
        assert ledger, "sanitized run recorded no sync sites"
        assert sum(ledger.values()) == runs[side][0].host_syncs
    assert runs["torch"][0].swap_outs > 0
    assert runs["torch"][0].quarantined == 1
    assert ledgers["torch"] == ledgers["jax"]
    assert {fn for _, fn in ledgers["torch"]} == {
        "step_window", "_swap_out"}
    sanitizer.check_sync_ledger(set(ledgers["jax"]))
    static = hotlint.collect_sync_sites([str(ROOT / "src" / "repro_torch")])
    assert set(ledgers["torch"]) <= static
    sanitizer.check_sync_ledger(static)
    with pytest.raises(sanitizer.SyncLedgerError):
        sanitizer.check_sync_ledger({("engine.py", "step_window")})
