"""The PyTorch port's speculative-decoding model entry points (DESIGN.md
§16) against the JAX reference, at f32 on reduced configs with the
reference's weights carried across by ``params_from_numpy``:
``draft_window`` (the draft's fused paged decode, its first token forced
to the target's argmax) and ``verify_window`` (one batched target pass
over the whole window through the prefix-prefill path, greedy match,
cumprod accept, the ``max_emit`` clamp, the carry-logit gather and the
packed readback), and their in-place forms, which a CUDA graph
captures, against the functional ones bit for bit.

The inputs have three active rows at mixed positions (one proposal
broken mid-window so that it is rejected there, one budget clamped to
2) and one inactive row (null table, position 0), whose writes land in
the null block: the port writes them there where JAX drops them, in no
fixed order (an inactive row's window writes one null slot twice when
it is wider than a block), so the null block is left out of the page
comparisons."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.params import params_from_numpy

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

TOL = 2e-4     # f32, of the reference's largest magnitude
NULL = 47
CONFIGS = {"smollm": dict(arch="smollm-135m", num_layers=2, d_model=64),
           "chatglm": dict(arch="chatglm-6b")}      # MHA: G = 1


@functools.lru_cache(maxsize=None)
def _setup(name):
    kw = dict(CONFIGS[name])
    arch = kw.pop("arch")
    jcfg, tcfg = jax_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _inputs(cfg, seed=1):
    """Four rows: three active at positions 5, 17 and 30 in distinct
    random pages (48 blocks of 8; 6 a table, room for a 9-wide window),
    one idle (null table, position 0); random carried logits."""
    rng = np.random.default_rng(seed)
    b, nb, bt, mb = 4, 48, 8, 6
    tables = np.full((b, mb), NULL, np.int32)
    tables[:3] = rng.permutation(np.arange(NULL))[:3 * mb].reshape(3, mb)
    shape = (cfg.num_layers, nb, bt, cfg.num_kv_heads, cfg.head_dim)
    return {"pages": {key: rng.normal(size=shape).astype(np.float32)
                      for key in ("k", "v")},
            "logits": rng.normal(size=(b, cfg.padded_vocab))
            .astype(np.float32),
            "draft_logits": rng.normal(size=(b, cfg.padded_vocab))
            .astype(np.float32),
            "positions": np.array([5, 17, 30, 0], np.int32),
            "tables": tables, "active": np.array([1, 1, 1, 0], bool)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


def _jit(fn, jcfg, **static):
    return jax.jit(functools.partial(fn, cfg=jcfg, act_dtype=jnp.float32,
                                     **static))


def _draft(jcfg, tcfg, jp, tp, x, w):
    """Both packages' draft window (a self-draft: the target's weights)
    on the same inputs.  Returns the JAX and port results."""
    jd = _jit(JM.draft_window, jcfg, num_steps=w,
              target_vocab=jcfg.vocab_size)
    jl, jpages, jprop = jd(
        jp, pages=jax.tree.map(jnp.asarray, x["pages"]),
        batch={"target_logits": x["logits"], "logits": x["draft_logits"],
               "positions": x["positions"], "block_tables": x["tables"],
               "active": x["active"]})
    tpages = {key: _t(v) for key, v in x["pages"].items()}
    tl, tpages, tprop = M.draft_window(
        tp, tcfg, tpages,
        {"target_logits": _t(x["logits"]), "logits": _t(x["draft_logits"]),
         "positions": _t(x["positions"]), "block_tables": _t(x["tables"]),
         "active": _t(x["active"])},
        num_steps=w, target_vocab=tcfg.vocab_size, act_dtype=torch.float32)
    return (jl, jpages, np.asarray(jprop)), (tl, tpages, tprop)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("draft_k", [1, 4, 8])
def test_draft_window_matches_jax(name, draft_k):
    """Proposals equal, draft logits and pages within f32's 2e-4 (the
    null block left out), and the in-place form bit-equal to the
    functional one, its position untouched."""
    jcfg, tcfg, jp, tp = _setup(name)
    x = _inputs(tcfg)
    w = draft_k + 1
    (jl, jpages, jprop), (tl, tpages, tprop) = _draft(jcfg, tcfg, jp, tp,
                                                      x, w)
    live = x["active"]
    assert np.array_equal(tprop.numpy()[live], jprop[live])
    assert np.array_equal(tprop.numpy()[:, 0],
                          x["logits"][:, :tcfg.vocab_size].argmax(1))
    _close(tl[live], np.asarray(jl)[live])
    for key in ("k", "v"):
        _close(tpages[key][:, :NULL], np.asarray(jpages[key])[:, :NULL])
    # the in-place form: the draft carry written, positions not advanced
    state = {"target_logits": _t(x["logits"]),
             "logits": _t(x["draft_logits"]),
             "positions": _t(x["positions"]), "tables": _t(x["tables"]),
             "active": _t(x["active"])}
    pages = {key: _t(v) for key, v in x["pages"].items()}
    out = torch.full((4, w), -1, dtype=torch.int32)
    M.draft_window_into(tp, tcfg, pages, state, out,
                        target_vocab=tcfg.vocab_size, act_dtype=torch.float32)
    assert torch.equal(out, tprop)
    assert torch.equal(state["logits"], tl)
    assert torch.equal(state["positions"], _t(x["positions"]))
    for key in ("k", "v"):
        assert torch.equal(pages[key][:, :NULL], tpages[key][:, :NULL])


def _proposals(x, prop, w):
    """The self-draft's proposals, with row 1 broken at its third token
    (a rejection mid-window, when the window has one) and the budget of
    row 0 clamped to 2."""
    prop = np.array(prop, np.int32)
    if w > 2:
        prop[1, 2] = (prop[1, 2] + 1) % 100 + 3
    max_emit = np.full(4, w, np.int32)
    max_emit[0] = 2
    return prop, max_emit


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("draft_k", [1, 4, 8])
def test_verify_window_matches_jax(name, draft_k):
    """On the self-draft's proposals (row 1 broken mid-window, row 0's
    budget 2): packed tokens and emit counts and positions equal,
    carried logits and pages within 2e-4, the inactive row emitting 0
    and keeping its logits; the in-place form bit-equal."""
    jcfg, tcfg, jp, tp = _setup(name)
    x = _inputs(tcfg)
    w = draft_k + 1
    _, (_, _, tprop) = _draft(jcfg, tcfg, jp, tp, x, w)
    prop, max_emit = _proposals(x, tprop.numpy(), w)
    jv = _jit(JM.verify_window, jcfg)
    jl, jpages, jpos, jpacked = jv(
        jp, pages=jax.tree.map(jnp.asarray, x["pages"]),
        batch={"proposed": prop, "logits": x["logits"],
               "positions": x["positions"], "block_tables": x["tables"],
               "active": x["active"], "max_emit": max_emit})
    tpages = {key: _t(v) for key, v in x["pages"].items()}
    tl, tpages, tpos, tpacked = M.verify_window(
        tp, tcfg, tpages,
        {"proposed": _t(prop), "logits": _t(x["logits"]),
         "positions": _t(x["positions"]), "block_tables": _t(x["tables"]),
         "active": _t(x["active"]), "max_emit": _t(max_emit)},
        null_block=NULL, act_dtype=torch.float32)
    jpacked = np.asarray(jpacked)
    assert np.array_equal(tpacked.numpy(), jpacked)
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    emitted = jpacked[:, w]
    assert emitted[3] == 0 and emitted[0] == min(2, w)
    assert 1 <= emitted[1] <= (2 if w > 2 else w)
    assert emitted[2] >= 1
    _close(tl, np.asarray(jl))
    assert torch.equal(tl[3], _t(x["logits"][3]))
    for key in ("k", "v"):
        _close(tpages[key][:, :NULL], np.asarray(jpages[key])[:, :NULL])
    state = {"logits": _t(x["logits"]), "positions": _t(x["positions"]),
             "tables": _t(x["tables"]), "active": _t(x["active"]),
             "max_emit": _t(max_emit)}
    pages = {key: _t(v) for key, v in x["pages"].items()}
    packed = torch.full((4, w + 1), -1, dtype=torch.int32)
    M.verify_window_into(tp, tcfg, pages, state, _t(prop), packed,
                         null_block=NULL, act_dtype=torch.float32)
    assert torch.equal(packed, tpacked)
    assert torch.equal(state["logits"], tl)
    assert torch.equal(state["positions"], tpos)
    for key in ("k", "v"):
        assert torch.equal(pages[key][:, :NULL], tpages[key][:, :NULL])


def test_self_draft_window_accepts_every_proposal():
    """A self-draft's window through the port alone: every active row
    whose budget allows it emits the whole window, and the verify's
    carried logits give the next token that ``W`` sequential decode steps
    give (the two paths agree on the stream)."""
    _, tcfg, _, tp = _setup("smollm")
    x = _inputs(tcfg)
    w = 5
    pages = {key: _t(v) for key, v in x["pages"].items()}
    _, _, prop = M.draft_window(
        tp, tcfg, {key: v.clone() for key, v in pages.items()},
        {"target_logits": _t(x["logits"]), "logits": _t(x["draft_logits"]),
         "positions": _t(x["positions"]), "block_tables": _t(x["tables"]),
         "active": _t(x["active"])},
        num_steps=w, target_vocab=tcfg.vocab_size, act_dtype=torch.float32)
    seq_pages = {key: v.clone() for key, v in pages.items()}
    slog, _, spos, stoks = M.decode_multi_paged(
        tp, tcfg, seq_pages,
        {"logits": _t(x["logits"]), "positions": _t(x["positions"]),
         "block_tables": _t(x["tables"]), "active": _t(x["active"])},
        num_steps=w, act_dtype=torch.float32)
    live = torch.from_numpy(x["active"])
    assert torch.equal(prop[live], stoks[live])
    tl, _, tpos, packed = M.verify_window(
        tp, tcfg, pages,
        {"proposed": prop, "logits": _t(x["logits"]),
         "positions": _t(x["positions"]), "block_tables": _t(x["tables"]),
         "active": live, "max_emit": torch.full((4,), w, dtype=torch.int32)},
        null_block=NULL, act_dtype=torch.float32)
    assert packed[:, w].tolist() == [w, w, w, 0]
    assert torch.equal(tpos[live], spos[live])
    assert torch.equal(tl[live, :tcfg.vocab_size].argmax(1),
                       slog[live, :tcfg.vocab_size].argmax(1))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("draft_k", [1, 4, 8])
def test_batch_invariant_verify_equals_decode_steps(name, draft_k):
    """Inside ``batch_invariant()`` a verify of the W tokens that W
    sequential decode steps consume gives the steps' final logits and
    pool writes bit for bit, emitting W on every active row; the verify
    still matches JAX's within f32's 2e-4."""
    jcfg, tcfg, jp, tp = _setup(name)
    x = _inputs(tcfg)
    w = draft_k + 1
    batch = {"logits": _t(x["logits"]), "positions": _t(x["positions"]),
             "block_tables": _t(x["tables"]), "active": _t(x["active"])}
    live = torch.from_numpy(x["active"])
    with M.batch_invariant():
        spages = {key: _t(v) for key, v in x["pages"].items()}
        slog, spages, spos, stoks = M.decode_multi_paged(
            tp, tcfg, spages, batch, num_steps=w, act_dtype=torch.float32)
        vpages = {key: _t(v) for key, v in x["pages"].items()}
        vlog, vpages, vpos, packed = M.verify_window(
            tp, tcfg, vpages,
            dict(batch, proposed=stoks,
                 max_emit=torch.full((4,), w, dtype=torch.int32)),
            null_block=NULL, act_dtype=torch.float32)
    assert packed[:, w].tolist() == [w, w, w, 0]
    assert torch.equal(vlog[live], slog[live])
    assert torch.equal(vpos[live], spos[live])
    for key in ("k", "v"):
        assert torch.equal(vpages[key][:, :NULL], spages[key][:, :NULL])
    jv = _jit(JM.verify_window, jcfg)
    jl, _, _, jpacked = jv(
        jp, pages=jax.tree.map(jnp.asarray, x["pages"]),
        batch={"proposed": stoks.numpy(), "logits": x["logits"],
               "positions": x["positions"], "block_tables": x["tables"],
               "active": x["active"], "max_emit": np.full(4, w, np.int32)})
    assert np.array_equal(packed.numpy(), np.asarray(jpacked))
    _close(vlog, np.asarray(jl))


def test_batch_invariant_prefill_ignores_where_the_prefix_ends():
    """Inside ``batch_invariant()`` a prompt prefilled in one wave and
    the same prompt prefilled as a prefix wave ending mid-page and a
    suffix wave (a radix hit) give the same logits and pool bit for bit;
    the suffix attention, which writes the suffix K/V first, refuses to
    run without the wave's tables."""
    _, tcfg, _, tp = _setup("chatglm")
    rng = np.random.default_rng(2)
    b, bt, per, cut = 3, 4, 8, 7
    tables = _t(1 + np.arange(b * per, dtype=np.int32).reshape(b, per))
    lens = _t(np.array([9, 23, 17], np.int32))
    toks = _t(rng.integers(0, tcfg.vocab_size, (b, 23)).astype(np.int32))
    zeros = torch.zeros(b, dtype=torch.int32)
    slots = torch.arange(b, dtype=torch.int32)

    def wave(pages, tokens, plen, slen):
        state = {"tables": torch.zeros_like(tables),
                 "positions": zeros.clone(),
                 "active": torch.zeros(b, dtype=torch.bool),
                 "logits": torch.zeros(b, tcfg.padded_vocab)}
        M.prefill_wave(tp, tcfg, pages, state,
                       {"tokens": tokens, "lengths": slen,
                        "prefix_lens": plen, "attn_tables": tables,
                        "tables": tables, "write_lens": slen,
                        "cow_src": zeros, "cow_dst": zeros, "slots": slots,
                        "row_sel": slots, "positions": plen + slen},
                       null_block=0, act_dtype=torch.float32)
        return state["logits"]

    with M.batch_invariant():
        whole = M.init_paged_cache(tcfg, b * per + 1, bt, torch.float32,
                                   device="cpu")
        lw = wave(whole, toks, zeros, lens)
        split = M.init_paged_cache(tcfg, b * per + 1, bt, torch.float32,
                                   device="cpu")
        pre = torch.full_like(lens, cut)
        wave(split, toks[:, :cut].contiguous(), zeros, pre)
        suffix = torch.zeros_like(toks)
        suffix[:, :23 - cut] = toks[:, cut:]
        ls = wave(split, suffix, pre, lens - cut)
        assert torch.equal(lw, ls)
        for key in ("k", "v"):
            assert torch.equal(whole[key][:, 1:], split[key][:, 1:])
        with pytest.raises(ValueError, match="write"):
            M.prefill_suffix(tp, tcfg, whole,
                             {"tokens": toks, "lengths": lens,
                              "prefix_lens": zeros, "block_tables": tables},
                             act_dtype=torch.float32)
