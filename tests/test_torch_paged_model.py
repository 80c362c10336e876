"""The PyTorch port's paged model against the JAX reference, at f32 on
reduced configs with the reference's weights carried across by
``params_from_numpy``: one admission wave (misses, prefix hits, a
copy-on-write clone and a batch pad row) followed by a fused decode
window, with logits, emitted tokens, positions and pages compared.
Also: fused decode equals k sequential steps in the port itself."""
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

TOL = 2e-4     # f32, relative to each tensor's scale (see _allclose)
CONFIGS = {"smollm": dict(arch="smollm-135m", num_layers=2, d_model=64),
           "chatglm": dict(arch="chatglm-6b"),      # MHA: G = 1
           # MoE: the wave's pad row and the idle decode slots take part
           # in the capacity dispatch, as in JAX
           "olmoe": dict(arch="olmoe-1b-7b")}


def _configs(name):
    kw = dict(CONFIGS[name])
    arch = kw.pop("arch")
    return jax_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


@functools.lru_cache(maxsize=None)
def _setup(name):
    jcfg, tcfg = _configs(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _wave_inputs(cfg, seed=0):
    """Four rows (two misses, a 16-token prefix hit, a 12-token hit whose
    partial tail is a copy-on-write clone) plus one pad row repeating row
    0 with write_lens 0; the pool starts with random pages."""
    rng = np.random.default_rng(seed)
    nb, bt, null, mb, s = 64, 8, 63, 8, 16
    tables = rng.permutation(np.arange(1, null))[:4 * mb].reshape(4, mb)
    plens = np.array([0, 0, 16, 12])
    lens = np.array([16, 9, 7, 11])
    pad = lambda a, v=None: np.concatenate([a, a[:1] if v is None
                                            else np.asarray([v])])
    batch = {"tokens": pad(rng.integers(3, cfg.vocab_size, size=(4, s))),
             "lengths": pad(lens), "prefix_lens": pad(plens),
             "attn_tables": pad(tables), "tables": pad(tables),
             "write_lens": pad(lens, 0),
             "cow_src": np.array([null, null, null, tables[0, 0], null]),
             "cow_dst": np.array([null, null, null, tables[3, 1], null]),
             "slots": np.array([0, 1, 2, 3, 0]),
             "row_sel": np.array([0, 1, 2, 3, 0]),
             "positions": pad(plens + lens)}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    shape = (cfg.num_layers, nb, bt, cfg.num_kv_heads, cfg.head_dim)
    pages = {"k": rng.normal(size=shape).astype(np.float32),
             "v": rng.normal(size=shape).astype(np.float32)}
    state = {"tables": np.full((5, mb), null, np.int32),
             "positions": np.zeros(5, np.int32),
             "active": np.zeros(5, bool),
             "logits": np.zeros((5, cfg.padded_vocab), np.float32)}
    return batch, pages, state, null


def _allclose(a, b):
    """Max abs difference within TOL of the reference's largest magnitude
    (at least 1).  The reference's random weights (std 1/sqrt(L) on the
    stacked leaves) drive activations and K/V to tens, so an elementwise
    2e-4 would hold a value near 0 to a relative 1e-2 or tighter."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max()
    assert err <= TOL * max(1.0, np.abs(b).max()), (err, np.abs(b).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_wave_then_fused_decode_matches_jax(name):
    jcfg, tcfg, jp, tp = _setup(name)
    batch, pages, state, null = _wave_inputs(tcfg)
    k = 3
    # reference
    jwave = jax.jit(functools.partial(JM.prefill_wave, cfg=jcfg,
                                      act_dtype=jnp.float32))
    jdec = jax.jit(functools.partial(JM.decode_multi_paged, cfg=jcfg,
                                     act_dtype=jnp.float32),
                   static_argnames=("num_steps",))
    jpages, jstate = jwave(jp, pages=jax.tree.map(jnp.asarray, pages),
                           state=jax.tree.map(jnp.asarray, state),
                           batch=batch)
    jlog0 = np.asarray(jstate["logits"])
    jpages0 = jax.tree.map(np.asarray, jpages)
    active = np.array([True, True, True, False, False])
    jlog, jpages, jpos, jtoks = jdec(
        jp, pages=jpages,
        batch={"logits": jstate["logits"], "positions": jstate["positions"],
               "block_tables": jstate["tables"], "active": active},
        num_steps=k)
    # port
    tt = {key: torch.from_numpy(v) for key, v in batch.items()}
    tpages = {key: torch.from_numpy(v.copy()) for key, v in pages.items()}
    tstate = {key: torch.from_numpy(v.copy()) for key, v in state.items()}
    tpages, tstate = M.prefill_wave(tp, tcfg, tpages, tstate, tt,
                                    null_block=null,
                                    act_dtype=torch.float32)
    _allclose(tstate["logits"], jlog0)
    for key in ("tables", "positions", "active"):
        assert np.array_equal(tstate[key].numpy(), np.asarray(jstate[key]))
    for key in ("k", "v"):      # the null block is the write sink
        _allclose(tpages[key][:, :null], jpages0[key][:, :null])
    tlog, tpages, tpos, ttoks = M.decode_multi_paged(
        tp, tcfg, tpages,
        {"logits": tstate["logits"], "positions": tstate["positions"],
         "block_tables": tstate["tables"],
         "active": torch.from_numpy(active)},
        num_steps=k, act_dtype=torch.float32)
    assert np.array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    _allclose(tlog[active], np.asarray(jlog)[active])
    for key in ("k", "v"):
        _allclose(tpages[key][:, :null], np.asarray(jpages[key])[:, :null])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_decode_equals_sequential_steps(name):
    """k fused steps == k sequential decode_step_paged calls plus host
    argmax, bit for bit (k not a power of two)."""
    _, tcfg, _, tp = _setup(name)
    rng = np.random.default_rng(1)
    b, nb, bt, mb, k = 3, 64, 8, 12, 6
    pages = M.init_paged_cache(tcfg, nb, bt, dtype=torch.float32,
                               device="cpu")
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb))[:b * mb]
                              .reshape(b, mb).astype(np.int32))
    positions = torch.tensor([5, 9, 3], dtype=torch.int32)
    logits = torch.from_numpy(
        rng.normal(size=(b, tcfg.padded_vocab)).astype(np.float32))
    seq_pages = {key: v.clone() for key, v in pages.items()}
    lg, pos, seq_toks = logits, positions, []
    for _ in range(k):
        tok = torch.argmax(lg[:, :tcfg.vocab_size], -1).to(torch.int32)
        seq_toks.append(tok)
        lg, seq_pages = M.decode_step_paged(
            tp, tcfg, seq_pages, {"tokens": tok, "positions": pos,
                                  "block_tables": tables},
            act_dtype=torch.float32)
        pos = pos + 1
    flg, fpages, fpos, ftoks = M.decode_multi_paged(
        tp, tcfg, pages, {"logits": logits, "positions": positions,
                          "block_tables": tables,
                          "active": torch.ones(b, dtype=torch.bool)},
        num_steps=k, act_dtype=torch.float32)
    assert torch.equal(ftoks, torch.stack(seq_toks, 1))
    assert torch.equal(flg, lg)
    assert torch.equal(fpos, pos)
    for key in ("k", "v"):
        assert torch.equal(fpages[key], seq_pages[key])


def test_params_from_numpy_keeps_keys_and_layouts():
    jcfg, tcfg, jp, tp = _setup("smollm")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(leaf.shape)
        assert np.array_equal(node.numpy(), np.asarray(leaf))


def test_init_params_matches_reference_distribution():
    """The port's own random weights: the reference's tree, shapes and
    per-leaf scale (std = 1/sqrt(shape[0]); ones and zeros as in the
    spec)."""
    from repro_torch.params import init_params
    jcfg, tcfg, jp, _ = _setup("chatglm")
    own = init_params(tcfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = own
        for p in path:
            node = node[p.key]
        ref = np.asarray(leaf)
        assert tuple(node.shape) == ref.shape
        if np.all(ref == ref.flat[0]):          # ones / zeros leaves
            assert np.array_equal(node.numpy(), ref)
        else:
            assert node.std().item() == pytest.approx(ref.std(), rel=0.1)
