"""The PyTorch port's training slice against the JAX reference, at f32 on
the CPU on ``reduced()`` configs, the reference's weights carried across
by ``params_from_numpy``:

- ``model.loss_fn`` (loss, ``ce`` and the MoE ``aux``) for every arch of
  ``configs/`` at 2e-4 of scale, and every gradient leaf of smollm-135m,
  olmoe-1b-7b, whisper-large-v3, deepseek-v3-671b (its
  multi-token-prediction head on), mamba2-780m and hymba-1.5b, in f64
  at 1e-4 and in f32 at 2e-4 of the largest (the MoE configs and
  whisper as ``test_grads_match_jax`` says); the loss and every
  gradient leaf of mamba2-780m again at S 256, where the scan crosses
  eight chunks;
- three ``make_train_step`` steps of smollm-135m: loss, grad norm, lr
  and the parameters after each (whisper's gradients and the
  free-running steps' grad norm held as their tests say); and three at
  both packages' default activations (bf16), held against the
  reference's own bf16 error;
- the reference's ``test_reduced_train_step`` contract for every arch
  (finite loss, nonzero gradients), its ``loss_fn`` halves of
  ``test_ragged_moe_matches_padded`` and ``test_decode_matches_forward``,
  and ``test_perf_knobs.py``'s ``test_pad_heads_function_preserving`` on
  the port's parameters;
- AdamW: the reference's quadratic test, and ``update`` against JAX's
  on a mixed tree at 1e-6;
- ``train/data.py``'s batches equal to JAX's bit for bit;
- ``train/checkpoint.py``: files cross between the packages both ways;
  a missing key, an extra key, a shape and a dtype raise
  ``CheckpointMismatchError``;
- the reference's ``test_train_loss_descends`` through the port's
  launcher.

On the CPU the flash and scan wrappers run their plain versions under
autograd; the kernels' gradients on the card are held in
``test_torch_flash_attention.py`` and ``test_torch_ssd_scan.py`` and by
``chip_smoke.py`` phases 23 (smollm-135m) and 24 (mamba2-780m and
hymba-1.5b).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.train import checkpoint as JC
from repro.train import data as JD
from repro.train import optimizer as JO
from repro.train import trainer as JT
from repro_torch.configs import ALL_ARCH_IDS, get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.params import params_from_numpy
from repro_torch.train import checkpoint as C
from repro_torch.train import data as D
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as TR

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

TOL = 2e-4            # f32, of the reference's scale
TOL_F64 = 1e-4        # f64, of the reference's scale (test_grads_match_jax)
MOE_REF_ROUND = 8     # f32 MoE gradients: slack in multiples of the
#                       reference's own f32 rounding (test_grads_match_jax)
OPT_TOL = 1e-6        # AdamW's update on one tree
GRAD_ARCHS = ("smollm-135m", "olmoe-1b-7b", "whisper-large-v3",
              "deepseek-v3-671b", "mamba2-780m", "hymba-1.5b")
B, S = 2, 16
S_LONG = 256          # eight chunks of the reduced SSM configs' 32


@functools.lru_cache(maxsize=None)
def _setup(arch, s=S):
    """(JAX config, port config, JAX params, port params, numpy batch of
    ``s`` tokens a row)."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, tp, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _close(got, want, tol=TOL, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, np.abs(want).max()) if scale is None else scale
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _port_grads(cfg, tp, batch, act_dtype=torch.float32):
    p = O.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss, metrics = M.loss_fn(p, cfg, _tbatch(batch), act_dtype=act_dtype)
    leaves = O.tree_leaves(p)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss, metrics, O.tree_map(lambda _: next(grads), p)


# ---------------------------------------------------------------------------
# the loss and its gradient against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_loss_fn_matches_jax(arch):
    """``loss_fn``'s loss, ``ce`` and ``aux`` at 2e-4 of scale: the dense,
    MoE (the aux loss summed over the layers), MLA (with the MTP head's
    CE for deepseek-v3), SSM and hybrid (the plain scan), vlm (the patch
    positions dropped) and enc-dec families, through the flash wrapper's
    plain version once a layer (and once more for the MTP block)."""
    jcfg, cfg, jp, tp, batch = _setup(arch)
    jl, jm = JM.loss_fn(jp, jcfg, _jbatch(batch), act_dtype=jnp.float32)
    flash_ops.reset_counts()
    with torch.no_grad():
        tl, tm = M.loss_fn(tp, cfg, _tbatch(batch), act_dtype=torch.float32)
    attends = cfg.family != "ssm" and not cfg.uses_mla
    calls = (cfg.encoder_layers + 2 * cfg.num_layers
             if cfg.family == "audio" else cfg.num_layers * attends)
    assert flash_ops.flash_attention.plain_calls == calls
    assert tl.dtype == torch.float32 and tl.shape == ()
    _close(tl, jl)
    _close(tm["ce"], jm["ce"])
    _close(tm["aux"], jm["aux"])
    assert (float(tm["aux"]) > 0) == (cfg.moe is not None)


def _jax_grads(jcfg, jp, batch, dtype=jnp.float32):
    return _flat(jax.tree.map(np.asarray, jax.grad(
        lambda p: JM.loss_fn(p, jcfg, _jbatch(batch), act_dtype=dtype)[0])(
            jp)))


def _f64_grads(jcfg, cfg, jp, batch):
    """Both packages' gradients in f64 from the reference's weights: the
    reference's under ``jax.enable_x64``, the port's from f64 tensors.
    The MoE router stays f32 in both, as both packages keep it
    (``KEEP_F32``; the reference's scan carries its aux loss in f32)."""
    b64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
           for k, v in batch.items()}

    def dt(path):
        return np.float32 if "router" in jax.tree_util.keystr(path) \
            else np.float64
    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(np.asarray(a, dt(path))), jp)
        want = _jax_grads(jcfg, jp64, b64, dtype=jnp.float64)
    tp64 = jax.tree_util.tree_map_with_path(
        lambda path, a: torch.from_numpy(np.array(a, dt(path))), jp)
    _, _, grads = _port_grads(cfg, tp64, b64, act_dtype=torch.float64)
    return {k: v.numpy().astype(np.float64)
            for k, v in _flat(grads).items()}, want


@contextlib.contextmanager
def _moe_gates(record=None, replay=None):
    """Patch the port's MoE router (``moe._route``, each MoE layer's
    call in order, a checkpointed layer's recomputation included):
    append to ``record`` the bf16 value of every gate, the value the
    layer combines with, or give each call the gates of ``replay``'s
    run instead of its own rounding.  A replayed gate is the call's own
    f32 gate shifted by a constant (its gradient unchanged) that lands
    its bf16 rounding on the recorded value; each shift is held to at
    most one bf16 step, so only a rounding decision moves."""
    route, calls = MOE._route, []

    def patched(p, xt, m):
        probs, gates, idx = route(p, xt, m)
        rounded = gates.detach().to(torch.bfloat16).to(gates.dtype)
        if record is not None:
            record.append(rounded)
        if replay is None:
            return probs, gates, idx
        want = replay[len(calls)].to(gates.dtype)
        calls.append(None)
        step = torch.maximum(rounded.abs(), want.abs()) * 2.0 ** -7
        assert want.shape == rounded.shape
        assert bool(((want - rounded).abs() <= step).all()), \
            "a replayed gate is more than one bf16 step from its own"
        return probs, gates + (want - rounded), idx
    MOE._route = patched
    try:
        yield
    finally:
        MOE._route = route
    assert replay is None or len(calls) == len(replay)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_grads_match_jax(arch):
    """Every gradient leaf against the reference's, the trees' keys
    equal, held twice: in f64, and in f32.

    - f64: each leaf of the port's f64 gradient within ``TOL_F64`` (1e-4)
      of the largest gradient magnitude of the reference's f64 run (the
      embedding's, the router's, the MTP head's...).  The reference's
      x64 run still normalises, rotates, scores attention and routes in
      f32 (its ``astype(float32)``s), so it is not exact: it lies up to
      2.4e-5 of scale from the port's (olmoe-1b-7b, measured on the
      CPU); a fault in the port moves a leaf by far more.
    - f32: each leaf of the port's f32 gradient within ``TOL`` (2e-4) of
      scale of the reference's f32 leaf.  For the MoE configs
      (olmoe-1b-7b, deepseek-v3-671b) two things change, both because
      both packages round the MoE combine weights to bf16
      (``moe_forward``):
      - the port's f32 run combines with the bf16 gates of its f64 run
        (:func:`_moe_gates`): a gate that f32 rounding moves across a
        bf16 rounding boundary moves its layer's output by a bf16 step
        (deepseek-v3-671b: one such gate puts the port's f32 gradient
        5.4e-3 of scale from its f64 run, 2.7e-5 with the f64 run's
        gates; measured on the CPU);
      - the bound gains ``MOE_REF_ROUND`` (8) times the reference's own
        f32 rounding at that leaf, the distance of its f32 leaf from
        its f64 one: the gradient reaching the router through the bf16
        combine weights is rounded to bf16 in both packages, and the
        embedding's gradient then crosses the first layer's RMS norm
        of embeddings of RMS ~0.04, which amplifies that rounding
        (olmoe-1b-7b's embedding: 4.84e-4 of scale between the f32
        runs, the reference 7.56e-5 from its f64 run; measured on the
        CPU).  The slack comes from the reference's run alone, so a
        fault in the port's f32 arithmetic cannot widen it: rounding
        the attention's output, the experts' output or an RMS norm's
        output to bf16 in the port's f32 run fails this hold.

    whisper-large-v3's are held another way.  Its stacked layers' random
    weights (std 1/sqrt(2) from the reference's init) make its attention
    scores reach hundreds, and the softmax's gradient amplifies f32
    rounding: each package's f32 gradient lies ~1e-2 of scale from the
    reference's f64 run (``jax.enable_x64``), so two f32 runs that sum
    in different orders cannot meet 2e-4 (they differ by ~2e-3).  There
    each leaf of the port's f32 gradient must lie no farther from the
    reference's f32 leaf than that leaf lies from the reference's f64
    run: the packages agree, leaf by leaf, within the reference's own
    f32 accuracy."""
    jcfg, cfg, jp, tp, batch = _setup(arch)
    want = _jax_grads(jcfg, jp, batch)
    scale = max(np.abs(w).max() for w in want.values())
    if cfg.family != "audio":
        gates = []
        with _moe_gates(record=gates):
            got64, want64 = _f64_grads(jcfg, cfg, jp, batch)
        with _moe_gates(replay=gates):
            _, _, tgrads = _port_grads(cfg, tp, batch)
        assert bool(gates) == (cfg.moe is not None)
        got = {k: v.numpy().astype(np.float64)
               for k, v in _flat(tgrads).items()}
        assert sorted(got) == sorted(want) == sorted(got64) \
            == sorted(want64)
        if cfg.mtp_depth:
            assert np.abs(want["/mtp/proj"]).max() > 0
        scale64 = max(np.abs(w).max() for w in want64.values())
        factor = MOE_REF_ROUND if cfg.moe is not None else 0
        for name, w in want.items():
            e64 = np.abs(got64[name] - want64[name]).max()
            assert e64 <= TOL_F64 * scale64, (name, e64 / scale64)
            e = np.abs(got[name] - w).max()
            ref_round = np.abs(w - want64[name]).max()
            assert e <= TOL * scale + factor * ref_round, (
                f"{name}: the f32 runs differ by {e / scale:.3e} of scale, "
                f"past 2e-4 plus {factor} times the reference's own "
                f"distance from f64 ({ref_round / scale:.3e})")
        return
    _, _, tgrads = _port_grads(cfg, tp, batch)
    got = {k: v.numpy().astype(np.float64) for k, v in _flat(tgrads).items()}
    assert sorted(got) == sorted(want)
    err = {k: np.abs(got[k] - w).max() for k, w in want.items()}
    with jax.enable_x64(True):
        jp64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                            jp)
        exact = _jax_grads(jcfg, jp64, {
            k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}, dtype=jnp.float64)
    for name, e in err.items():
        ref_err = np.abs(want[name] - exact[name]).max()
        assert e <= ref_err, (
            f"{name}: the port's f32 gradient is {e / scale:.3e} of scale "
            f"from the reference's f32 one, which is {ref_err / scale:.3e} "
            f"from its f64 run")


def test_ssm_loss_and_grads_match_jax_across_chunks():
    """mamba2-780m at S 256, eight chunks of the reduced config's 32, so
    the scan's gradient crosses chunks (``_setup``'s S 16 is one chunk):
    the loss at 2e-4 of scale and every gradient leaf at 2e-4 of the
    tree's largest gradient magnitude.  (The hybrid's embedding gradient
    at S 256 is ill-conditioned in f32: each package's f32 leaf lies ~1e-3
    of scale from an f64 run, its attention's share the larger, so two
    f32 runs cannot meet 2e-4 there; its scan's gradient across chunks
    at its widths is held in ``test_torch_ssd_scan.py``.)"""
    jcfg, cfg, jp, tp, batch = _setup("mamba2-780m", S_LONG)
    assert cfg.ssm.chunk_size * 8 == S_LONG
    jl, _ = JM.loss_fn(jp, jcfg, _jbatch(batch), act_dtype=jnp.float32)
    want = _jax_grads(jcfg, jp, batch)
    loss, _, tgrads = _port_grads(cfg, tp, batch)
    _close(loss.detach(), jl)
    got = _flat(tgrads)
    assert sorted(got) == sorted(want)
    scale = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        _close(got[name], w, scale=scale)


def test_train_step_matches_jax():
    """Three ``make_train_step`` steps of smollm-135m on the trainer's
    batches (B 2, S 16).  Each step from JAX's state carried across: the
    loss, grad norm and lr at 2e-4 of scale and every parameter after it
    at 2e-4 of its largest magnitude (the moments are held by
    ``test_adamw_update_matches_jax``).  The port's own three steps,
    free-running: the loss and the lr at 2e-4 of scale, every parameter
    at 2e-4 of the tree's largest, the input tree left as it was.  (Its
    grad norm is not held there, nor each leaf at its own scale: AdamW's
    first step moves every parameter by about ``lr`` in its gradient's
    sign, and a few gradient elements of ~1e-6, where the two packages
    round to opposite signs, move by ``lr`` the other way, 7e-4 of the
    embedding's scale; the next gradient's norm then differs by
    ~3e-3.)"""
    jcfg, cfg, jp, tp, _ = _setup("smollm-135m")
    opt, jopt = (O.AdamWConfig(warmup_steps=2, total_steps=3),
                 JO.AdamWConfig(warmup_steps=2, total_steps=3))
    jstep = jax.jit(JT.make_train_step(jcfg, jopt, act_dtype=jnp.float32))
    tstep = TR.make_train_step(cfg, opt, act_dtype=torch.float32)
    js, ts = JO.init(jopt, jp), O.init(opt, tp)
    own, own_state = tp, ts
    it = D.batches(cfg, D.DataConfig(batch_size=B, seq_len=S))
    before = {k: v.clone() for k, v in _flat(tp).items()}
    carry = lambda t: params_from_numpy(jax.tree.map(np.asarray, t),
                                        device="cpu")
    for _ in range(3):
        batch = next(it)
        state = O.AdamWState(torch.tensor(int(js.step), dtype=torch.int32),
                             carry(js.mu), carry(js.nu))
        p1, _, m1 = tstep(carry(jp), state, _tbatch(batch))
        own, own_state, m2 = tstep(own, own_state, _tbatch(batch))
        jp, js, jm = jstep(jp, js, _jbatch(batch))
        m1, m2 = TR.read_metrics(m1), TR.read_metrics(m2)
        for key in ("loss", "grad_norm", "lr"):
            _close(m1[key], jm[key])
        for key in ("loss", "lr"):
            _close(m2[key], jm[key])
        want = _flat(jax.tree.map(np.asarray, jp))
        top = max(np.abs(w).max() for w in want.values())
        for name, w in want.items():
            _close(_flat(p1)[name], w, scale=np.abs(w).max())
            _close(_flat(own)[name], w, scale=top)
    assert int(own_state.step) == 3
    for name, t in _flat(tp).items():
        assert torch.equal(t, before[name]) and not t.requires_grad


BF16_FACTOR = 0.5     # the default step's hold, of the reference's bf16 error


def test_default_train_step_matches_jax_in_bf16():
    """``make_train_step`` with no ``act_dtype`` computes in bf16 in both
    packages (the reference's default; ``train`` keeps f32 in both).
    Three default steps of smollm-135m on the trainer's batches (B 2, S
    16), each from the reference's bf16 run's state carried across: the
    port's loss and grad norm may be no farther from the reference's
    bf16 step than ``BF16_FACTOR`` times the reference's own bf16 step's
    distance from its f32 step on the same state.  A port computing the
    reference's bf16 arithmetic lands far nearer (0.02-0.15 of it here);
    a port stepping in f32 lands at exactly that distance, 1.0."""
    import inspect
    for fn, want in ((TR.make_train_step, torch.bfloat16),
                     (TR.train, torch.float32)):
        assert inspect.signature(fn).parameters["act_dtype"].default == want
    for fn, want in ((JT.make_train_step, jnp.bfloat16),
                     (JT.train, jnp.float32)):
        assert inspect.signature(fn).parameters["act_dtype"].default == want
    jcfg, cfg, jp, _, _ = _setup("smollm-135m")
    opt, jopt = (O.AdamWConfig(warmup_steps=2, total_steps=3),
                 JO.AdamWConfig(warmup_steps=2, total_steps=3))
    j16 = jax.jit(JT.make_train_step(jcfg, jopt))
    j32 = jax.jit(JT.make_train_step(jcfg, jopt, act_dtype=jnp.float32))
    tstep = TR.make_train_step(cfg, opt)
    js = JO.init(jopt, jp)
    it = D.batches(cfg, D.DataConfig(batch_size=B, seq_len=S))
    carry = lambda t: params_from_numpy(jax.tree.map(np.asarray, t),
                                        device="cpu")
    for step in range(3):
        batch = next(it)
        state = O.AdamWState(torch.tensor(int(js.step), dtype=torch.int32),
                             carry(js.mu), carry(js.nu))
        got = TR.read_metrics(tstep(carry(jp), state, _tbatch(batch))[2])
        _, _, m32 = j32(jp, js, _jbatch(batch))
        jp, js, m16 = j16(jp, js, _jbatch(batch))
        for key in ("loss", "grad_norm"):
            ref16, ref32 = float(m16[key]), float(m32[key])
            err, ref_err = abs(got[key] - ref16), abs(ref16 - ref32)
            assert err <= BF16_FACTOR * ref_err, (
                f"step {step} {key}: the port's default step {got[key]} is "
                f"{err:.3e} from the reference's bf16 {ref16}, whose f32 "
                f"step {ref32} is {ref_err:.3e} from it")


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_reduced_train_step(arch):
    """The reference's ``test_arch_smoke.py`` contract on the port's own
    weights, at its default bf16 activations: a scalar finite loss and
    nonzero, finite gradients."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, 32),
                                     generator=gen)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(B, cfg.num_patches, cfg.d_model,
                                       generator=gen).bfloat16()
    if cfg.family == "audio":
        batch["frames"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                      generator=gen).bfloat16()
    p = O.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = M.loss_fn(p, cfg, batch)
    assert loss.shape == () and torch.isfinite(loss)
    grads = torch.autograd.grad(loss, O.tree_leaves(p))
    gn = sum(float(g.float().abs().sum()) for g in grads)
    assert gn > 0 and np.isfinite(gn), arch


def test_ragged_moe_loss_matches_padded():
    """The ``loss_fn`` half of ``test_perf_knobs.py``'s
    ``test_ragged_moe_matches_padded``: the dropless ragged MoE's loss
    equals the capacity dispatch's when nothing drops (capacity factor
    8), within the reference's 2e-3, and both equal JAX's."""
    jcfg, cfg, jp, tp, _ = _setup("olmoe-1b-7b")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 32)).astype(np.int32)
    losses = {}
    for name, change in (("padded", dict(moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))), ("ragged", dict(
                moe_ragged=True))):
        jl, _ = JM.loss_fn(jp, dataclasses.replace(jcfg, **change),
                           {"tokens": jnp.asarray(toks)},
                           act_dtype=jnp.float32)
        with torch.no_grad():
            tl, _ = M.loss_fn(tp, dataclasses.replace(cfg, **change),
                              {"tokens": torch.from_numpy(toks)},
                              act_dtype=torch.float32)
        _close(tl, jl)
        losses[name] = float(tl)
    assert abs(losses["padded"] - losses["ragged"]) < 2e-3


@pytest.mark.parametrize("arch", [a for a in ALL_ARCH_IDS
                                  if a != "whisper-large-v3"])
def test_decode_matches_forward(arch):
    """The ``forward_train`` half of ``test_arch_smoke.py``'s
    ``test_decode_matches_forward`` for the decoder-only families: decode
    at position S after a prefill equals ``forward_train``'s last logits
    over S + 1 tokens within the reference's 2e-3 of scale (whisper's is
    in ``test_torch_encdec.py``)."""
    _, cfg, _, tp, batch = _setup(arch)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32))
    patches = (torch.from_numpy(batch["patches"])
               if cfg.family == "vlm" else None)
    with torch.no_grad():
        full, aux, hidden = T.forward_train(tp, cfg, toks, patches=patches,
                                            act_dtype=torch.float32,
                                            remat=False)
        pre = {"tokens": toks[:, :32], "lengths": torch.tensor([32, 32])}
        if patches is not None:
            pre["patches"] = patches
        offs = cfg.num_patches if cfg.family == "vlm" else 0
        _, cache = M.prefill(tp, cfg, pre, act_dtype=torch.float32,
                             cache_len=36 + offs)
        dec, _ = M.decode_step(tp, cfg, cache, {
            "tokens": toks[:, 32], "positions": torch.tensor([32, 32])},
            act_dtype=torch.float32)
    assert full.shape == (2, 33 + offs, cfg.padded_vocab)
    assert hidden.shape == (2, 33 + offs, cfg.d_model)
    _close(dec, full[:, -1], tol=2e-3)


def test_remat_changes_no_value():
    """``forward_train`` with each block recomputed in the backward pass
    gives the gradients of the run without it, bit for bit."""
    _, cfg, _, tp, batch = _setup("olmoe-1b-7b")
    toks = torch.from_numpy(batch["tokens"])
    grads = []
    for remat in (True, False):
        p = O.tree_map(lambda t: t.detach().requires_grad_(True), tp)
        logits, aux, _ = T.forward_train(p, cfg, toks,
                                         act_dtype=torch.float32,
                                         remat=remat)
        loss = T.cross_entropy(logits[:, :-1], toks[:, 1:]) + aux
        grads.append(torch.autograd.grad(loss, O.tree_leaves(p)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_pad_heads_function_preserving():
    """``test_perf_knobs.py``'s test on the port's parameters: query heads
    padded to ``pad_heads_to`` (one more KV group of zero ``wq``/``wo``
    rows) leave the loss and the logits unchanged."""
    cfg = get_config("qwen2.5-14b").reduced()          # 4 heads, kv 1
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pad_to = hq + hkv
    cfgp = dataclasses.replace(cfg, pad_heads_to=pad_to)
    params = M.init_params(cfg, seed=0, device="cpu")
    paramsp = M.init_params(cfgp, seed=0, device="cpu")
    assert paramsp["blocks"]["attn"]["wq"].shape[2] == pad_to
    g, gp = hq // hkv, pad_to // hkv

    def pack_q(w):   # [L, d, hq, hd] -> [L, d, pad_to, hd]
        w = w.reshape(*w.shape[:2], hkv, g, hd)
        z = w.new_zeros(*w.shape[:3], gp - g, hd)
        return torch.cat([w, z], 3).reshape(*w.shape[:2], pad_to, hd)

    def pack_o(w):   # [L, hq, hd, d] -> [L, pad_to, hd, d]
        w = w.reshape(w.shape[0], hkv, g, hd, w.shape[-1])
        z = w.new_zeros(w.shape[0], hkv, gp - g, hd, w.shape[-1])
        return torch.cat([w, z], 2).reshape(w.shape[0], pad_to, hd,
                                            w.shape[-1])

    attn = dict(params["blocks"]["attn"])
    attn["wq"], attn["wo"] = pack_q(attn["wq"]), pack_o(attn["wo"])
    if "bq" in attn:
        b = attn["bq"]
        attn["bq"] = pack_q(b[:, None])[:, 0]
    pp = dict(params, blocks=dict(params["blocks"], attn=attn))
    assert {k: v.shape for k, v in _flat(pp).items()} == \
        {k: v.shape for k, v in _flat(paramsp).items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, _ = M.loss_fn(params, cfg, {"tokens": toks},
                         act_dtype=torch.float32)
        b, _ = M.loss_fn(pp, cfgp, {"tokens": toks},
                         act_dtype=torch.float32)
        la = T.forward_train(params, cfg, toks, act_dtype=torch.float32)[0]
        lb = T.forward_train(pp, cfgp, toks, act_dtype=torch.float32)[0]
    assert abs(float(a) - float(b)) < 1e-4
    assert float((la - lb).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# the optimizer, the data and the checkpoint
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    cfg = O.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                        weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = O.init(cfg, params)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, m = O.update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 1.0


def test_adamw_update_matches_jax():
    """Twelve ``update`` steps on a mixed tree (matrices, which decay,
    vectors and a 3-D leaf; gradients large enough to clip on some
    steps; the warmup, the cosine and its floor) against JAX's at 1e-6
    of scale: parameters, both moments, grad norm and lr."""
    kw = dict(lr=0.05, warmup_steps=3, total_steps=10, clip_norm=6.0)
    cfg, jcfg = O.AdamWConfig(**kw), JO.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((4, 5)), "b": rng.standard_normal(5),
            "n": {"x": rng.standard_normal((2, 3, 2))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    tp, jp = jax.tree.map(torch.from_numpy, tree), jax.tree.map(jnp.asarray,
                                                               tree)
    ts, js = O.init(cfg, tp), JO.init(jcfg, jp)
    clipped = 0
    for i in range(12):              # norms ~3.4 and ~20 in turn
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * (0.5, 3.0)[i % 2]).astype(np.float32),
                         tree)
        tp, ts, tm = O.update(cfg, jax.tree.map(torch.from_numpy, g), ts, tp)
        jp, js, jm = JO.update(jcfg, jax.tree.map(jnp.asarray, g), js, jp)
        clipped += float(jm["grad_norm"]) > cfg.clip_norm
        for key in ("grad_norm", "lr"):
            _close(tm[key], jm[key], tol=OPT_TOL)
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            want = _flat(jax.tree.map(np.asarray, want))
            for name, t in _flat(got).items():
                _close(t, want[name], tol=OPT_TOL)
    assert clipped == 6
    assert int(ts.step) == 12 and ts.mu["w"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-26b",
                                  "whisper-large-v3"])
def test_batches_match_jax(arch):
    """``batches`` equals the reference's bit for bit, the vlm family's
    patches and the enc-dec family's frames included."""
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    dc = D.DataConfig(batch_size=3, seq_len=32, seed=5)
    jdc = JD.DataConfig(batch_size=3, seq_len=32, seed=5)
    ours, theirs = D.batches(cfg, dc), JD.batches(jcfg, jdc)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_crosses_packages(tmp_path):
    """A parameter tree saved by either package restores in the other
    (f32, and the port's restore of a file with the reference's bf16
    array, which the reference's numpy writes as 2-byte void), with the
    step; the port's bf16 file has the reference's bytes."""
    jcfg, cfg, jp, tp, _ = _setup("olmoe-1b-7b")
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    C.save(ours, {"params": tp}, step=7)
    JC.save(theirs, {"params": jp}, step=9)
    back, step = JC.restore(ours, {"params": jp})
    assert step == 7
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back, step = C.restore(theirs, {"params": tp})
    assert step == 9
    for name, t in _flat(back).items():
        assert torch.equal(t, _flat({"params": tp})[name])
    bf = {"w": tp["embed"].bfloat16()}
    C.save(str(tmp_path / "bf_port"), bf)
    JC.save(str(tmp_path / "bf_jax"), {"w": jnp.asarray(
        np.asarray(tp["embed"])).astype(jnp.bfloat16)})
    for path in ("bf_port.npz", "bf_jax.npz"):
        got, _ = C.restore(str(tmp_path / path), bf)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16),
                           bf["w"].view(torch.int16))
    with np.load(tmp_path / "bf_port.npz") as a, \
            np.load(tmp_path / "bf_jax.npz") as b:
        assert a["['w']"].dtype == b["['w']"].dtype
        assert a["['w']"].tobytes() == b["['w']"].tobytes()


def test_checkpoint_restore_validates_template(tmp_path):
    """The rest of ``tests/test_recovery.py``'s test: a restore into a
    template with a missing key, an extra key, another shape or another
    dtype raises ``CheckpointMismatchError``; the flatten convention is
    the reference's."""
    tree = {"w": torch.ones(2, 3), "b": torch.zeros(3)}
    path = str(tmp_path / "model")
    C.save(path, tree, step=7)
    restored, step = C.restore(path, tree)
    assert step == 7 and torch.equal(restored["w"], tree["w"])
    bad = [{"w": torch.ones(2, 3)},                                # missing
           {**tree, "c": torch.ones(1)},                           # extra
           {"w": torch.ones(3, 2), "b": tree["b"]},                # shape
           {"w": torch.ones(2, 3, dtype=torch.int32), "b": tree["b"]}]
    for like in bad:
        with pytest.raises(C.CheckpointMismatchError):
            C.restore(path, like)
    assert set(C.flatten_tree({"x": np.zeros(1)})) == {"['x']"}


def test_train_loss_descends(capsys):
    """The reference's ``test_workload_train.py`` test through the port's
    launcher on the CPU: smollm-135m reduced, 30 steps at B 4, S 64."""
    out = launch_train.main(["--arch", "smollm-135m", "--steps", "30",
                             "--log-every", "30", "--batch-size", "4",
                             "--seq-len", "64", "--device", "cpu"])
    h = out["history"]
    assert h[-1]["loss"] < 7.0
    assert np.isfinite(h[-1]["grad_norm"])
    assert "done: loss" in capsys.readouterr().out
