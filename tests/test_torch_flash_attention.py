"""Dense prefill attention in the PyTorch port against the JAX reference.

On the CPU the port's ``ops.flash_attention`` runs its plain PyTorch
version; it is held against the JAX oracle (``flash_attention_ref``) and
the JAX Pallas kernel in interpret mode, on the shapes of the reference's
own kernel test in its three masks (causal, sliding window, full), plus
S = 200, which is a multiple of no power-of-two tile.  Its full mode
also takes Sq != Sk and a key bound ``kv_len`` (the encoder-decoder
family's encoder and cross attention), held against the reference's
``gqa_prefill_attention(..., kv_len=...)`` and the Pallas kernel on K
cut to the bound.  Tolerances are the
reference's: 2e-4 in f32, 5e-2 in bf16.  The hand-written CUDA kernel is
compared with the plain version by the ``cuda``-marked test, which runs
only where a card is present (``chip_smoke.py`` makes the same comparison
at chatglm-6b's shapes).

The gradient: ``flash_attention_bwd_ref`` (the backward kernel's
formulas) against autograd of the plain forward and JAX's gradient of
``gqa_prefill_attention`` on the CPU, in the causal, window and bounded
full modes at GQA groups of 1 and 3, in f32 (2e-4 of scale) and bf16
(autograd of the plain forward on bf16 inputs against JAX's gradient on
the same bf16 inputs, 5e-2 of scale); on the card the forward's
log-sum-exp and the backward kernel against their plain versions in both
dtypes, at G 1, 3, 5 and 6, D 32, 64 and 128, ragged S, smollm-135m's
and whisper-large-v3's calls, with NaN past a key bound and two
launches held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models.attention import gqa_prefill_attention
from repro_torch.kernels.flash_attention import ops, ref

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

SHAPES = [(128, 4, 4, 64), (256, 4, 2, 64), (192, 6, 2, 32),
          (256, 8, 1, 128), (200, 5, 1, 32)]
MODES = {"causal": dict(causal=True, window=None),
         "window": dict(causal=True, window=64),
         "full": dict(causal=False, window=None)}
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-4),
          "bf16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


def _inputs(s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    b = 2
    return (rng.normal(size=(b, s, hq, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s,hq,hkv,d", SHAPES)
def test_flash_plain_matches_jax(s, hq, hkv, d, dtype, mode):
    tdt, jdt, tol = DTYPES[dtype]
    kw = MODES[mode]
    arrays = _inputs(s, hq, hkv, d)
    out = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrays),
                              **kw).float().numpy()
    jargs = [jnp.asarray(a, jdt) for a in arrays]
    want_ref = np.asarray(flash_attention_ref(*jargs, **kw), np.float32)
    want_pallas = np.asarray(flash_attention_kernel(
        *jargs, block_q=64, block_k=64, interpret=True, **kw), np.float32)
    np.testing.assert_allclose(out, want_ref, atol=tol, rtol=0)
    np.testing.assert_allclose(out, want_pallas, atol=tol, rtol=0)


def test_flash_window_wider_than_sequence_is_causal():
    """A window that reaches past position 0 masks nothing more than the
    causal mask does."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(40, 4, 2, 32))
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=True, window=64),
        ops.flash_attention(q, k, v, causal=True), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_flash_kernel_matches_plain_version(dtype):
    """The hand-written kernel against its plain version on the card, on
    the same shapes and masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt, _, tol = DTYPES[dtype]
    for s, hq, hkv, d in SHAPES:
        args = [torch.from_numpy(a).to("cuda", tdt)
                for a in _inputs(s, hq, hkv, d)]
        for kw in MODES.values():
            n0 = ops.flash_attention.launches
            out = ops.flash_attention(*args, **kw)
            assert ops.flash_attention.launches == n0 + 1
            want = ref.flash_attention_ref(*args, **kw)
            torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                       rtol=0)


# (s, hq, hkv, d, window): the tensor-core kernel's edges
TC_CASES = [(200, 3, 1, 128, 37),     # ragged S, G 3, window edge mid-tile
            (77, 5, 1, 32, 20),       # one ragged tile, G 5
            (130, 4, 4, 64, 70),      # G 1, window straddling tiles
            (64, 6, 2, 128, 1),       # one tile, G 3, window 1
            (333, 10, 2, 64, 100)]    # G 5 over several ragged tiles


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("s,hq,hkv,d,window", TC_CASES)
def test_cuda_flash_tensor_core_edges(s, hq, hkv, d, window, mode):
    """The bf16 tensor-core kernel against its plain version where tiles
    are ragged (S not a multiple of 64), where the window's edge falls
    inside a tile, with G in {1, 3, 5} packed rows and D in {32, 64,
    128}, in the causal, windowed and full masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kw = dict(MODES[mode])
    if mode == "window":
        kw["window"] = window
    args = [torch.from_numpy(a).to("cuda", torch.bfloat16)
            for a in _inputs(s, hq, hkv, d, seed=7)]
    n0 = ops.flash_attention.launches
    out = ops.flash_attention(*args, **kw)
    assert ops.flash_attention.launches == n0 + 1
    want = ref.flash_attention_ref(*args, **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), atol=5e-2, rtol=0)


# hymba-1.5b's heads (25 query heads over 5 KV heads of 64, G = 5) with
# S past the window: (B, S, window); the last is the model's own 2,048
# window at a 4,096-token prompt, where whole K/V tiles left of the
# window are skipped
HYMBA_WINDOWS = [(2, 640, 256), (1, 4096, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,window", HYMBA_WINDOWS)
def test_cuda_flash_window_at_hymba_heads(b, s, window, dtype):
    """The kernel in window mode at Hq 25 / Hkv 5, D 64, S > window,
    against its plain version: 2e-4 in f32 (TF32 off), 5e-2 in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt, _, tol = DTYPES[dtype]
    rng = np.random.default_rng(11)
    args = [torch.from_numpy(rng.normal(size=(b, s, h, 64)).astype(
        np.float32)).to("cuda", tdt) for h in (25, 5, 5)]
    n0 = ops.flash_attention.launches
    out = ops.flash_attention(*args, causal=True, window=window)
    assert ops.flash_attention.launches == n0 + 1
    want = ref.flash_attention_ref(*args, causal=True, window=window)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)


# internvl2-26b's prefill: 48 query heads over 8 KV heads of 128 (G 6),
# S = 256 patches + the prompt bucket (bl 32 and 256), and S 200, off
# every tile
INTERNVL2_PREFILLS = [(4, 288), (2, 512), (1, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s", INTERNVL2_PREFILLS)
def test_cuda_flash_at_internvl2_heads(b, s, dtype):
    """The causal kernel at Hq 48 / Hkv 8, D 128 (internvl2-26b's widths,
    its prefill behind a 256-patch prefix) against its plain version:
    2e-4 in f32 (TF32 off), 5e-2 in bf16, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt, _, tol = DTYPES[dtype]
    rng = np.random.default_rng(13)
    args = [torch.from_numpy(rng.normal(size=(b, s, h, 128)).astype(
        np.float32)).to("cuda", tdt) for h in (48, 8, 8)]
    n0 = ops.flash_attention.launches
    out = ops.flash_attention(*args, causal=True)
    assert ops.flash_attention.launches == n0 + 1
    want = ref.flash_attention_ref(*args, causal=True)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)


def test_flash_kernel_refuses_other_bf16_head_sizes():
    """The tensor-core kernels take D in {32, 64, 128} in both dtypes; the
    forward and backward wrappers raise on any other head size, bf16 or
    f32, before they reach the card."""
    from repro_torch.kernels.flash_attention import kernel
    assert kernel.HEAD_SIZES == (32, 64, 128)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(1, 8, 2, 96, dtype=dtype)
        lse = torch.zeros(1, 8, 2)
        with pytest.raises(ValueError, match="head size 96"):
            kernel.flash_attention_kernel(q, q, q)
        with pytest.raises(ValueError, match="head size 96"):
            kernel.flash_attention_bwd_kernel(q, q, q, q, q, lse)


# full mode with a key bound: (B, Sq, Sk, kv_len, Hq, Hkv, D); bounds off
# every 64-key tile, Sq != Sk (cross attention) and Sq == Sk (the
# encoder over padded frames)
BOUNDED = [(2, 8, 64, 37, 4, 4, 64), (2, 16, 130, 100, 6, 2, 32),
           (1, 64, 96, 64, 4, 1, 128), (2, 40, 130, 130, 4, 4, 64),
           (2, 72, 72, 50, 4, 2, 64)]


def _bounded(b, sq, sk, hq, hkv, d, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,sq,sk,kv_len,hq,hkv,d", BOUNDED)
def test_flash_plain_key_bound_matches_jax(b, sq, sk, kv_len, hq, hkv, d,
                                           dtype):
    """The plain version in full mode with Sq != Sk and ``kv_len``
    against the reference's ``gqa_prefill_attention(causal=False,
    kv_len=...)`` and the Pallas kernel (interpret mode) on K and V cut
    to the bound; NaN in the K/V rows from the bound to Sk changes the
    output by exactly 0."""
    tdt, jdt, tol = DTYPES[dtype]
    arrays = _bounded(b, sq, sk, hq, hkv, d)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    n0 = ops.flash_attention.plain_calls
    out = ops.flash_attention(q, k, v, causal=False, kv_len=kv_len)
    assert ops.flash_attention.plain_calls == n0 + 1
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    want = np.asarray(gqa_prefill_attention(jq, jk, jv, causal=False,
                                            kv_len=kv_len), np.float32)
    want_pallas = np.asarray(flash_attention_kernel(
        jq, jk[:, :kv_len], jv[:, :kv_len], causal=False, block_q=64,
        block_k=64, interpret=True), np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, atol=tol, rtol=0)
    np.testing.assert_allclose(out.float().numpy(), want_pallas, atol=tol,
                               rtol=0)
    kp, vp = k.clone(), v.clone()
    kp[:, kv_len:], vp[:, kv_len:] = float("nan"), float("nan")
    assert torch.equal(ops.flash_attention(q, kp, vp, causal=False,
                                           kv_len=kv_len), out)


def test_flash_refuses_masks_across_lengths():
    """Query i sits at position i, so a causal or window mask with Sq !=
    Sk raises, as does a key bound outside [1, Sk]; each before any
    launch or plain call, on every device."""
    q = torch.zeros(1, 8, 2, 32)
    k = torch.zeros(1, 16, 2, 32)
    n0 = ops.flash_attention.plain_calls
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="Sq == Sk"):
            ops.flash_attention(q, k, k, **kw)
    for bound in (0, 17):
        with pytest.raises(ValueError, match="kv_len"):
            ops.flash_attention(q, k, k, causal=False, kv_len=bound)
    assert ops.flash_attention.plain_calls == n0
    from repro_torch.kernels.flash_attention import kernel
    with pytest.raises(ValueError, match="Sq == Sk"):
        kernel.check_modes(8, 16, True, None, None)
    assert kernel.check_modes(8, 16, False, None, None) == 16


# whisper-large-v3's shapes (20 heads of 64, G 1): the encoder over 1,536
# padded frames with 1,500 real, the cross prefill at prompt buckets 64
# and 256 against them, and small bounds off the tile
WHISPER_BOUNDED = [(2, 1536, 1536, 1500, 20, 20, 64),
                   (4, 64, 1536, 1500, 20, 20, 64),
                   (1, 256, 1536, 1500, 20, 20, 64)] + BOUNDED


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,sq,sk,kv_len,hq,hkv,d", WHISPER_BOUNDED)
def test_cuda_flash_key_bound_matches_plain_version(b, sq, sk, kv_len, hq,
                                                    hkv, d, dtype):
    """The kernel's full mode with Sq != Sk and a key bound against its
    plain version on the card, one launch a call: 2e-4 in f32 (TF32
    off); in bf16, 2e-2 of the output's own largest magnitude (averages
    over many random keys are far below 1, where an absolute 5e-2 would
    hide a key let in past the bound).  The call equals, bit for bit,
    the call on K and V cut to the bound (the same tiles run, so a wrong
    bound mask shows even where the bf16 tensor maps zero-fill past the
    bound), and NaN in the K/V rows from the bound to Sk changes the
    kernel's output by exactly 0 (the f32 kernel stages zeros there and
    the bf16 kernel's tensor maps end at the bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt, _, tol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to("cuda", tdt)
               for a in _bounded(b, sq, sk, hq, hkv, d))
    n0 = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=False, kv_len=kv_len)
    assert ops.flash_attention.launches == n0 + 1
    want = ref.flash_attention_ref(q, k, v, causal=False, kv_len=kv_len)
    assert torch.isfinite(out).all()
    if tdt == torch.bfloat16:
        tol = 2e-2 * want.float().abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    assert torch.equal(ops.flash_attention(
        q, k[:, :kv_len].contiguous(), v[:, :kv_len].contiguous(),
        causal=False), out)
    kp, vp = k.clone(), v.clone()
    kp[:, kv_len:], vp[:, kv_len:] = float("nan"), float("nan")
    assert torch.equal(ops.flash_attention(q, kp, vp, causal=False,
                                           kv_len=kv_len), out)


# ---------------------------------------------------------------------------
# the gradient: the backward kernel's plain version and the kernel
# ---------------------------------------------------------------------------

# (b, sq, sk, hq, hkv, d, mode): causal, a window and full mode with a key
# bound and Sq != Sk, each at GQA groups of 1 and 3
BWD_CASES = {
    "causal-g1": (2, 40, 40, 4, 4, 32, dict(causal=True)),
    "causal-g3": (2, 40, 40, 6, 2, 32, dict(causal=True)),
    "window-g1": (2, 50, 50, 2, 2, 64, dict(causal=True, window=7)),
    "window-g3": (2, 50, 50, 3, 1, 64, dict(causal=True, window=7)),
    "bound-g1": (2, 9, 37, 4, 4, 32, dict(causal=False, kv_len=23)),
    "bound-g3": (2, 9, 37, 6, 2, 32, dict(causal=False, kv_len=23)),
}


def _bwd_inputs(b, sq, sk, hq, hkv, d, seed=7):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
                          (b, sq, hq, d))]


def _hold(got, want, tol=2e-4):
    """Max abs error within ``tol`` of the want's largest magnitude."""
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * scale


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_plain_matches_autograd(case):
    """``flash_attention_bwd_ref`` (the backward kernel's formulas from
    the forward's log-sum-exp) against ``torch.autograd`` of
    ``flash_attention_ref`` and against JAX's gradient of the reference's
    ``gqa_prefill_attention``, dq, dk and dv each at 2e-4 of its largest
    magnitude; dk and dv are summed over the G query heads of each KV
    head.  The log-sum-exp equals ``logsumexp`` of the scaled scores in
    f64.  A key past the bound gets dk = dv = 0 exactly, whatever K and
    V hold there (NaN included).  On the CPU autograd through
    ``ops.flash_attention`` is autograd of the plain forward."""
    b, sq, sk, hq, hkv, d, mode = BWD_CASES[case]
    q, k, v, dout = _bwd_inputs(b, sq, sk, hq, hkv, d)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, **mode)
    want = torch.autograd.grad(out, leaves, dout)
    out2, lse = ref.flash_attention_ref(q, k, v, with_lse=True, **mode)
    assert torch.equal(out2, out.detach()) and lse.shape == (b, sq, hq)
    got = ref.flash_attention_bwd_ref(q, k, v, out2, dout, lse, **mode)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, dout))
    _, vjp = jax.vjp(lambda a, c, e: gqa_prefill_attention(a, c, e, **mode),
                     jq, jk, jv)
    jgrads = [torch.from_numpy(np.array(g)) for g in vjp(jdo)]
    for g, w, jw in zip(got, want, jgrads):
        assert g.shape == w.shape and g.dtype == torch.float32
        _hold(g, w)
        _hold(g, jw)
    q64, k64 = q.double(), k.double()
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q64.reshape(b, sq, hkv, hq // hkv, d) * d ** -0.5, k64)
    qp = torch.arange(sq)[:, None] + (sk - sq)
    kp = torch.arange(sk)[None, :]
    mask = kp < mode.get("kv_len", sk)
    if mode["causal"]:
        mask = mask & (qp >= kp)
    if mode.get("window"):
        mask = mask & (qp - kp < mode["window"])
    s = s.masked_fill(~mask, -float("inf"))
    want_lse = torch.logsumexp(s, -1).permute(0, 3, 1, 2).reshape(b, sq, hq)
    _hold(lse.double(), want_lse)
    kv_len = mode.get("kv_len")
    if kv_len is not None:
        kp_, vp_ = k.clone(), v.clone()
        kp_[:, kv_len:], vp_[:, kv_len:] = float("nan"), float("nan")
        dq, dk, dv = ref.flash_attention_bwd_ref(q, kp_, vp_, out2, dout, lse,
                                                 **mode)
        assert torch.equal(dq, got[0])
        assert torch.equal(dk[:, :kv_len], got[1][:, :kv_len])
        assert not dk[:, kv_len:].any() and not dv[:, kv_len:].any()


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_plain_bf16_matches_jax(case):
    """In bf16: ``torch.autograd`` of the plain forward on bf16 inputs
    (what the CPU's bf16 training step differentiates) against
    ``jax.vjp`` of the reference's ``gqa_prefill_attention`` on the same
    bf16 inputs and cotangent, dq, dk and dv (bf16, as both give them)
    each at the reference's bf16 tolerance, 5e-2 of its largest
    magnitude."""
    b, sq, sk, hq, hkv, d, mode = BWD_CASES[case]
    q, k, v, dout = (t.bfloat16() for t in _bwd_inputs(b, sq, sk, hq, hkv,
                                                      d))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ref.flash_attention_ref(*leaves, **mode)
    got = torch.autograd.grad(out, leaves, dout)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in (q, k, v, dout))
    _, vjp = jax.vjp(lambda a, c, e: gqa_prefill_attention(a, c, e, **mode),
                     jq, jk, jv)
    for g, jw in zip(got, vjp(jdo)):
        assert g.dtype == torch.bfloat16 and jw.dtype == jnp.bfloat16
        _hold(g.float(), torch.from_numpy(np.asarray(jw, np.float32)),
              tol=5e-2)


# smollm-135m's training call, whisper-large-v3's encoder, cross and
# decoder calls (20 heads of 64, 1,500 of 1,536 frames, 448 text rows),
# then the modes above
CUDA_BWD = {"smollm": (8, 256, 256, 9, 3, 64, dict(causal=True)),
            "whisper-encoder": (1, 1536, 1536, 20, 20, 64,
                                dict(causal=False, kv_len=1500)),
            "whisper-cross": (2, 448, 1536, 20, 20, 64,
                              dict(causal=False, kv_len=1500)),
            "whisper-decoder": (2, 448, 448, 20, 20, 64, dict(causal=True)),
            **BWD_CASES}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_BWD))
def test_cuda_flash_bwd_matches_plain_version(case):
    """The f32 forward kernel's log-sum-exp and the backward kernel against
    their plain versions on the card at 2e-4 of each output's largest
    magnitude (TF32 off); the autograd wrapper launches the forward and
    the backward once each and gives the plain version's gradient; NaN
    in K and V past a key bound changes no bit of dq, or of dk and dv
    before the bound, and leaves them zero after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    b, sq, sk, hq, hkv, d, mode = CUDA_BWD[case]
    q, k, v, dout = (t.cuda() for t in _bwd_inputs(b, sq, sk, hq, hkv, d))
    out, lse = kernel.flash_attention_kernel(q, k, v, with_lse=True, **mode)
    want_out, want_lse = ref.flash_attention_ref(q, k, v, with_lse=True,
                                                 **mode)
    _hold(out, want_out)
    _hold(lse, want_lse)
    n0 = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, out, dout, lse, **mode)
    assert ops.flash_attention_bwd.launches == n0 + 1
    want = ref.flash_attention_bwd_ref(q, k, v, want_out, dout, want_lse,
                                       **mode)
    for g, w in zip(got, want):
        _hold(g, w)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    auto = torch.autograd.grad(ops.flash_attention(*leaves, **mode), leaves,
                               dout)
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == (n[0] + 1, n[1] + 1)
    for g, w in zip(auto, want):
        _hold(g, w)
    kv_len = mode.get("kv_len")
    if kv_len is not None:
        kp, vp = k.clone(), v.clone()
        kp[:, kv_len:], vp[:, kv_len:] = float("nan"), float("nan")
        out_p, lse_p = kernel.flash_attention_kernel(q, kp, vp, with_lse=True,
                                                     **mode)
        dq, dk, dv = ops.flash_attention_bwd(q, kp, vp, out_p, dout, lse_p,
                                             **mode)
        assert torch.equal(out_p, out) and torch.equal(dq, got[0])
        assert torch.equal(dk[:, :kv_len], got[1][:, :kv_len])
        assert torch.equal(dv[:, :kv_len], got[2][:, :kv_len])
        assert not dk[:, kv_len:].any() and not dv[:, kv_len:].any()


# (b, s, hq, hkv, d, mode): G 1, 3, 5 and 6, D 32, 64 and 128, S a multiple
# of no tile, in every mode of the training calls (causal, a window, full
# mode with a key bound)
TC_BWD = {
    "g1-d32-causal": (2, 77, 4, 4, 32, dict(causal=True)),
    "g3-d64-window": (2, 133, 9, 3, 64, dict(causal=True, window=40)),
    "g5-d128-causal": (1, 90, 10, 2, 128, dict(causal=True)),
    "g6-d64-bound": (2, 100, 12, 2, 64, dict(causal=False, kv_len=61)),
    "g5-d32-window": (1, 200, 5, 1, 32, dict(causal=True, window=3)),
    "g6-d128-full": (1, 70, 6, 1, 128, dict(causal=False)),
    "g3-d128-bound": (2, 129, 6, 2, 128, dict(causal=False, kv_len=128)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(TC_BWD))
def test_cuda_flash_grad_kernels_in_both_dtypes(case, dtype):
    """The forward (out, lse) and the backward kernel (dq, dk, dv) on the
    tensor cores against their plain versions, in f32 at 2e-4 of each
    output's largest magnitude (TF32 off) and in bf16 at 5e-2; a second
    launch of each gives the same bits; where a key bound is given, NaN
    in K and V past it changes no bit of out, lse, dq and the bounded
    keys' dk and dv, and leaves the rest of dk and dv zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt, _, tol = DTYPES[dtype]
    b, s, hq, hkv, d, mode = TC_BWD[case]
    q, k, v, dout = (t.to("cuda", tdt)
                     for t in _bwd_inputs(b, s, s, hq, hkv, d, seed=29))
    out, lse = kernel.flash_attention_kernel(q, k, v, with_lse=True, **mode)
    want_out, want_lse = ref.flash_attention_ref(q, k, v, with_lse=True,
                                                 **mode)
    _hold(out.float(), want_out.float(), tol)
    _hold(lse, want_lse, tol)
    got = kernel.flash_attention_bwd_kernel(q, k, v, out, dout, lse, **mode)
    want = ref.flash_attention_bwd_ref(q, k, v, want_out, dout, want_lse,
                                       **mode)
    for g, w in zip(got, want):
        assert g.dtype == tdt and torch.isfinite(g).all()
        _hold(g.float(), w.float(), tol)
    out2, lse2 = kernel.flash_attention_kernel(q, k, v, with_lse=True,
                                               **mode)
    again = kernel.flash_attention_bwd_kernel(q, k, v, out, dout, lse,
                                              **mode)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    assert all(torch.equal(x, y) for x, y in zip(again, got))
    kv_len = mode.get("kv_len")
    if kv_len is not None:
        kp, vp = k.clone(), v.clone()
        kp[:, kv_len:], vp[:, kv_len:] = float("nan"), float("nan")
        out_p, lse_p = kernel.flash_attention_kernel(q, kp, vp,
                                                     with_lse=True, **mode)
        dq, dk, dv = kernel.flash_attention_bwd_kernel(q, kp, vp, out_p,
                                                       dout, lse_p, **mode)
        assert torch.equal(out_p, out) and torch.equal(lse_p, lse)
        assert torch.equal(dq, got[0])
        assert torch.equal(dk[:, :kv_len], got[1][:, :kv_len])
        assert torch.equal(dv[:, :kv_len], got[2][:, :kv_len])
        assert not dk[:, kv_len:].any() and not dv[:, kv_len:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("s,hq,hkv,d,window", TC_CASES)
def test_cuda_flash_bf16_lse_store(s, hq, hkv, d, window):
    """The bf16 tensor-core forward's log-sum-exp against the plain one
    (2e-4 of its scale: it is f32 from f32 scores), in the causal,
    window and full modes; the same call without it (a null pointer, the
    serves' launch) gives an output equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import kernel
    args = [torch.from_numpy(a).to("cuda", torch.bfloat16)
            for a in _inputs(s, hq, hkv, d, seed=31)]
    for kw in (dict(causal=True), dict(causal=True, window=window),
               dict(causal=False)):
        out, lse = kernel.flash_attention_kernel(*args, with_lse=True, **kw)
        _, want = ref.flash_attention_ref(*args, with_lse=True, **kw)
        _hold(lse, want)
        assert torch.equal(kernel.flash_attention_kernel(*args, **kw), out)


@pytest.mark.cuda
def test_cuda_flash_bf16_training_call():
    """A bf16 call that needs a gradient launches the forward kernel once
    and the backward kernel once, and its gradient is the plain
    version's at 5e-2 of scale; without a gradient the bf16 kernel
    serves as before, one launch and no backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, dout = (t.cuda().bfloat16()
                     for t in _bwd_inputs(2, 64, 64, 4, 2, 64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    got = torch.autograd.grad(ops.flash_attention(*leaves, causal=True),
                              leaves, dout)
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    want = torch.autograd.grad(ref.flash_attention_ref(*leaves, causal=True),
                               leaves, dout)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _hold(g.float(), w.float(), 5e-2)
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=True)
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == (n0[0] + 2, n0[1] + 1)
