#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit.  Phases, each fatal on failure:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` into one
   library (per-kernel register and shared-memory use printed);
3. kernels: each hand-written kernel against its plain PyTorch version
   on the card, on chatglm-6b's shapes and a GQA shape, in f32 (TF32 off,
   tolerance 2e-4) and bf16 (5e-2): paged decode and prefix prefill with
   and without cached prefixes plus the foreign-page poison cases; dense
   flash prefill in its causal, sliding-window and full masks; dense
   decode with mixed lengths and NaN written past them;
4. model: a reduced chatglm-6b in f32 on the card (kernels) against the
   same model on the CPU (plain versions): the paged model (an admission
   wave with hits, misses and copy-on-write, then decode steps) and the
   dense model (padded prefill, then a fused decode window);
5. paged serve: ``run_paged_engine_backend(..., reduced=False)``:
   chatglm-6b at full width (28 layers, d_model 4096) in bf16,
   ``magnus-paged`` with the prefix cache, on shared-instruction
   traffic.  Kernel launch counts are zeroed just before and read just
   after; every request must finish, the pool must drain, the prefix
   cache must hit and both paged kernels must have launched.  The inputs
   of each decode step's and each admission wave's layer-0 attention
   call are kept.  Then one decode window of a fresh full wave is timed
   and profiled (device busy time, idle share, the kernels that take the
   time);
6. paged timings at the serve's own shapes: each kept decode step and
   wave is replayed through the kernel (held against its plain version),
   the plain version and a PyTorch library yardstick; each gets the
   median card time of its calls from CUDA events, and the least time
   the card could take for it (the bytes it must move at 3.35 TB/s, its
   operations at 989 TFLOP/s).  A kernel's numbers are the means over
   the serve's steps or waves, so they are per launch of the serve;
7. padded serve: ``run_engine_backend(..., reduced=False)``: chatglm-6b
   at full width in bf16, ``magnus``, through the paper's padded
   ``BatchEngine`` on 64 Poisson requests.  Counts are zeroed just
   before and read just after; every request must get its generation
   length, every batch must run G(B) iterations with one readback per
   power-of-two window, the flash kernel must launch once per layer and
   batch, the dense decode kernel once per layer and decode step, and no
   plain version may run.  The layer-0 attention inputs of every batch's
   prefill and of a sample of decode steps are kept; one decode window
   is profiled;
8. padded timings: as phase 6, for the flash and dense decode kernels at
   the kept inputs (yardsticks: SDPA with ``is_causal`` for prefill, SDPA
   with a length mask on the cache cut to its longest row for decode).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result line, when CUDA is missing or the port's sources are not beside
this script.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak

# serve-phase geometry (bf16 pool of 2048 blocks x 16 tokens x 458,752 B)
SERVE = dict(num_blocks=2048, block_tokens=16, max_concurrency=32,
             max_len=512, max_gen=128)
N_REQUESTS = 48
GEN_LENGTH = 64
SPIN_CYCLES = 20_000_000       # ~10 ms spin queued ahead of each timed call
DECODE_REPS = 5                # timed calls per served decode step
PREFILL_REPS = 11              # timed calls per served admission wave

# padded-serve traffic: the first 64 of a Poisson stream (8 req/s over
# 60 s, prompts of 32-256 tokens, generation targets up to 64)
DENSE_N_REQUESTS = 64
DENSE_MAX_LEN, DENSE_MAX_GEN = 256, 64
DECODE_SAMPLE = 21             # keep every 21st decode step of a batch
KEEP_BYTES = 4 << 30           # cap on the kept layer-0 inputs


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def paged_inputs(torch, *, b, hq, hkv, d, bt, nb, mb, lengths, dtype, gen):
    """Random q and pools; row i's table holds distinct random pages
    (block 0 stays out of every table)."""
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(nb, bt, hkv, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bt, hkv, d, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * mb].reshape(b, mb).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lens


def prefill_inputs(torch, *, b, s, hq, hkv, d, bt, nb, mb, plens, slens,
                   dtype, gen):
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    ks = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
    vs = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(nb, bt, hkv, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bt, hkv, d, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * mb].reshape(b, mb).to(torch.int32)
    pl = torch.tensor(plens, dtype=torch.int32, device="cuda")
    sl = torch.tensor(slens, dtype=torch.int32, device="cuda")
    return q, ks, vs, kp, vp, tables, pl, sl


def cycle(vals, n):
    return [vals[i % len(vals)] for i in range(n)]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(torch, ops, ref):
    """Each kernel against its plain version on random unit-size inputs
    at chatglm-6b's and a GQA shape, f32 and bf16, then the poison
    cases."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    decode_shapes = [   # (name, b, hq, hkv, d, bt, nb, mb, lengths)
        ("chatglm-6b", 32, 32, 32, 128, 16, 2048, 40,
         cycle([1, 15, 16, 17, 56, 100, 127, 250, 640], 32)),
        ("gqa smollm-135m", 8, 9, 3, 64, 16, 256, 16,
         [1, 16, 33, 64, 200, 256, 77, 5])]
    prefill_shapes = [  # (name, b, s, hq, hkv, d, bt, nb, mb, plens, slens)
        ("chatglm-6b mixed", 32, 64, 32, 32, 128, 16, 2048, 40,
         cycle([0, 32, 48, 47, 0, 600], 32), cycle([56, 24, 8, 9, 64, 1], 32)),
        ("chatglm-6b misses", 32, 64, 32, 32, 128, 16, 2048, 1,
         [0] * 32, cycle([56, 13, 64, 1], 32)),
        ("gqa smollm-135m", 4, 24, 9, 3, 64, 16, 128, 8,
         [0, 17, 64, 128], [24, 5, 1, 20])]
    for dtype in (torch.float32, torch.bfloat16):
        torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
        torch.backends.cudnn.allow_tf32 = False         # in the plain path
        for name, b, hq, hkv, d, bt, nb, mb, lengths in decode_shapes:
            args = paged_inputs(torch, b=b, hq=hq, hkv=hkv, d=d, bt=bt,
                                nb=nb, mb=mb, lengths=lengths, dtype=dtype,
                                gen=gen)
            out = ops.paged_decode_attention(*args)
            want = ref.paged_decode_attention_ref(*args)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            check(torch.isfinite(out).all().item(), f"decode {name}: NaN")
            log(f"kernel paged_decode_attention {name} {dtype}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]})")
            check(err <= tol[dtype], f"decode {name} {dtype}: err {err}")
        for name, b, s, hq, hkv, d, bt, nb, mb, plens, slens \
                in prefill_shapes:
            args = prefill_inputs(torch, b=b, s=s, hq=hq, hkv=hkv, d=d,
                                  bt=bt, nb=nb, mb=mb, plens=plens,
                                  slens=slens, dtype=dtype, gen=gen)
            out = ops.paged_prefix_prefill_attention(*args)
            want = ref.paged_prefix_prefill_attention_ref(*args)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            check(torch.isfinite(out).all().item(), f"prefill {name}: NaN")
            log(f"kernel paged_prefix_prefill_attention {name} {dtype}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]})")
            check(err <= tol[dtype], f"prefill {name} {dtype}: err {err}")
    poison_checks(torch, ops, gen)


def poison_checks(torch, ops, gen):
    """Poisoning pages outside a row's table, its own slots past its
    length, and (prefill) suffix keys past suffix_len must not change
    the row's output."""
    f = dict(device="cuda", generator=gen)
    # decode: bt 16, Hq 4, Hkv 2, D 32, lengths (23, 40)
    q = torch.randn(2, 4, 32, **f)
    kp = torch.randn(6, 16, 2, 32, **f)
    vp = torch.randn(6, 16, 2, 32, **f)
    tables = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32,
                          device="cuda")
    lens = torch.tensor([23, 40], dtype=torch.int32, device="cuda")
    out1 = ops.paged_decode_attention(q, kp, vp, tables, lens)
    kp2, vp2 = kp.clone(), vp.clone()
    for t in (kp2, vp2):
        t[0] = 1e4
        t[2, 7:] = float("nan")
        t[3:] = -1e4
    out2 = ops.paged_decode_attention(q, kp2, vp2, tables, lens)
    err = (out1[0] - out2[0]).abs().max().item()
    log(f"kernel paged_decode_attention poison: max_abs_change {err:.3e}")
    check(err <= 1e-5, f"decode poison changed the output by {err}")
    # prefill: bt 8, Hq 4, Hkv 2, D 32, S 8, plens (12, 20), slens (8, 5)
    q = torch.randn(2, 8, 4, 32, **f)
    ks = torch.randn(2, 8, 2, 32, **f)
    vs = torch.randn(2, 8, 2, 32, **f)
    kp = torch.randn(7, 8, 2, 32, **f)
    vp = torch.randn(7, 8, 2, 32, **f)
    tables = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32,
                          device="cuda")
    pl = torch.tensor([12, 20], dtype=torch.int32, device="cuda")
    sl = torch.tensor([8, 5], dtype=torch.int32, device="cuda")
    out1 = ops.paged_prefix_prefill_attention(q, ks, vs, kp, vp, tables, pl,
                                              sl)
    kp2, vp2, ks2, vs2 = kp.clone(), vp.clone(), ks.clone(), vs.clone()
    for t in (kp2, vp2):
        t[0] = 1e4                     # the pad entry of row 0's table
        t[2, 4:] = float("nan")        # row 0's own slots past plen 12
        t[3] = 1e4                     # row 1's page
    for t in (ks2, vs2):
        t[1, 5:] = float("nan")        # row 1's suffix keys past slen 5
    out2 = ops.paged_prefix_prefill_attention(q, ks, vs, kp2, vp2, tables,
                                              pl, sl)
    out3 = ops.paged_prefix_prefill_attention(q, ks2, vs2, kp, vp, tables,
                                              pl, sl)
    err = max((out1[0] - out2[0]).abs().max().item(),
              (out1[1] - out3[1]).abs().max().item())
    log(f"kernel paged_prefix_prefill_attention poison: max_abs_change "
        f"{err:.3e}")
    check(err <= 1e-5, f"prefill poison changed the output by {err}")


def dense_kernel_checks(torch, fops, fref, dops, dref):
    """The flash prefill and dense decode kernels against their plain
    versions on random unit-size inputs at chatglm-6b's heads (32/32, D
    128) and a GQA shape (40/8, D 128), f32 and bf16; decode then again
    with NaN written past every row's length, which must change
    nothing."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    modes = {"causal": dict(causal=True, window=None),
             "window": dict(causal=True, window=64),
             "full": dict(causal=False, window=None)}
    flash_shapes = [("chatglm-6b", 4, 256, 32, 32, 128),   # b, s, hq, hkv, d
                    ("gqa 40/8", 4, 200, 40, 8, 128)]
    decode_shapes = [("chatglm-6b", 16, 512, 32, 32, 128,  # b, s, hq, hkv, d
                      cycle([1, 17, 31, 32, 33, 200, 511, 512], 16)),
                     ("gqa 40/8", 8, 512, 40, 8, 128,
                      [512, 13, 256, 1, 77, 300, 500, 64])]
    rnd = lambda *shape, dt: torch.randn(*shape, generator=gen,
                                         device="cuda").to(dt)
    for dtype in (torch.float32, torch.bfloat16):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for name, b, s, hq, hkv, d in flash_shapes:
            q, k, v = (rnd(b, s, h, d, dt=dtype) for h in (hq, hkv, hkv))
            for mode, kw in modes.items():
                out = fops.flash_attention(q, k, v, **kw)
                want = fref.flash_attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs().max().item()
                check(torch.isfinite(out).all().item(),
                      f"flash {name} {mode}: NaN")
                log(f"kernel flash_attention {name} S={s} {mode} {dtype}: "
                    f"max_abs_err {err:.3e} (tol {tol[dtype]})")
                check(err <= tol[dtype], f"flash {name} {mode} {dtype}: "
                      f"err {err}")
        for name, b, s, hq, hkv, d, lengths in decode_shapes:
            q = rnd(b, hq, d, dt=dtype)
            kc, vc = rnd(b, s, hkv, d, dt=dtype), rnd(b, s, hkv, d, dt=dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            out = dops.decode_attention(q, kc, vc, lens)
            want = dref.decode_attention_ref(q, kc, vc, lens)
            for i, n in enumerate(lengths):
                kc[i, n:], vc[i, n:] = float("nan"), float("nan")
            poisoned = dops.decode_attention(q, kc, vc, lens)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            change = (poisoned.float() - out.float()).abs().max().item()
            log(f"kernel decode_attention {name} S={s} {dtype}: max_abs_err "
                f"{err:.3e} (tol {tol[dtype]}); NaN past the lengths "
                f"changes it by {change:.3e}")
            check(err <= tol[dtype], f"decode {name} {dtype}: err {err}")
            check(change == 0.0, f"decode {name}: NaN past the lengths "
                  f"changed the output by {change}")


# ---------------------------------------------------------------------------
# phase 4: the paged model on the card against the plain path on the CPU
# ---------------------------------------------------------------------------

def model_check(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("chatglm-6b").reduced()
    params_cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    params_gpu = _to(torch, params_cpu, "cuda")
    rng = np.random.default_rng(0)
    nb, bt, null = 64, 8, 63
    b, s, mb, steps = 4, 16, 8, 4
    tables = rng.permutation(np.arange(1, null))[:b * mb].reshape(b, mb)
    # rows 0-1 miss; rows 2-3 hit a cached prefix (random pages), and
    # row 3's partial tail block is a copy-on-write clone
    plens = np.array([0, 0, 16, 12])
    lens = np.array([16, 9, 7, 11])
    tokens = rng.integers(3, cfg.vocab_size, size=(b, s))
    dec_tokens = rng.integers(3, cfg.vocab_size, size=(steps, b))
    pool = torch.randn((2, cfg.num_layers, nb, bt, cfg.num_kv_heads,
                        cfg.head_dim), generator=torch.Generator()
                       .manual_seed(1))
    results = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                      device=dev)
        pages = {"k": pool[0].to(dev, copy=True),
                 "v": pool[1].to(dev, copy=True)}
        state = {"tables": t(np.full((b, mb), null)),
                 "positions": t(np.zeros(b)),
                 "active": torch.zeros(b, dtype=torch.bool, device=dev),
                 "logits": torch.zeros(b, cfg.padded_vocab, device=dev)}
        batch = {"tokens": t(tokens), "lengths": t(lens),
                 "prefix_lens": t(plens), "attn_tables": t(tables),
                 "tables": t(tables), "write_lens": t(lens),
                 "cow_src": t([null, null, null, tables[0, 0]]),
                 "cow_dst": t([null, null, null, tables[3, 1]]),
                 "slots": t(np.arange(b)), "row_sel": t(np.arange(b)),
                 "positions": t(plens + lens)}
        pages, state = M.prefill_wave(params, cfg, pages, state, batch,
                                      null_block=null,
                                      act_dtype=torch.float32)
        out = [state["logits"].clone()]
        pos = state["positions"].clone()
        for i in range(steps):
            lg, pages = M.decode_step_paged(
                params, cfg, pages, {"tokens": t(dec_tokens[i]),
                                     "positions": pos,
                                     "block_tables": state["tables"]},
                act_dtype=torch.float32)
            out.append(lg)
            pos = pos + 1
        results[dev] = [x.cpu() for x in out] + [
            pages["k"][:, :null].cpu(), pages["v"][:, :null].cpu()]
    errs = [((a - c).abs().max() / (1 + c.abs().max())).item()
            for a, c in zip(results["cuda"], results["cpu"])]
    log(f"model chatglm-6b reduced f32 card vs cpu: max rel err "
        f"{max(errs):.3e} (tol 2e-4) over wave logits, {steps} decode "
        f"steps and pages")
    check(max(errs) <= 2e-4, f"model card vs cpu: {errs}")


def dense_model_check(torch, np):
    """The dense model of the padded path, reduced chatglm-6b in f32:
    prefill of right-padded prompts, then a fused decode window, on the
    card against the CPU (logits, emitted tokens and caches)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("chatglm-6b").reduced()
    params_cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(2)
    b, s, steps = 3, 32, 6
    tokens = rng.integers(3, cfg.vocab_size, size=(b, s))
    lengths = np.array([32, 17, 5])
    results = {}
    for dev in ("cpu", "cuda"):
        params = params_cpu if dev == "cpu" else _to(torch, params_cpu, dev)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                      device=dev)
        logits, cache = M.prefill(params, cfg, {"tokens": t(tokens),
                                                "lengths": t(lengths)},
                                  act_dtype=torch.float32, cache_len=64)
        out = [logits.clone()]
        logits, cache, _, toks = M.decode_multi(
            params, cfg, cache, {"logits": logits, "positions": t(lengths)},
            num_steps=steps, act_dtype=torch.float32)
        results[dev] = (out + [logits, *cache["kv"]], toks.cpu())
    errs = [((a.cpu() - c).abs().max() / (1 + c.abs().max())).item()
            for a, c in zip(results["cuda"][0], results["cpu"][0])]
    log(f"model chatglm-6b reduced f32 dense card vs cpu: max rel err "
        f"{max(errs):.3e} (tol 2e-4) over prefill logits, the logits after "
        f"{steps} fused decode steps and the caches; tokens equal: "
        f"{torch.equal(results['cuda'][1], results['cpu'][1])}")
    check(torch.equal(results["cuda"][1], results["cpu"][1]),
          "dense decode tokens differ between card and cpu")
    check(max(errs) <= 2e-4, f"dense model card vs cpu: {errs}")


def _to(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase 5: what the serve gave the kernels
# ---------------------------------------------------------------------------

class ServeCalls:
    """Inside the ``with`` block, keeps the inputs of the model's layer-0
    attention calls: one per decode step and one per admission wave, the
    shapes and tables the kernels met in the serve.  The model's two
    attention entry points are wrapped for the block's duration; every
    call passes straight through to its ``ops`` wrapper, which counts its
    launch as always."""

    def __init__(self, transformer):
        self.T = transformer
        self.decode = []     # (q, block_tables, lengths)
        self.prefill = []    # (q, k_suf, v_suf, tables, prefix_lens,
        #                       suffix_lens)

    def __enter__(self):
        T = self.T
        self.orig = dec, pre = (T.paged_decode_attention,
                                T.paged_prefix_prefill_attention)

        def layer0(pages):   # layer i's pool is pages[i], a view at offset i
            return pages.data_ptr() == pages.untyped_storage().data_ptr()

        def decode(q, kp, vp, tables, lengths):
            if layer0(kp):
                self.decode.append((q, tables.clone(), lengths.clone()))
            return dec(q, kp, vp, tables, lengths)

        def prefill(q, ks, vs, kp, vp, tables, plens, slens):
            if layer0(kp):
                self.prefill.append((q, ks, vs, tables.clone(), plens.clone(),
                                     slens.clone()))
            return pre(q, ks, vs, kp, vp, tables, plens, slens)

        T.paged_decode_attention = decode
        T.paged_prefix_prefill_attention = prefill
        return self

    def __exit__(self, *exc):
        (self.T.paged_decode_attention,
         self.T.paged_prefix_prefill_attention) = self.orig


def _device_us(prof):
    """Device time of every kernel, copy and fill in a profile (us)."""
    return sum(getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0)
               for e in prof.key_averages())


def profile_window(torch, engine, reqs):
    """Where a decode step's time goes on the card: admit one full wave
    into the served engine, run one decode window unprofiled (wall time)
    and one under the profiler (device busy time and the kernels that
    take it), then drain."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import drive_paged
    check(engine.join_many(reqs) == len(reqs), "profile wave refused")
    engine.step_window(max_steps=4)            # first window after a wave
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, k = engine.step_window(max_steps=8)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / k
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, k2 = engine.step_window(max_steps=8)
        torch.cuda.synchronize()
    busy = _device_us(prof) / 1e3 / k2
    check(busy > 0, "the profiler recorded no device time")
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0))
    top = sorted(prof.key_averages(), key=dev, reverse=True)[:6]
    log(f"decode window at {engine.num_active} rows: {wall:.2f} ms per "
        f"step on the host clock, device busy {busy:.2f} ms per step "
        f"(idle share {max(0.0, 1 - busy / wall):.2f}); top device time "
        f"per step: " + "; ".join(
            f"{e.key[:60]} {dev(e) / 1e3 / k2:.3f} ms" for e in top))
    st = drive_paged(engine, [])
    check(not engine.num_active and not st["unserved"],
          "profile wave did not drain")
    engine.assert_drained()


# ---------------------------------------------------------------------------
# phase 6: timings at the serve's shapes
# ---------------------------------------------------------------------------

def spin_ms(torch):
    """The card's time for one spin of SPIN_CYCLES (median of 5)."""
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(SPIN_CYCLES)
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


def median_ms(torch, fn, reps, spin):
    """Median card time of one call over ``reps`` calls ``fn(1)``,
    ``fn(2)``, ..., from CUDA events recorded on either side of it.  Each
    call is queued behind a spin kernel of ``spin`` ms, so the card is
    still spinning while the host enqueues the call and the events time
    the card's work, not the Python launch.  A call whose enqueueing
    outlasted the spin is timed again; the phase fails if that keeps
    happening."""
    times, tries = [], 0
    while len(times) < reps:
        tries += 1
        check(tries <= 3 * reps, "the host kept outlasting the spin kernel")
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        a.record()
        fn(1 + len(times))
        z.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        z.synchronize()
        if host_ms < 0.8 * spin:
            times.append(a.elapsed_time(z))
    return statistics.median(times)


def distinct_slots(tables, lens, bt):
    """Distinct (page, slot) positions that the rows' first ``lens``
    tokens occupy: a prefix page that several rows share counts once."""
    ids = set()
    for row, n in zip(tables.tolist(), lens.tolist()):
        ids.update(row[j // bt] * bt + j % bt for j in range(n))
    return len(ids)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hold(torch, name, out, want):
    """Max abs error of the kernel against its plain version, held to
    bf16's 5e-2 at the output's own scale (served K/V are not unit-size:
    random weights leave values of order 10, where one bf16 step is
    0.06)."""
    scale = max(1.0, want.float().abs().max().item())
    err = (out.float() - want.float()).abs().max().item()
    check(torch.isfinite(out).all().item(), f"{name}: NaN at the serve's "
          f"inputs")
    check(err <= 5e-2 * scale, f"{name}: err {err} at scale {scale}")
    return err, scale


def time_decode(torch, ops, ref, calls, K, V, spin):
    """Kernel 1 on each decode step of the serve (its layer-0 queries,
    tables and lengths).  Timed calls take the pools of successive
    layers, as the 28 layers of a step do, so no call finds the last
    one's pages in L2.  The library yardstick is SDPA on the step's pages
    gathered into a dense view up to its longest row."""
    import torch.nn.functional as F
    nl, _, bt, hkv, d = K.shape
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    errs = []
    for q, tables, lens in calls:
        b, hq, _ = q.shape
        check(hq == hkv, "the yardstick assumes the served model's MHA")
        kern = lambda r: ops.paged_decode_attention(
            q, K[r % nl], V[r % nl], tables, lens)
        plain = lambda r: ref.paged_decode_attention_ref(
            q, K[r % nl], V[r % nl], tables, lens)
        errs.append(hold(torch, "paged_decode_attention", kern(0),
                         plain(0)))
        per["ms"].append(median_ms(torch, kern, DECODE_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, DECODE_REPS, spin))
        w = -(-int(lens.max()) // bt)
        dense = lambda P, l: (P[l % nl][tables[:, :w].long()]
                              .reshape(b, w * bt, hkv, d).transpose(1, 2)
                              .contiguous())
        views = [(dense(K, l), dense(V, l)) for l in range(3)]
        mask = (torch.arange(w * bt, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = lambda r: F.scaled_dot_product_attention(
            q4, *views[r % 3], attn_mask=mask)
        lib(0)
        per["library_ms"].append(median_ms(torch, lib, DECODE_REPS, spin))
        del views
        e = q.element_size()
        n_pages = sum(-(-n // bt) for n in lens.tolist())
        nbytes = (2 * q.numel() * e
                  + 2 * distinct_slots(tables, lens, bt) * hkv * d * e
                  + n_pages * 4 + b * 4)
        per["bound"].append(bound(nbytes, 4 * d * hq * int(lens.sum())))
    return per, errs


def time_prefill(torch, ops, ref, calls, K, V, spin):
    """Kernel 2 on each admission wave of the serve (its layer-0 suffix
    q/K/V, attention tables and prefix and suffix lengths), with the
    pools rotating over the layers as in ``time_decode``.  The library
    yardstick is SDPA on the wave's prefix pages gathered and joined to
    its suffix K/V, with the same mask."""
    import torch.nn.functional as F
    nl, _, bt, hkv, d = K.shape
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    errs = []
    for q, ks, vs, tables, pl, sl in calls:
        b, s, hq, _ = q.shape
        kern = lambda r: ops.paged_prefix_prefill_attention(
            q, ks, vs, K[r % nl], V[r % nl], tables, pl, sl)
        plain = lambda r: ref.paged_prefix_prefill_attention_ref(
            q, ks, vs, K[r % nl], V[r % nl], tables, pl, sl)
        errs.append(hold(torch, "paged_prefix_prefill_attention", kern(0),
                         plain(0)))
        per["ms"].append(median_ms(torch, kern, PREFILL_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, PREFILL_REPS, spin))
        pcap = tables.shape[1] * bt
        dense = lambda P, x, l: (torch.cat(
            [P[l % nl][tables.long()].reshape(b, pcap, hkv, d), x], 1)
            .transpose(1, 2).contiguous())
        views = [(dense(K, ks, l), dense(V, vs, l)) for l in range(3)]
        kv_idx = torch.arange(pcap + s, device="cuda")
        q_idx = torch.arange(s, device="cuda")
        mask = torch.where(
            kv_idx[None, None, :] < pcap,
            kv_idx[None, None, :] < pl[:, None, None],
            (kv_idx[None, None, :] - pcap <= q_idx[None, :, None])
            & (kv_idx[None, None, :] - pcap < sl[:, None, None]))[:, None]
        qt = q.transpose(1, 2)
        lib = lambda r: F.scaled_dot_product_attention(
            qt, *views[r % 3], attn_mask=mask)
        lib(0)
        per["library_ms"].append(median_ms(torch, lib, PREFILL_REPS, spin))
        del views
        e = q.element_size()
        plens, slens = pl.tolist(), [min(n, s) for n in sl.tolist()]
        # every query row, pad rows past suffix_lens included, attends
        # its prefix and the suffix keys k <= row, k < suffix_lens
        pairs = sum(s * p + n * (n + 1) // 2 + (s - n) * n
                    for p, n in zip(plens, slens))
        nbytes = (2 * q.numel() * e + 2 * sum(slens) * hkv * d * e
                  + 2 * distinct_slots(tables, pl, bt) * hkv * d * e
                  + sum(-(-p // bt) for p in plens) * 4 + 2 * b * 4)
        per["bound"].append(bound(nbytes, 4 * d * hq * pairs))
    return per, errs


# ---------------------------------------------------------------------------
# phases 7-8: the padded serve and its kernels
# ---------------------------------------------------------------------------

class DenseServeCalls:
    """Inside the ``with`` block, keeps the inputs of the dense model's
    layer-0 attention calls: every prefill (one per batch) and every
    ``DECODE_SAMPLE``-th decode step of each batch, with the step's
    layer-0 cache cloned, up to ``KEEP_BYTES`` in all.  The model's two
    attention entry points are wrapped for the block's duration; every
    call passes straight through to its ``ops`` wrapper, which counts its
    launch as always.  ``decode_steps`` counts the layer-0 decode calls,
    one per decode step."""

    def __init__(self, transformer, num_layers):
        self.T, self.L = transformer, num_layers
        self.prefill = []    # (q, k, v)
        self.decode = []     # (q, k_cache, v_cache, lengths)
        self.decode_steps = 0
        self.kept_bytes = 0
        self._prefill_calls = 0
        self._step_in_batch = 0

    def _keep(self, nbytes):
        if self.kept_bytes + nbytes > KEEP_BYTES:
            return False
        self.kept_bytes += nbytes
        return True

    def __enter__(self):
        T = self.T
        self.orig = pre, dec = (T.gqa_prefill_attention,
                                T.gqa_decode_attention)

        def prefill(q, k, v, *, causal=True, window=None):
            if self._prefill_calls % self.L == 0:     # a batch's layer 0
                check(causal and window is None,
                      "the served model is causal without a window")
                if self._keep(q.nbytes + k.nbytes + v.nbytes):
                    self.prefill.append((q, k, v))
                self._step_in_batch = 0
            self._prefill_calls += 1
            return pre(q, k, v, causal=causal, window=window)

        def decode(q, kc, vc, lengths):
            # layer i's cache is cache[i], a view at offset i
            if kc.data_ptr() == kc.untyped_storage().data_ptr():
                if (self._step_in_batch % DECODE_SAMPLE == 0
                        and self._keep(kc.nbytes + vc.nbytes)):
                    self.decode.append((q[:, 0].clone(), kc.clone(),
                                        vc.clone(), lengths.clone()))
                self._step_in_batch += 1
                self.decode_steps += 1
            return dec(q, kc, vc, lengths)

        T.gqa_prefill_attention = prefill
        T.gqa_decode_attention = decode
        return self

    def __exit__(self, *exc):
        self.T.gqa_prefill_attention, self.T.gqa_decode_attention = self.orig


def profile_dense_window(torch, engine, reqs, bl, cache_len, steps=8):
    """Where a padded decode step's time goes on the card: prefill one
    batch of the serve's shape (its rows and lengths, random prompt ids),
    then time one fused decode window of ``steps`` steps unprofiled
    (wall time) and one under the profiler (device busy time and the
    kernels that take it)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    cfg = engine.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    lengths = torch.tensor([min(r.length, bl) for r in reqs],
                           dtype=torch.int32, device="cuda")
    tokens = torch.randint(3, cfg.vocab_size, (len(reqs), bl), generator=gen,
                           device="cuda", dtype=torch.int32)
    logits, cache = M.prefill(engine.params, cfg, {"tokens": tokens,
                                                   "lengths": lengths},
                              act_dtype=engine.dtype, cache_len=cache_len)
    batch = lambda lg, pos: {"logits": lg, "positions": pos}
    logits, cache, pos, _ = M.decode_multi(
        engine.params, cfg, cache, batch(logits, lengths), num_steps=2,
        act_dtype=engine.dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, pos, _ = M.decode_multi(
        engine.params, cfg, cache, batch(logits, pos), num_steps=steps,
        act_dtype=engine.dtype)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        M.decode_multi(engine.params, cfg, cache, batch(logits, pos),
                       num_steps=steps, act_dtype=engine.dtype)
        torch.cuda.synchronize()
    busy = _device_us(prof) / 1e3 / steps
    check(busy > 0, "the profiler recorded no device time")
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0))
    top = sorted(prof.key_averages(), key=dev, reverse=True)[:6]
    log(f"padded decode window at {len(reqs)} rows, cache {cache_len}: "
        f"{wall:.2f} ms per step on the host clock, device busy "
        f"{busy:.2f} ms per step (idle share {max(0.0, 1 - busy / wall):.2f});"
        f" top device time per step: " + "; ".join(
            f"{e.key[:60]} {dev(e) / 1e3 / steps:.3f} ms" for e in top))


def time_flash(torch, fops, fref, calls, spin):
    """Kernel 3 on each batch's layer-0 prefill of the padded serve.  The
    library yardstick is SDPA with ``is_causal`` on the same q, k, v in
    SDPA's [B, H, S, D] layout."""
    import torch.nn.functional as F
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    errs = []
    for q, k, v in calls:
        b, s, hq, d = q.shape
        hkv = k.shape[2]
        check(hq == hkv, "the yardstick assumes the served model's MHA")
        kern = lambda r: fops.flash_attention(q, k, v, causal=True)
        plain = lambda r: fref.flash_attention_ref(q, k, v, causal=True)
        errs.append(hold(torch, "flash_attention", kern(0), plain(0)))
        per["ms"].append(median_ms(torch, kern, PREFILL_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, PREFILL_REPS, spin))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = lambda r: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True)
        lib(0)
        per["library_ms"].append(median_ms(torch, lib, PREFILL_REPS, spin))
        del qt, kt, vt
        e = q.element_size()
        pairs = b * s * (s + 1) // 2       # every (q, k) pair with k <= q
        nbytes = 2 * q.numel() * e + 2 * k.numel() * e
        per["bound"].append(bound(nbytes, 4 * d * hq * pairs))
    return per, errs


def time_dense_decode(torch, dops, dref, calls, spin):
    """Kernel 4 on each kept decode step of the padded serve (its layer-0
    query, the cache as the step met it, and the lengths).  The library
    yardstick is SDPA with a length mask on the cache cut to its longest
    row."""
    import torch.nn.functional as F
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    errs = []
    for q, kc, vc, lens in calls:
        b, hq, d = q.shape
        _, s, hkv, _ = kc.shape
        check(hq == hkv, "the yardstick assumes the served model's MHA")
        kern = lambda r: dops.decode_attention(q, kc, vc, lens)
        plain = lambda r: dref.decode_attention_ref(q, kc, vc, lens)
        errs.append(hold(torch, "decode_attention", kern(0), plain(0)))
        per["ms"].append(median_ms(torch, kern, DECODE_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, DECODE_REPS, spin))
        w = int(lens.max())
        kt, vt = (x[:, :w].transpose(1, 2).contiguous() for x in (kc, vc))
        mask = (torch.arange(w, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = lambda r: F.scaled_dot_product_attention(q4, kt, vt,
                                                       attn_mask=mask)
        lib(0)
        per["library_ms"].append(median_ms(torch, lib, DECODE_REPS, spin))
        del kt, vt
        e = q.element_size()
        n_keys = int(lens.clamp(max=s).sum())
        nbytes = 2 * q.numel() * e + 2 * n_keys * hkv * d * e + b * 4
        per["bound"].append(bound(nbytes, 4 * d * hq * n_keys))
    return per, errs


def summarize(name, per, errs):
    """Mean over the serve's decode steps (or waves) of each median:
    every step or wave launches the kernel once per layer, so this is
    the mean time of one of the serve's launches."""
    mean = lambda xs: sum(xs) / len(xs)
    bound_by = {by for _, by in per["bound"]}
    row = {"ms": mean(per["ms"]), "plain_ms": mean(per["plain_ms"]),
           "library_ms": mean(per["library_ms"]),
           "bound_ms": mean([t for t, _ in per["bound"]]),
           "bound_by": bound_by.pop() if len(bound_by) == 1 else "bytes",
           "max_abs_err": max(e for e, _ in errs)}
    log(f"time {name} over {len(errs)} served shapes (mean of per-shape "
        f"medians, CUDA events, ms): kernel {row['ms']:.4f} (shapes "
        f"{min(per['ms']):.4f}-{max(per['ms']):.4f}), plain "
        f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']}; by shape "
        f"{sorted({by for _, by in per['bound']})}); max abs err "
        f"{row['max_abs_err']:.3e} at output scale up to "
        f"{max(sc for _, sc in errs):.1f}")
    return row


# ---------------------------------------------------------------------------

def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    t_start = time.perf_counter()
    try:
        # 1. device
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")

        # 2. build
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        lib = build.build()
        build.load_library()
        log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "Compiling entry" in line:
                log("  " + line.strip())

        # 3. kernels against their plain versions
        from repro_torch.kernels.decode_attention import ops, ref
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.flash_attention import ref as fref
        kernel_checks(torch, ops, ref)
        dense_kernel_checks(torch, fops, fref, ops, ref)
        all_kernels = ops.KERNELS + fops.KERNELS

        def reset_counts():
            ops.reset_counts()
            fops.reset_counts()

        def counts(attr):
            return {fn.__name__: getattr(fn, attr) for fn in all_kernels}

        # 4. the paged and dense models on the card against the CPU
        model_check(torch, np)
        dense_model_check(torch, np)

        # 5. serve chatglm-6b at full width through the paged engine
        from repro_torch.launch.serve import (run_engine_backend,
                                              run_paged_engine_backend)
        from repro_torch.models import transformer
        from repro_torch.workload.apps import make_shared_head_dataset
        reqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                        gen_length=GEN_LENGTH, seed=0)
        t0 = time.perf_counter()
        with ServeCalls(transformer) as served:
            reset_counts()
            res = run_paged_engine_backend(
                "chatglm-6b", 0.0, 0.0, "magnus-paged", seed=0,
                reduced=False, device="cuda", dtype=torch.bfloat16,
                prefix_cache=True, requests=reqs, **SERVE)
            launches = counts("launches")
        plain_calls = counts("plain_calls")
        engine = res.pop("engine")
        log(f"serve chatglm-6b full width bf16: "
            f"{time.perf_counter() - t0:.1f} s with set-up; "
            + json.dumps(res))
        log(f"serve kernel launches {launches}, plain calls {plain_calls}")
        cfg = engine.cfg
        check(cfg.num_layers == 28 and cfg.d_model == 4096,
              "serve did not run chatglm-6b at full width")
        check(res["requests"] == N_REQUESTS,
              f"{res['requests']} of {N_REQUESTS} requests finished")
        engine.assert_drained()
        check(res["prefix_hits"] > 0, "the prefix cache never hit")
        check(all(launches[fn.__name__] > 0 for fn in
                  (ops.paged_decode_attention,
                   ops.paged_prefix_prefill_attention)),
              f"a paged kernel never launched: {launches}")
        check(not any(plain_calls.values()),
              f"plain versions ran on the main path: {plain_calls}")
        for r in reqs:
            toks = engine.generated[r.req_id]
            check(len(toks) == min(r.gen_length, SERVE["max_gen"]),
                  f"request {r.req_id}: {len(toks)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in toks),
                  f"request {r.req_id}: token out of range")
        check(torch.isfinite(engine.logits.float()).all().item(),
              "non-finite logits after serving")
        check(len(served.decode) * cfg.num_layers
              == launches["paged_decode_attention"]
              and len(served.prefill) * cfg.num_layers
              == launches["paged_prefix_prefill_attention"],
              f"recorded {len(served.decode)} decode steps and "
              f"{len(served.prefill)} waves against launches {launches}")
        log("serve waves (rows, bucket, table width, prefix_lens, "
            "suffix_lens): " + "; ".join(
                f"{tuple(q.shape[:2])} {t.shape[1]} {pl.tolist()} "
                f"{sl.tolist()}" for q, _, _, t, pl, sl in served.prefill))
        profile_window(torch, engine, make_shared_head_dataset(
            SERVE["max_concurrency"], n_apps=3, gen_length=GEN_LENGTH,
            seed=1))
        pages = engine.pages
        del engine, res
        torch.cuda.empty_cache()

        # 6. paged timings at the serve's shapes
        spin = spin_ms(torch)
        log(f"spin kernel: {spin:.2f} ms")
        t = {"paged_decode_attention": summarize(
                 "paged_decode_attention", *time_decode(
                     torch, ops, ref, served.decode, pages["k"],
                     pages["v"], spin)),
             "paged_prefix_prefill_attention": summarize(
                 "paged_prefix_prefill_attention", *time_prefill(
                     torch, ops, ref, served.prefill, pages["k"],
                     pages["v"], spin))}
        paged_launches = launches
        del pages, served
        torch.cuda.empty_cache()

        # 7. serve chatglm-6b at full width through the padded BatchEngine
        from repro_torch.workload.generator import poisson_workload
        dreqs = poisson_workload(8, 60, seed=0, max_len=DENSE_MAX_LEN,
                                 max_gen=DENSE_MAX_GEN)[:DENSE_N_REQUESTS]
        targets = {r.req_id: min(r.gen_length, DENSE_MAX_GEN) for r in dreqs}
        hbm = torch.cuda.get_device_properties(0).total_memory
        t0 = time.perf_counter()
        with DenseServeCalls(transformer, 28) as dserved:
            reset_counts()
            dres = run_engine_backend(
                "chatglm-6b", 0.0, 0.0, "magnus", seed=0, reduced=False,
                device="cuda", dtype=torch.bfloat16, hbm_bytes=hbm,
                max_len=DENSE_MAX_LEN, max_gen=DENSE_MAX_GEN,
                requests=dreqs)
            dlaunches = counts("launches")
        dplain = counts("plain_calls")
        dengine, results = dres.pop("engine"), dres.pop("results")
        log(f"padded serve chatglm-6b full width bf16 magnus: "
            f"{time.perf_counter() - t0:.1f} s with set-up; "
            + json.dumps(dres))
        log(f"padded serve batches (size, batch length, G(B), host "
            f"syncs): " + "; ".join(
                f"({r.batch_size}, {r.batch_length}, {r.iterations}, "
                f"{bin(r.iterations).count('1')})" for r in results))
        log(f"padded serve kernel launches {dlaunches}, plain calls "
            f"{dplain}")
        dcfg = dengine.cfg
        check(dcfg.num_layers == 28 and dcfg.d_model == 4096,
              "padded serve did not run chatglm-6b at full width")
        check(dres["requests"] == DENSE_N_REQUESTS,
              f"{dres['requests']} of {DENSE_N_REQUESTS} requests served")
        served_ids = [rid for r in results for rid in r.generated]
        check(sorted(served_ids) == sorted(targets),
              "the batches did not serve each request once")
        for r in results:
            check(r.iterations == max(targets[i] for i in r.generated),
                  f"a batch ran {r.iterations} iterations, not its G(B)")
            for rid, toks in r.generated.items():
                check(len(toks) == targets[rid],
                      f"request {rid}: {len(toks)} of {targets[rid]} tokens")
                check(all(0 <= x < dcfg.vocab_size for x in toks),
                      f"request {rid}: token out of range")
        steps = sum(r.iterations for r in results)
        check(dres["host_syncs"] == sum(bin(r.iterations).count("1")
                                        for r in results),
              f"host syncs {dres['host_syncs']}: not one per window")
        check(dlaunches["flash_attention"] == 28 * len(results),
              f"flash launches {dlaunches['flash_attention']} != 28 x "
              f"{len(results)} batches")
        check(dlaunches["decode_attention"] == 28 * steps,
              f"decode launches {dlaunches['decode_attention']} != 28 x "
              f"{steps} decode steps")
        check(dserved.decode_steps == steps,
              f"recorded {dserved.decode_steps} decode steps, not {steps}")
        check(not any(dplain.values()),
              f"plain versions ran on the padded path: {dplain}")
        log(f"padded serve kept {len(dserved.prefill)} prefills and "
            f"{len(dserved.decode)} decode steps "
            f"({dserved.kept_bytes / 2 ** 30:.2f} GiB)")
        big = max(results, key=lambda r: r.batch_size)
        profile_dense_window(
            torch, dengine, [r for r in dreqs if r.req_id in big.generated],
            big.batch_length,
            1 << (big.batch_length + big.iterations - 1).bit_length())
        del dengine, dres, results
        torch.cuda.empty_cache()

        # 8. padded timings at the serve's shapes
        t["flash_attention"] = summarize(
            "flash_attention", *time_flash(torch, fops, fref,
                                           dserved.prefill, spin))
        t["decode_attention"] = summarize(
            "decode_attention", *time_dense_decode(torch, ops, ref,
                                                   dserved.decode, spin))
        source = {"paged_decode_attention":
                  ("src/repro_torch/csrc/paged_decode_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:298",
                   paged_launches),
                  "paged_prefix_prefill_attention":
                  ("src/repro_torch/csrc/paged_prefix_prefill_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:225",
                   paged_launches),
                  "flash_attention":
                  ("src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention/kernel.py:76",
                   dlaunches),
                  "decode_attention":
                  ("src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:402",
                   dlaunches)}
        rows = []
        for name, (path, tpu, count) in source.items():
            rows.append({"name": name, "route": "cuda", "source": path,
                         "replaces": tpu, "launches": count[name],
                         **t[name]})
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": rows}))
    except Exception as e:  # every phase is fatal: report and fail
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
