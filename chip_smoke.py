#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit.  Phases, each fatal on failure:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` into one
   library (its wall time printed); each kernel's registers, static
   shared memory and spills from the ``-Xptxas -v`` log, and its
   tensor-core instructions (HGMMA, HMMA) from ``cuobjdump -sass`` where
   the toolkit has it; fails if the bf16 flash or bf16 prefix-prefill
   kernel, or either SSD scan kernel (C.B^T and the scan, every
   instance), has none;
3. kernels: each hand-written kernel against its plain PyTorch version
   on the card, on chatglm-6b's shapes, GQA shapes and edge shapes, in
   f32 (TF32 off, tolerance 2e-4) and bf16 (5e-2): paged decode with
   lengths around a page, split-KV (B 1-2, lengths 640+), G > 8 in head
   chunks and D 32/64/128 at bt 8/16/32; prefix prefill with and without
   cached prefixes, prefix lengths off the 64-key tile, two 64-row tiles
   of G = 3 and S > 64; then the poison cases (NaN or large values in pad
   pages, foreign pages, slots past a length and suffix keys past
   suffix_lens), which must change the output by exactly 0, in both
   dtypes; dense flash prefill in its causal, sliding-window and full
   masks; dense decode with mixed lengths and NaN written past them;
4. model: a reduced chatglm-6b in f32 on the card (kernels) against the
   same model on the CPU (plain versions): the paged model (an admission
   wave with hits, misses and copy-on-write, then decode steps) and the
   dense model (padded prefill, then a fused decode window);
5. paged serve: ``run_paged_engine_backend(..., reduced=False)``:
   chatglm-6b at full width (28 layers, d_model 4096) in bf16,
   ``magnus-paged`` with the prefix cache, on shared-instruction
   traffic.  Kernel launch counts are zeroed just before and read just
   after; every request must finish, the pool must drain, the prefix
   cache must hit and both paged kernels must have launched, the decode
   kernel once per layer and step and prefix prefill once per layer and
   wave, with one readback per decode window.  The engine captures its
   decode step as a CUDA graph at its first window (once), and every
   later step is a replay, whose launches the wrappers count.  The
   inputs of each decode step's and each admission wave's layer-0
   attention call are kept (a replayed step's from the tensors the
   graph captured).  Then one decode window of a fresh full wave is
   timed and profiled (device busy time, idle share, the kernels that
   take the time);
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
   plain version may run.  Each batch of at least ``MIN_GRAPH_STEPS``
   steps captures its decode step once, after its prefill, and replays
   it for every step but the first (the capture's warm-up step); the
   captures' host ms and the host ms to enqueue a replayed step are
   logged.  The layer-0 attention inputs of every batch's prefill and of
   a sample of decode steps (replayed ones included) are kept.  Then a
   batch of the serve's largest shape is prefilled again, its decode
   step captured and a copy of its state decoded eagerly by
   ``decode_multi``; the two 8-step windows are held bit for bit
   (tokens, logits, positions, cache), and both are timed and profiled:
   host ms a step, device ms a step and the idle share, graphed against
   eager;
8. padded timings: as phase 6, for the flash and dense decode kernels at
   the kept inputs (yardsticks: SDPA with ``is_causal`` for prefill, SDPA
   with a length mask on the cache cut to its longest row for decode);
9. SSD scan and int8 decode kernels against their plain versions: the
   scan at mamba2-780m's shapes (H 48, P 64, N 128, chunk 128; B 1 and 8;
   S 256 and 200) in f32, against the chunked version at 2e-4 of the
   output's scale and the per-token recurrence at the reference's 5e-3,
   through the wrapper and again at each P slice (32 and 64), and its
   C.B^T scratch against c @ b^T on the lower triangle;
   the int8 decode at chatglm-6b's and a 40/8 GQA shape, f32 and bf16
   queries, mixed lengths, then again with int8 extremes and NaN and inf
   scales written past the lengths, which must change nothing;
10. models: a reduced mamba2-780m (padded prefill, then a fused decode
   window) and a reduced chatglm-6b's fused decode on an int8 cache, in
   f32 on the card against the CPU;
11. SSM padded serve: ``run_engine_backend("mamba2-780m", ...,
   reduced=False)`` at full width (48 layers, d_model 1536, 48 heads,
   d_state 128) in bf16, ``magnus``, on phase 7's 64 requests.  Counts
   are zeroed just before and read just after: every request gets its
   generation length, one readback per power-of-two window, the scan
   launches once per layer and batch, and nothing else and no plain
   version runs.  Captures and replays as in phase 7; the captures'
   reserved memory shows the private pool of a step on the f32 state.
   The layer-0 scan input of every batch is kept; the decode step is
   profiled graphed against eager, as in phase 7;
12. int8 decode window: chatglm-6b at full width in bf16, 16 rows of
   2,048-token prompts, a dense prefill (cache 2,112) quantised into an
   int8 cache, then a 64-step fused decode on the bf16 cache and on the
   int8 one: the int8 kernel launches once per layer and step with no
   plain call; the first step's logits are held, distance against
   distance, to the same step in plain torch (the port's f32
   dequantisation; the bf16 window's own as the control) and to the
   reference's formulation (bf16 dequantisation), as ``int8_window``
   sets out; the layer-0 int8 inputs of every 21st step are kept;
13. timings of the scan and the int8 kernel at the kept inputs, as phase
   8 (yardsticks: none for the scan, which no single PyTorch call
   computes; SDPA with a length mask on the dequantised bf16 cache, the
   dequantisation pass it needs, timed apart, and the bf16 dense decode
   kernel on it, for int8).  Every bound takes operations at 989
   TFLOP/s; the scan logs each kept shape's time beside its B and the
   time at the other P slice, and its mean bound at the 3xTF32 rate
   (495 / 3 TFLOP/s), where it computes, and at the f32 CUDA cores' 67
   TFLOP/s, beside it;
14. warmed serve: phase 5's serve again on a fresh engine built with
   ``warmup=True`` (every admission-wave shape run once, the decode
   step captured), set up as the launcher sets it up, so with the same
   schedule.  Counts are zeroed after the warmup and just before the
   serve, and read just after: no capture during the serve, streams,
   decode steps, windows, host syncs and launches equal to phase 5's,
   no plain call.  Then a full wave's 8-step decode window through the
   captured graph is held bit for bit (tokens, logits, positions)
   against ``decode_multi_paged`` run eagerly on a copy of the state,
   and both are timed and profiled: host ms a step, device ms a step
   and the idle share, graphed against eager, beside the host time the
   warmed serve took to enqueue a replayed step;
15. chaos serve (the lifecycle and the host swap tier): phase 5's 48
   requests and weights through ``drive_paged`` on an engine with a
   128-block pool, a 128-block pinned host tier (allocated when the
   engine is built), a deadline and a ``FaultInjector`` plan of every
   fault kind but the crash (``chaos_plan``).  Counts are zeroed just
   before and read just after.  Check 1, the contract: nothing
   unserved, every request served or shed with a known reason,
   swap-outs, resumes, a quarantine, deadline misses, evictions and
   stall ticks all seen, both tiers drained, one capture, both paged
   kernels launched once per layer and step or wave, no plain call,
   and the host syncs exactly one per decode window, one per NaN-guard
   readback (the engine counts them) and two per swap-out.  The
   layer-0 inputs of every decode step and admission wave of the serve
   (re-admissions and resumed slots' tables included) go through each
   paged kernel and its plain version on the chaos engine's pools, held
   as in phase 6.  Check 2: of two engines admitted identically, one
   has a slot poisoned; after the window it quarantines exactly that
   request, and every other slot's tokens and logits equal the other
   engine's bit for bit.  Check 3: one of two such engines suspends a
   slot and resumes it; its pages, logits row and position equal the
   other's bit for bit, nothing is re-prefilled, and the next window is
   bit-equal.  Check 4: each finished stream against phase 5's; one
   that differs must have been restarted or have another KV lineage
   than in phase 5 (a wave of another shape wrote its KV or its cached
   prefix: bf16 GEMMs of another M may round otherwise); and the
   witness, in f32 (TF32 off) on one f32 weight set: phase 5's serve
   through its launcher (its steps, waves and host syncs equal phase
   5's; its waves' lineages stand for phase 5's), then the chaos serve
   (its counters and sheds equal the bf16 one's), whose every finished
   stream must equal the f32 serve's.  Logged: tokens/s beside phase
   5's, the host-sync split, host ms and GB/s a swap-out and a resume,
   the pinned tier's size and the engine's build time, the NaN guard's
   host ms.

Phases 9 and 10 run right after phase 4, so that a fault in a kernel or
a model stops the run before the serves; phase 14 runs right after
phase 5, and phase 15 last.  The line before the last is a
JSON object with one entry per kernel (six); the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, with no
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
F32_FLOPS = 67e12              # H100 SXM f32 peak outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM dense tf32 tensor-core peak

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

# int8 decode window: chatglm-6b, 16 rows of 2,048-token prompts
INT8_ROWS, INT8_PROMPT, INT8_STEPS = 16, 2048, 64
SCAN_TOL = 2e-4                # f32 scan vs its chunked plain version,
#                                of the output's scale


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
# phase 2: what the compiler made of the kernels
# ---------------------------------------------------------------------------

def _demangle(build, names):
    """Readable kernel names, by the toolkit's cu++filt where there is one."""
    filt = os.path.join(os.path.dirname(build.nvcc_path()), "cu++filt")
    if not names or not os.path.isfile(filt):
        return {n: n for n in names}
    res = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    out = res.stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def build_report(build, lib):
    """Each kernel's registers, static shared memory and spills from the
    build's ``-Xptxas -v`` log, and its tensor-core instructions (HGMMA,
    HMMA) in the library's SASS where the toolkit has ``cuobjdump``.
    Fails if the bf16 flash or bf16 prefix-prefill kernel, or an
    instance of either SSD scan kernel (``ssd_cb_kernel``,
    ``ssd_scan_kernel``: 3xTF32 mma.sync), has no tensor-core
    instruction."""
    import re
    kern = {}
    name = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kern[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            kern[name]["spill"] = f"{m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kern[name]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            kern[name]["smem"] = f"{sm.group(1) if sm else 0} B static"
    tc = {}
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if os.path.isfile(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True,
                              timeout=300).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                tc[fn] = [0, 0]
            elif fn is not None:
                op = re.search(r"\b(HGMMA|HMMA)\.", line)
                if op:
                    tc[fn][op.group(1) == "HMMA"] += 1
    else:
        log("  cuobjdump is not in the toolkit: tensor-core instructions "
            "not counted")
    names = _demangle(build, sorted(kern))
    for mangled in sorted(kern, key=lambda n: names[n]):
        k = kern[mangled]
        hg, hm = tc.get(mangled, ["-", "-"]) if tc else ["-", "-"]
        log(f"  {names[mangled][:110]}: {k.get('regs', '?')} registers, "
            f"{k.get('smem', '?')} smem, spills {k.get('spill', '?')}, "
            f"HGMMA {hg}, HMMA {hm}")
    if tc:
        for kind in ("flash_tc_kernel", "prefix_prefill_tc_kernel",
                     "ssd_cb_kernel", "ssd_scan_kernel"):
            fns = [n for n in tc if kind in n]
            check(fns and all(tc[n][0] + tc[n][1] > 0 for n in fns),
                  f"a {kind} has no tensor-core instruction: "
                  f"{ {n: tc[n] for n in fns} }")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(torch, ops, ref):
    """Each kernel against its plain version on random unit-size inputs
    at chatglm-6b's, GQA and edge shapes, f32 and bf16, then the poison
    cases."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    decode_shapes = [   # (name, b, hq, hkv, d, bt, nb, mb, lengths)
        ("chatglm-6b", 32, 32, 32, 128, 16, 2048, 40,
         cycle([1, 15, 16, 17, 56, 100, 127, 250, 640], 32)),
        ("gqa smollm-135m", 8, 9, 3, 64, 16, 256, 16,
         [1, 16, 33, 64, 200, 256, 77, 5]),
        ("b2 splits g2 d64 bt8", 2, 8, 4, 64, 8, 256, 120, [641, 900]),
        ("b1 splits g12 d32 bt32", 1, 24, 2, 32, 32, 64, 40, [1000]),
        ("page edges g3 d32 bt32", 6, 6, 2, 32, 32, 64, 4,
         [15, 16, 17, 31, 32, 33])]
    prefill_shapes = [  # (name, b, s, hq, hkv, d, bt, nb, mb, plens, slens)
        ("chatglm-6b mixed", 32, 64, 32, 32, 128, 16, 2048, 40,
         cycle([0, 32, 48, 47, 0, 600], 32), cycle([56, 24, 8, 9, 64, 1], 32)),
        ("chatglm-6b misses", 32, 64, 32, 32, 128, 16, 2048, 1,
         [0] * 32, cycle([56, 13, 64, 1], 32)),
        ("gqa smollm-135m", 4, 24, 9, 3, 64, 16, 128, 8,
         [0, 17, 64, 128], [24, 5, 1, 20]),
        ("g3 two row tiles d64", 3, 40, 6, 2, 64, 16, 64, 9,
         [70, 0, 130], [40, 17, 33]),
        ("s 100 d32 bt8", 3, 100, 2, 2, 32, 8, 64, 8,
         [9, 64, 0], [100, 65, 7])]
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
    """Poisoning pages outside a row's table (its pad entries' included),
    its own slots past its length, and (prefill) suffix keys past
    suffix_len must not change the row's output at all, in f32 and
    bf16."""
    f = dict(device="cuda", generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        rnd = lambda *shape: torch.randn(*shape, **f).to(dtype)
        # decode: bt 16, Hq 4, Hkv 2, D 32, lengths (23, 40)
        q, kp, vp = rnd(2, 4, 32), rnd(6, 16, 2, 32), rnd(6, 16, 2, 32)
        tables = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32,
                              device="cuda")
        lens = torch.tensor([23, 40], dtype=torch.int32, device="cuda")
        out1 = ops.paged_decode_attention(q, kp, vp, tables, lens)
        kp2, vp2 = kp.clone(), vp.clone()
        for t in (kp2, vp2):
            t[0] = float("nan")            # the pad entry of row 0's table
            t[2, 7:] = float("nan")        # row 0's own slots past 23
            t[3:] = -1e4                   # row 1's pages
        out2 = ops.paged_decode_attention(q, kp2, vp2, tables, lens)
        err = (out1[0] - out2[0]).abs().max().item()
        log(f"kernel paged_decode_attention poison {dtype}: "
            f"max_abs_change {err:.3e}")
        check(err == 0.0, f"decode poison changed the output by {err}")
        # prefill: bt 8, Hq 4, Hkv 2, D 32, S 8, plens (12, 20), slens (8, 5)
        q, ks, vs = rnd(2, 8, 4, 32), rnd(2, 8, 2, 32), rnd(2, 8, 2, 32)
        kp, vp = rnd(7, 8, 2, 32), rnd(7, 8, 2, 32)
        tables = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32,
                              device="cuda")
        pl = torch.tensor([12, 20], dtype=torch.int32, device="cuda")
        sl = torch.tensor([8, 5], dtype=torch.int32, device="cuda")
        out1 = ops.paged_prefix_prefill_attention(q, ks, vs, kp, vp, tables,
                                                  pl, sl)
        kp2, vp2, ks2, vs2 = kp.clone(), vp.clone(), ks.clone(), vs.clone()
        for t in (kp2, vp2):
            t[0] = float("nan")            # the pad entry of row 0's table
            t[2, 4:] = float("nan")        # row 0's own slots past plen 12
            t[3] = 1e4                     # row 1's page
        for t in (ks2, vs2):
            t[1, 5:] = float("nan")        # row 1's suffix keys past slen 5
        out2 = ops.paged_prefix_prefill_attention(q, ks, vs, kp2, vp2,
                                                  tables, pl, sl)
        out3 = ops.paged_prefix_prefill_attention(q, ks2, vs2, kp, vp,
                                                  tables, pl, sl)
        err = max((out1[0] - out2[0]).abs().max().item(),
                  (out1[1] - out3[1]).abs().max().item())
        log(f"kernel paged_prefix_prefill_attention poison {dtype}: "
            f"max_abs_change {err:.3e}")
        check(err == 0.0, f"prefill poison changed the output by {err}")


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

def _capturing():
    import torch
    return torch.cuda.is_current_stream_capturing()


class Recorder:
    """Inside the ``with`` block, ``module.<name>`` is wrapped: every call
    passes straight through to it (its ``ops`` wrapper counts its launch
    as always), and the calls are taken as steps of ``layers``
    consecutive calls, one per layer.  On every ``every``-th step the
    layer-0 call's inputs go through ``keep``, and what it returns is
    kept (None keeps nothing); ``keep`` copies every tensor of a step
    that may be replayed.  ``steps`` counts the steps; ``restart()``
    makes the next step the first of a new sample, as at a new batch.

    Calls made while a CUDA graph is being captured are no steps (the
    capture runs nothing): the layer-0 call's input tensors are held
    instead, and :meth:`replayed` takes them as the inputs of a step
    after each replay of the graph (see :class:`replays`).  The inputs at
    the positions ``snap`` are temporaries of the step, whose memory a
    later layer of the same replay may reuse: they are copied inside the
    capture, so each replay leaves that step's layer-0 values in the
    copies; the others (the cache, the tables) are the engine's own."""

    def __init__(self, module, name, layers, keep=lambda *a: a, every=1,
                 snap=()):
        self.module, self.name, self.layers = module, name, layers
        self.keep, self.every, self.snap = keep, every, snap
        self.kept, self.steps = [], 0
        self._calls = self._step = self._captured_calls = 0
        self.captured = None

    def restart(self):
        self._step = 0

    def _take(self, args, kw):
        if self._step % self.every == 0:
            item = self.keep(*args, **kw)
            if item is not None:
                self.kept.append(item)
        self._step += 1
        self.steps += 1

    def replayed(self):
        """One replay of the captured graph ran: a step, whose layer-0
        inputs are the captured tensors' contents now."""
        if self.captured is not None:
            self._take(*self.captured)

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.name)

        def call(*args, **kw):
            if _capturing():
                if self._captured_calls % self.layers == 0:
                    self.captured = (tuple(
                        a.clone() if i in self.snap else a
                        for i, a in enumerate(args)), kw)
                self._captured_calls += 1
            else:
                if self._calls % self.layers == 0:
                    self._take(args, kw)
                self._calls += 1
            return orig(*args, **kw)

        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class replays:
    """Inside the ``with`` block every replay of an engine's captured
    decode step (``DecodeGraph.replay``, paged or padded) is followed by
    each recorder's :meth:`Recorder.replayed`, and every paged decode
    window that ran steps is counted in ``windows``.  ``replayed_steps``
    and ``enqueue_s`` sum the steps that ``DecodeGraph.window`` replayed
    and the host time it took to enqueue them (it does not wait for the
    card).  ``captures`` holds, for each capture, its host seconds
    (``DecodeGraph.capture_s``) and the bytes the allocator reserved
    anew while the graph was made (its private pool, and the warm-up
    step's first blocks on a new capture stream)."""

    def __init__(self, *recorders):
        self.recorders, self.windows = recorders, 0
        self.replayed_steps, self.enqueue_s = 0, 0.0
        self.captures = []

    def __enter__(self):
        import torch
        from repro_torch.serving.engine import PagedContinuousEngine
        from repro_torch.serving.graphs import DecodeGraph
        self.targets = ((DecodeGraph, "replay", DecodeGraph.replay),
                        (DecodeGraph, "window", DecodeGraph.window),
                        (DecodeGraph, "__init__", DecodeGraph.__init__),
                        (PagedContinuousEngine, "step_window",
                         PagedContinuousEngine.step_window))
        replay, window, init, step_window = (t[2] for t in self.targets)

        def measured_init(graph, *a, **kw):
            r0 = torch.cuda.memory_reserved()
            init(graph, *a, **kw)
            self.captures.append((graph.capture_s,
                                  torch.cuda.memory_reserved() - r0))

        def replay_and_record(graph):
            replay(graph)
            for r in self.recorders:
                r.replayed()

        def timed_window(graph, k, start=0):
            t0 = time.perf_counter()
            out = window(graph, k, start)
            self.enqueue_s += time.perf_counter() - t0
            self.replayed_steps += k - start
            return out

        def counted_window(engine, *a, **kw):
            out = step_window(engine, *a, **kw)
            self.windows += out[2] > 0
            return out

        DecodeGraph.replay = replay_and_record
        DecodeGraph.window = timed_window
        DecodeGraph.__init__ = measured_init
        PagedContinuousEngine.step_window = counted_window
        return self

    def log(self, label, steps):
        """Log the captures' host ms and reserved MiB and the host ms to
        enqueue a replayed step; returns the mean capture ms."""
        ms = [c * 1e3 for c, _ in self.captures]
        log(f"{label}: {len(ms)} capture(s), host ms each "
            f"{[round(m, 2) for m in ms]}, MiB reserved anew each "
            f"{[round(b / 2 ** 20, 1) for _, b in self.captures]}; "
            f"{self.replayed_steps} of {steps} steps replayed, the host "
            f"enqueued a replayed step (replay and token copy) in "
            f"{self.enqueue_s * 1e3 / max(1, self.replayed_steps):.4f} ms "
            f"on average")
        return sum(ms) / max(1, len(ms))

    def __exit__(self, *exc):
        for cls, name, orig in self.targets:
            setattr(cls, name, orig)


def paged_recorders(transformer, layers):
    """Recorders of the paged serve's layer-0 attention inputs: every
    decode step (q, tables, lengths) and every admission wave (suffix
    q/K/V, tables, prefix and suffix lengths)."""
    decode = Recorder(transformer, "paged_decode_attention", layers,
                      lambda q, kp, vp, tables, lengths:
                      (q.clone(), tables.clone(), lengths.clone()),
                      snap=(0, 4))
    prefill = Recorder(transformer, "paged_prefix_prefill_attention", layers,
                       lambda q, ks, vs, kp, vp, tables, plens, slens:
                       (q, ks, vs, tables.clone(), plens.clone(),
                        slens.clone()))
    return decode, prefill


def _device_us(prof):
    """Device time of every kernel, copy and fill in a profile (us)."""
    return sum(getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0)
               for e in prof.key_averages())


def window_profile(torch, run, label, kernel="decode_split_kernel"):
    """Time one decode window ``run()`` (which returns its steps, its one
    readback included) on the host clock, then profile a second one:
    device busy time (every kernel, copy and fill the profiler records),
    the window's span between CUDA events (busy time plus the card's
    gaps), the idle share (1 - busy / host time) and the kernels that
    take the time.  Kernels replayed from a CUDA graph count only if the
    profiler attributes them: the phase fails unless ``kernel`` (the
    decode kernel's name; None for a model that launches none) is among
    the profile's events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k = run()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / k
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        k2 = run()
        z.record()
        torch.cuda.synchronize()
    busy = _device_us(prof) / 1e3 / k2
    span = a.elapsed_time(z) / k2
    check(busy > 0, "the profiler recorded no device time")
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0))
    events = prof.key_averages()
    check(kernel is None or any(kernel in e.key and dev(e) > 0
                                for e in events),
          f"{label}: the profiler attributed no {kernel}")
    top = sorted(events, key=dev, reverse=True)[:6]
    idle = max(0.0, 1 - busy / host)
    log(f"{label}: {host:.2f} ms per step on the host clock, device busy "
        f"{busy:.2f} ms per step (event span {span:.2f}; idle share "
        f"{idle:.2f}); top device time per step: " + "; ".join(
            f"{e.key[:60]} {dev(e) / 1e3 / k2:.3f} ms" for e in top))
    return {"host_ms": host, "busy_ms": busy, "span_ms": span,
            "idle": idle}


def profile_window(torch, engine, reqs, eager=False):
    """Where a decode step's time goes on the card: admit one full wave
    into the served engine, settle it with one short window, then time
    and profile decode windows of 8 steps through the engine (replays of
    its captured step, its readback and bookkeeping).  With ``eager``,
    also the same windows run eagerly by ``decode_multi_paged`` on a
    copy of the state (the launches one by one from Python, and the
    readback), after holding its first window to the graphed one bit for
    bit.  Then drain."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import drive_paged
    check(engine.join_many(reqs) == len(reqs), "profile wave refused")
    engine.step_window(max_steps=4)            # first window after a wave
    out = {}
    if eager:
        pages = {key: v.clone() for key, v in engine.pages.items()}
        batch = {"logits": engine.logits.clone(),
                 "positions": engine.positions.clone(),
                 "block_tables": engine.tables.clone(),
                 "active": engine.active_mask.clone()}
        before = [a and len(a["generated"]) for a in engine.active]
        _, _, k = engine.step_window(max_steps=8)
        logits, _, positions, toks = M.decode_multi_paged(
            engine.params, engine.cfg, pages, dict(batch), num_steps=k,
            act_dtype=engine.dtype)
        toks = toks.cpu()
        for slot, a in enumerate(engine.active):
            check(a is None or a["generated"][before[slot]:]
                  == toks[slot].tolist(),
                  f"slot {slot}: graphed and eager windows differ")
        live = engine.active_mask             # finished rows are reset
        check(torch.equal(logits, engine.logits)
              and torch.equal(positions[live], engine.positions[live]),
              "graphed and eager windows differ in logits or positions")
        log(f"graphed and eager {k}-step windows at {engine.num_active} "
            f"rows: tokens, logits and positions bit-equal")

        def run_eager():
            toks = M.decode_multi_paged(
                engine.params, engine.cfg, pages, dict(batch), num_steps=8,
                act_dtype=engine.dtype)[3]
            toks.cpu()
            return 8

        out["eager"] = window_profile(
            torch, run_eager, f"eager decode window at "
            f"{engine.num_active} rows")
        del pages, batch
    out["graphed"] = window_profile(
        torch, lambda: engine.step_window(max_steps=8)[2],
        f"graphed decode window at {engine.num_active} rows")
    st = drive_paged(engine, [])
    check(not engine.num_active and not st["unserved"],
          "profile wave did not drain")
    engine.assert_drained()
    return out


# ---------------------------------------------------------------------------
# phase 14: phase 5's serve on an engine warmed up ahead of time
# ---------------------------------------------------------------------------

def warmed_serve(torch, reqs, reset_counts, counts):
    """Phase 5's serve again, set up as ``run_paged_engine_backend`` sets
    it up (the same service, predictor, pool and weights, so the same
    schedule) but with ``warmup=True``, which the launcher does not
    expose: the engine runs every wave shape and captures its decode
    step before the counts are zeroed.  Returns the serve's launches,
    plain calls, streams, host syncs, windows and steps, and the engine's
    captures before and after the serve."""
    from repro_torch.configs import get_config
    from repro_torch.core.magnus import MagnusConfig, MagnusService
    from repro_torch.core.predictor import GenerationLengthPredictor
    from repro_torch.core.wma import MemoryModel
    from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
    from repro_torch.serving.paged_cache import (BlockAllocator,
                                                 MispredictionEWMA)
    from repro_torch.workload.apps import make_dataset
    cfg = get_config("chatglm-6b")
    memory = MemoryModel(cfg, hbm_bytes=2 * 2 ** 30,
                         max_len=SERVE["max_len"], max_gen=SERVE["max_gen"])
    allocator = BlockAllocator(SERVE["num_blocks"], SERVE["block_tokens"])
    svc = MagnusService(
        memory, MagnusConfig(strategy="magnus-paged", prefix_sharing=True),
        predictor=GenerationLengthPredictor(seed=0).fit(
            make_dataset(60, seed=1)),
        allocator=allocator)
    ewma = MispredictionEWMA()
    svc.memory.headroom = ewma
    t0 = time.perf_counter()
    engine = PagedContinuousEngine(
        cfg, seed=0, max_concurrency=SERVE["max_concurrency"],
        max_len=SERVE["max_len"], max_gen=SERVE["max_gen"],
        dtype=torch.bfloat16, allocator=allocator,
        prefix_cache=svc.prefix_cache or False, mispredict=ewma,
        device="cuda",
        warmup=True)
    torch.cuda.synchronize()
    captures0 = engine.graph_captures
    log(f"warmed engine: weights and warmup {time.perf_counter() - t0:.1f}"
        f" s, {captures0} capture(s)")
    for r in reqs:
        svc.on_request(r, r.arrival_time)

    def refill(steps):
        nb = svc.next_batch(now=float(steps))
        return nb.requests if nb is not None else None

    t0 = time.perf_counter()
    with replays() as rep:
        reset_counts()
        st = drive_paged(engine, [], max_steps=100_000, refill=refill,
                         backlog=lambda: len(svc.batcher.queue) > 0)
        torch.cuda.synchronize()
        launches = counts("launches")
    wall = time.perf_counter() - t0
    tokens = sum(len(g) for g in engine.generated.values())
    log(f"warmed serve: {wall:.2f} s, {tokens / wall:.1f} tokens/s, "
        f"{st['served']} requests, {engine.decode_steps} steps in "
        f"{rep.windows} windows, {st['host_syncs']} host syncs, "
        f"launches {launches}; the host enqueued a replayed step (replay "
        f"and token copy) in {rep.enqueue_s * 1e3 / max(1, rep.replayed_steps):.4f}"
        f" ms on average over {rep.replayed_steps} steps")
    return {"engine": engine, "launches": launches,
            "plain_calls": counts("plain_calls"), "stats": st,
            "windows": rep.windows, "replayed_steps": rep.replayed_steps,
            "captures": (captures0, engine.graph_captures)}


# ---------------------------------------------------------------------------
# phase 15: the chaos serve (the §14 lifecycle and the §15 host swap tier)
# ---------------------------------------------------------------------------

# a pool of 128 blocks (30 of phase 5's requests fit at once, with their
# shared heads) and a host tier of as many (0.94 GB pinned at chatglm-6b's
# 7.3 MB a block); the deadline lets the first wave finish and sheds the
# requests that a suspension or a restart plus the stall hold past it
CHAOS = dict(num_blocks=128, block_tokens=16, max_concurrency=32,
             max_len=512, max_gen=128)
CHAOS_SWAP_BLOCKS = 128
CHAOS_TTL = 60                 # scheduler-clock ticks from admission
TWIN = dict(num_blocks=512, block_tokens=16, max_concurrency=32,
            max_len=512, max_gen=128)
POISON_SLOT, SWAP_SLOT = 5, 9  # the twin checks' victims
GUARD_REPS = 20


def chaos_plan(FaultEvent):
    """Every fault kind of the lifecycle and the tier, in one serve of 7
    decode windows: an under-prediction storm on one app (x0.25 from the
    first admission), a poisoned slot, a pool shrink (suspensions), a
    host tier squeezed to 8 blocks (so later victims are destroyed), two
    stalled resumes, a stall, then both restores."""
    return [FaultEvent(window=0, kind="predict_skew", app="head1",
                       factor=0.25),
            FaultEvent(window=2, kind="poison_logits"),
            FaultEvent(window=3, kind="pool_shrink", blocks=40),
            FaultEvent(window=4, kind="host_pressure", blocks=120),
            FaultEvent(window=4, kind="swap_stall", ticks=2),
            FaultEvent(window=6, kind="stall", ticks=24),
            FaultEvent(window=7, kind="host_pressure", blocks=0),
            FaultEvent(window=7, kind="pool_restore")]


class wave_shapes:
    """Inside the ``with`` block every admission wave of a paged engine
    records, for each request it prefills, the KV's lineage: the wave's
    shape (its rows, the power-of-two batch, and its suffix bucket), the
    request's cached prefix tokens, and the lineage of every block its
    cached prefix shares (or clones), as recorded when that block was
    written.  A bf16 prefill in a wave of another shape (another GEMM M)
    may round differently, and so may everything computed on its KV.
    ``by_req`` maps a req_id to the lineages of its admissions (a
    restarted request has more than one)."""

    def __init__(self):
        self.by_req = {}
        self.written = {}      # block -> the lineage of its writer

    def __enter__(self):
        from repro_torch.serving import engine as E
        self.orig = orig = E.PagedContinuousEngine._dispatch_wave

        def record(engine, plans):
            nb = E._pow2_ceil(len(plans))
            sb = E._bucket(max(len(p["ids"]) - p["cached"] for p in plans))
            lines = []
            for p in plans:
                full = p["cached"] // engine.bt
                src = list(p["table"][:full]) + (
                    [p["cow"][0]] if p["cow"] is not None else [])
                line = (nb, sb, p["cached"],
                        tuple(self.written.get(b) for b in src))
                self.by_req.setdefault(p["req"].req_id, []).append(line)
                lines.append(line)
            out = orig(engine, plans)
            for p, line in zip(plans, lines):
                for b in p["table"][p["cached"] // engine.bt:]:
                    self.written[b] = line
            return out

        E.PagedContinuousEngine._dispatch_wave = record
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import engine as E
        E.PagedContinuousEngine._dispatch_wave = self.orig


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def block_bytes(engine) -> int:
    """Bytes of one block across the pools (every layer, K and V)."""
    return sum(p[:, 0].numel() * p.element_size()
               for p in engine.pages.values())


def chaos_serve(torch, cfg, params, device, dtype, reset_counts, counts,
                plan=None):
    """Phase 5's 48 requests (predictions exact, but for the skewed app)
    straight through ``drive_paged`` on a faulted engine with a host
    tier and deadlines.  Counts are zeroed just before and read just
    after.  Each swap-out is timed on the host (it waits for its
    copies); every wave's KV lineage is recorded, and so are the layer-0
    inputs of every decode step and admission wave (as in phase 5), for
    :func:`hold_chaos`.  Returns what the checks and the log need."""
    from repro_torch.models import transformer
    from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
    from repro_torch.serving.faults import FaultEvent, FaultInjector
    from repro_torch.workload.apps import make_shared_head_dataset
    reqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                    gen_length=GEN_LENGTH, seed=0)
    inj = FaultInjector(plan if plan is not None else chaos_plan(FaultEvent))
    t0 = time.perf_counter()
    engine = PagedContinuousEngine(
        cfg, params, device=device, dtype=dtype, faults=inj,
        default_ttl=CHAOS_TTL, swap_blocks=CHAOS_SWAP_BLOCKS,
        prefix_cache=True, **CHAOS)
    build_s = time.perf_counter() - t0
    swap_out, outs, queued = engine._swap_out, [], []

    def timed_swap_out(slot):
        # whether device work was still queued (the swap-out's wait for
        # its copies waits for that work too); asks, does not wait
        busy = (torch.device(device).type == "cuda"
                and not torch.cuda.current_stream().query())
        t0, s0 = time.perf_counter(), engine.host_syncs
        b0 = engine.swapped_blocks
        ok = swap_out(slot)
        if ok:
            outs.append((time.perf_counter() - t0, engine.host_syncs - s0,
                         engine.swapped_blocks - b0))
            queued.append(busy)
        return ok

    engine._swap_out = timed_swap_out
    decoded, waves = paged_recorders(transformer, cfg.num_layers)
    _sync(torch, device)
    t0 = time.perf_counter()
    with decoded, waves, replays(decoded) as rep, wave_shapes() as shapes:
        reset_counts()
        st = drive_paged(engine, list(reqs), max_steps=100_000)
        _sync(torch, device)
        launches = counts("launches")
    wall = time.perf_counter() - t0
    inj.release(engine.allocator)
    return {"engine": engine, "reqs": reqs, "stats": st, "inj": inj,
            "launches": launches, "plain_calls": counts("plain_calls"),
            "wall": wall, "windows": rep.windows, "outs": outs,
            "build_s": build_s, "queued": queued,
            "shapes": shapes.by_req, "decoded": decoded, "waves": waves}


def hold_chaos(torch, ops, ref, r):
    """Phase 15: every decode step and admission wave of the chaos serve
    (its row counts, suffix buckets, re-admissions with their radix
    hits, resumed slots' scattered tables), recorded at layer 0, through
    each paged kernel and its plain version on the chaos engine's
    pools, held as phase 6 holds phase 5's (``hold``).  The recorders
    must have seen every step and wave.  Returns the largest error of
    each kernel."""
    eng, decoded, waves = r["engine"], r["decoded"], r["waves"]
    check(len(decoded.kept) == eng.decode_steps
          and len(waves.kept) == eng.prefill_dispatches,
          f"recorded {len(decoded.kept)} decode steps and "
          f"{len(waves.kept)} waves of {eng.decode_steps} and "
          f"{eng.prefill_dispatches}")
    K, V = eng.pages["k"][0], eng.pages["v"][0]
    errs = {"paged_decode_attention": [],
            "paged_prefix_prefill_attention": []}
    for q, tables, lens in decoded.kept:
        errs["paged_decode_attention"].append(hold(
            torch, "paged_decode_attention",
            ops.paged_decode_attention(q, K, V, tables, lens),
            ref.paged_decode_attention_ref(q, K, V, tables, lens)))
    for q, ks, vs, tables, pl, sl in waves.kept:
        errs["paged_prefix_prefill_attention"].append(hold(
            torch, "paged_prefix_prefill_attention",
            ops.paged_prefix_prefill_attention(q, ks, vs, K, V, tables,
                                               pl, sl),
            ref.paged_prefix_prefill_attention_ref(q, ks, vs, K, V, tables,
                                                   pl, sl)))
    log("chaos holds (layer-0 inputs, the chaos engine's layer-0 pools): "
        + "; ".join(f"{name} at {len(e)} served shapes, max abs err "
                    f"{max(x for x, _ in e):.3e} at output scale up to "
                    f"{max(sc for _, sc in e):.1f}"
                    for name, e in errs.items()))
    return {name: max(x for x, _ in e) for name, e in errs.items()}


def check_chaos(torch, r, layers):
    """Phase 15's check 1, the contract: nothing unserved, every request
    served or shed with a known reason, every fault kind seen, both
    tiers drained, one capture (on the card), the kernels launched once
    per layer and step or wave and no plain version ran, and the host
    syncs exactly one per decode window, one per NaN-guard readback (the
    engine counts them, at most one a window) and two per swap-out (one
    if it had no page to copy)."""
    from repro_torch.core.types import SHED_REASONS
    eng, st = r["engine"], r["stats"]
    check(not st["unserved"], f"{len(st['unserved'])} requests unserved")
    check(st["served"] + len(st["shed"]) == N_REQUESTS,
          f"{st['served']} served + {len(st['shed'])} shed != {N_REQUESTS}")
    check(all(s.reason in SHED_REASONS for s in st["shed"]),
          "a shed without a known reason")
    seen = {name: getattr(eng, name) for name in (
        "swap_outs", "swap_ins", "quarantined", "deadline_misses",
        "evictions", "stall_ticks")}
    check(all(seen.values()), f"a fault path never ran: {seen}")
    eng.assert_drained()
    check(eng.swap.empty, "the host tier is not empty")
    if eng.device.type == "cuda":
        check(eng.graph_captures == 1,
              f"{eng.graph_captures} captures of the decode step")
    check(r["launches"]["paged_decode_attention"]
          == layers * eng.decode_steps
          and r["launches"]["paged_prefix_prefill_attention"]
          == layers * eng.prefill_dispatches,
          f"chaos launches {r['launches']} against {eng.decode_steps} "
          f"steps and {eng.prefill_dispatches} waves")
    check(not any(r["plain_calls"].values()),
          f"plain versions ran in the chaos serve: {r['plain_calls']}")
    swap_syncs = sum(s for _, s, _ in r["outs"])
    check(len(r["outs"]) == eng.swap_outs
          and all(s == (2 if b else 1) for _, s, b in r["outs"]),
          f"swap-outs (host s, syncs, fresh blocks) {r['outs']}: not one "
          f"readback for the logits row and one for the pages, if any")
    guard = eng.guard_readbacks
    check(r["windows"] <= guard <= eng.windows
          and st["host_syncs"] == r["windows"] + guard + swap_syncs,
          f"host syncs {st['host_syncs']}: not {r['windows']} decode "
          f"windows + {guard} guard readbacks (in {eng.windows} windows) "
          f"+ {swap_syncs} swap-out readbacks")
    for rid, toks in eng.generated.items():
        check(len(toks) == GEN_LENGTH
              and all(0 <= t < eng.cfg.vocab_size for t in toks),
              f"request {rid}: {len(toks)} tokens or one out of range")
    return guard


def compare_streams(reqs, generated, shapes, reqs5, streams5, shapes5):
    """Phase 15's check 4: each finished stream (``generated``) against
    the unfaulted serve's for the same request; each that differs is put
    down to a restart (re-prefilled), to its one admission's KV lineage
    differing from the unfaulted serve's (``wave_shapes``), or to
    neither.  Returns (equal count, restarted, other lineage, same
    lineage) as request indices."""
    same, restarted, other, unexplained = 0, [], [], []
    for i, req in enumerate(reqs):
        toks = generated.get(req.req_id)
        if toks is None:
            continue
        if toks == streams5[i]:
            same += 1
            continue
        lines = shapes.get(req.req_id, [])
        if len(lines) > 1:
            restarted.append(i)
        elif lines != shapes5.get(reqs5[i].req_id, []):
            other.append(i)
        else:
            unexplained.append(i)
    return same, restarted, other, unexplained


def shed_list(r):
    """The chaos serve's sheds in order, as (request index, reason)."""
    index = {q.req_id: i for i, q in enumerate(r["reqs"])}
    return [(index[x.req.req_id], x.reason) for x in r["stats"]["shed"]]


def f32_witness(torch, cfg, reset_counts, counts, served5, chaos16):
    """Phase 15's witness for check 4, in f32 (TF32 off) on one weight
    set: phase 5's serve (its launcher, geometry, requests and seed, so
    its schedule: steps, waves, windows and host syncs must equal phase
    5's), whose admission waves' KV lineages stand for phase 5's, then
    the chaos serve.  The chaos serve's schedule is length-scripted, so
    its counters and sheds must equal the bf16 chaos serve's; its
    streams are compared with the f32 serve's by ``compare_streams``,
    as the bf16 ones with phase 5's.  Returns phase 5's lineages, that
    comparison and the f32 chaos serve's wall time."""
    from repro_torch.launch.serve import run_paged_engine_backend
    from repro_torch.models import model as M
    from repro_torch.workload.apps import make_shared_head_dataset
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for f32 GEMMs")
    log(f"f32 witness: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated before its weights")
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    reqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                    gen_length=GEN_LENGTH, seed=0)
    with wave_shapes() as shapes5:
        res = run_paged_engine_backend(
            "chatglm-6b", 0.0, 0.0, "magnus-paged", seed=0, reduced=False,
            device="cuda", dtype=torch.float32, prefix_cache=True,
            requests=reqs, params=params, **SERVE)
    eng = res.pop("engine")
    sched = (eng.decode_steps, eng.prefill_dispatches, res["host_syncs"])
    check(sched == (served5["steps"], served5["waves"],
                    served5["host_syncs"]),
          f"the f32 serve's steps, waves and host syncs {sched}: not "
          f"phase 5's {served5['steps'], served5['waves']}, "
          f"{served5['host_syncs']}")
    eng.assert_drained()
    streams = [eng.generated[r.req_id] for r in reqs]
    del eng, res
    torch.cuda.empty_cache()
    r = chaos_serve(torch, cfg, params, "cuda", torch.float32,
                    reset_counts, counts)
    del params
    eng = r["engine"]
    names = ("decode_steps", "prefill_dispatches", "evictions",
             "quarantined", "deadline_misses", "stall_ticks", "swap_outs",
             "swap_ins", "swapped_blocks", "host_syncs")
    mine = {n: getattr(eng, n) for n in names}
    check(mine == chaos16["counters"]
          and shed_list(r) == chaos16["sheds"],
          f"the f32 chaos serve's counters {mine} or sheds differ from "
          f"the bf16 one's {chaos16['counters']}")
    eng.assert_drained()
    cmp = compare_streams(r["reqs"], eng.generated, r["shapes"], reqs,
                          streams, shapes5.by_req)
    wall = r["wall"]
    del r, eng
    torch.cuda.empty_cache()
    return shapes5.by_req, cmp, wall


def _twins(torch, cfg, params, device, dtype, plans, **kw):
    """Two engines admitted identically (the first 32 of phase 5's
    requests in one wave) and run one 2-step window (the capture);
    ``plans`` gives each its fault plan."""
    import copy
    from repro_torch.serving.engine import PagedContinuousEngine
    from repro_torch.serving.faults import FaultInjector
    from repro_torch.workload.apps import make_shared_head_dataset
    reqs = make_shared_head_dataset(TWIN["max_concurrency"], n_apps=3,
                                    gen_length=GEN_LENGTH, seed=0)
    out = []
    for plan in plans:
        eng = PagedContinuousEngine(
            cfg, params, device=device, dtype=dtype, prefix_cache=True,
            faults=FaultInjector(plan), **TWIN, **kw)
        check(eng.join_many(copy.deepcopy(reqs)) == len(reqs),
              "a twin engine refused its wave")
        eng.step_window(max_steps=2)
        out.append(eng)
    a, b = out
    check(all(x["generated"] == y["generated"]
              for x, y in zip(a.active, b.active)),
          "the twin engines' first windows differ")
    return a, b


def _same_window(torch, a, b, skip=()):
    """One 4-step window on both twins: the same steps, and bit-equal
    tokens and logits on every slot not in ``skip``."""
    _, ea, ka = a.step_window(max_steps=4)
    _, eb, kb = b.step_window(max_steps=4)
    check(ka == kb == 4, f"twin windows of {ka} and {kb} steps")
    keep = [s for s in range(a.slots) if s not in skip]
    for s in keep:
        check(a.active[s]["generated"] == b.active[s]["generated"],
              f"slot {s}: the twins' tokens differ")
    check(torch.equal(a.logits[keep], b.logits[keep]),
          "the twins' logits differ")
    return ea, eb


def quarantine_check(torch, cfg, params, device, dtype):
    """Phase 15's check 2: poison slot ``POISON_SLOT`` of twin A in its
    second window; A quarantines exactly that slot's request, and every
    other slot's tokens and logits after the window equal twin B's, bit
    for bit.  Then the guard's readback, timed alone on B's logits."""
    from repro_torch.serving.faults import FaultEvent
    a, b = _twins(torch, cfg, params, device, dtype,
                  [[FaultEvent(window=2, kind="poison_logits",
                               slot=POISON_SLOT)], []])
    victim = a.active[POISON_SLOT]["req"].req_id
    ea, eb = _same_window(torch, a, b, skip=(POISON_SLOT,))
    check(a.quarantined == 1 and [r.req_id for r in ea] == [victim]
          and b.quarantined == 0 and not eb,
          f"quarantine: A {a.quarantined} ({[r.req_id for r in ea]}), "
          f"B {b.quarantined}")
    _sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(GUARD_REPS):
        torch.isfinite(b.logits).all(dim=1).cpu()
    guard_ms = (time.perf_counter() - t0) * 1e3 / GUARD_REPS
    log(f"quarantine: slot {POISON_SLOT} poisoned, request {victim} "
        f"quarantined; the other {a.slots - 1} slots' tokens and logits "
        f"bit-equal to the unpoisoned twin's; the guard's readback of "
        f"{tuple(b.logits.shape)} {b.logits.dtype} logits as {a.slots} "
        f"flags: {guard_ms:.4f} host ms")
    return guard_ms


def swap_roundtrip_check(torch, cfg, params, device, dtype):
    """Phase 15's check 3: twin A suspends slot ``SWAP_SLOT`` and resumes
    it with no admission between; its pages through its new table, its
    logits row and position equal twin B's bit for bit, its prefill
    tokens do not move, and the next window equals B's on every slot.
    The suspension (gather and two synchronous copies to pinned memory)
    and the resume (scatter, restore, synchronised) are timed."""
    from repro_torch.models import model as M
    a, b = _twins(torch, cfg, params, device, dtype, [[], []],
                  swap_blocks=CHAOS_SWAP_BLOCKS)
    pt0, s = a.prefill_tokens, SWAP_SLOT
    rid = a.active[s]["req"].req_id
    _sync(torch, device)
    t0 = time.perf_counter()
    check(a._swap_out(s) and a.active[s] is None,
          "the twin's suspension was refused")
    t_out = time.perf_counter() - t0
    image = a.swapped_blocks * block_bytes(a)
    back = len(a.swap.split_resident(rid)[1]) * block_bytes(a)
    _sync(torch, device)
    t0 = time.perf_counter()
    check(a._resume_swapped() == 1 and a.active[s] is not None,
          "the suspended slot did not resume into its slot")
    _sync(torch, device)
    t_in = time.perf_counter() - t0
    check(a.prefill_tokens == pt0, "the resume re-prefilled tokens")
    pages = [M.gather_pages(e.pages, torch.tensor(
        e.allocator.tables[s], device=e.device)) for e in (a, b)]
    check(torch.equal(*pages), "the resumed pages differ from the twin's")
    check(torch.equal(a.logits[s], b.logits[s])
          and torch.equal(a.positions, b.positions)
          and int(a.pos_host[s]) == int(b.pos_host[s]),
          "the resumed logits row or position differs")
    _same_window(torch, a, b)
    log(f"swap round trip: slot {s}, {a.swapped_blocks} blocks "
        f"({image / 2 ** 20:.1f} MiB) suspended in {t_out * 1e3:.2f} host "
        f"ms ({image / t_out / 1e9:.2f} GB/s); {back / 2 ** 20:.1f} MiB "
        f"of it scattered back (the rest still device-resident under the "
        f"tier's holds) in a resume of {t_in * 1e3:.2f} ms synchronised "
        f"({back / t_in / 1e9:.2f} GB/s); pages, logits and positions "
        f"bit-equal to the twin's, no token re-prefilled, the next window "
        f"bit-equal on every slot")


def log_chaos(r, guard, res5_wall, res5_tp):
    """Phase 15's numbers, beside phase 5's serve of the same requests."""
    eng, st = r["engine"], r["stats"]
    tokens = sum(len(g) for g in eng.generated.values())
    outs = r["outs"]
    out_ms = [t * 1e3 for t, _, _ in outs]
    bb = block_bytes(eng)
    reasons = {}
    for sh in st["shed"]:
        reasons[sh.reason] = reasons.get(sh.reason, 0) + 1
    log(f"chaos serve: {r['wall']:.2f} s, {tokens / r['wall']:.1f} tokens/s"
        f" ({st['served']} served, shed {reasons}; phase 5: "
        f"{res5_wall} s, {res5_tp} tokens/s); {eng.decode_steps} steps in "
        f"{r['windows']} decode windows of {eng.windows}; fired "
        f"{r['inj'].fired}")
    log(f"chaos counters: " + json.dumps({n: getattr(eng, n) for n in (
        "evictions", "quarantined", "deadline_misses", "stall_ticks",
        "swap_outs", "swap_ins", "swapped_blocks", "swap_reused_blocks",
        "swapped_ctx_tokens", "reprefilled_swapped_tokens",
        "requeue_prefix_hits", "prefill_dispatches", "prefill_tokens",
        "graph_captures")}) + f", injector {r['inj'].counters()}")
    log(f"chaos host syncs {st['host_syncs']} = {r['windows']} decode "
        f"windows + {guard} NaN-guard readbacks + "
        f"{sum(s for _, s, _ in outs)} swap-out readbacks "
        f"({len(outs)} swap-outs)")
    if outs:
        blocks = sum(b for _, _, b in outs)
        log(f"chaos swap-outs: host ms each {[round(m, 2) for m in out_ms]}"
            f" (device work queued ahead of each: {r['queued']}), mean {statistics.mean(out_ms):.2f} ms for "
            f"{blocks / len(outs) * bb / 2 ** 20:.1f} MiB an image "
            f"({blocks * bb / 1e9 / (sum(out_ms) / 1e3):.2f} GB/s); "
            f"resumes: {eng.swap_in_s * 1e3 / max(1, eng.swap_ins):.2f} host "
            f"ms each to enqueue; pinned tier "
            f"{eng.swap._store.nbytes / 2 ** 30:.2f} GiB "
            f"({CHAOS_SWAP_BLOCKS} blocks of {bb / 2 ** 20:.2f} MiB), "
            f"pinned when the engine was built, which took "
            f"{r['build_s']:.2f} s")


def log_streams(cmps):
    """Phase 15's check 4, each comparison of ``compare_streams``."""
    for label, (same, restarted, other, unexplained) in cmps:
        log(f"chaos streams against the unfaulted serve's, {label}: "
            f"{same} equal; differ: {len(restarted)} restarted "
            f"(re-prefilled; requests {restarted}), {len(other)} with "
            f"another KV lineage than unfaulted (the wave's rows or "
            f"suffix bucket, or the waves that wrote its cached prefix; "
            f"requests {other}), {len(unexplained)} with the same lineage "
            f"(requests {unexplained})")


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

def dense_recorders(transformer, layers):
    """Recorders of the dense model's layer-0 attention inputs: every
    prefill (one per batch) and every ``DECODE_SAMPLE``-th decode step of
    each batch, with the step's layer-0 cache cloned, up to
    ``KEEP_BYTES`` in all."""
    left = [KEEP_BYTES]

    def afford(*ts):
        n = sum(t.nbytes for t in ts)
        if n > left[0]:
            return False
        left[0] -= n
        return True

    def keep_prefill(q, k, v, *, causal=True, window=None):
        check(causal and window is None,
              "the served model is causal without a window")
        decode.restart()                      # a new batch
        return (q, k, v) if afford(q, k, v) else None

    def keep_decode(q, kc, vc, lengths):
        if afford(kc, vc):
            return q[:, 0].clone(), kc.clone(), vc.clone(), lengths.clone()
        return None

    prefill = Recorder(transformer, "gqa_prefill_attention", layers,
                       keep_prefill)
    decode = Recorder(transformer, "gqa_decode_attention", layers,
                      keep_decode, every=DECODE_SAMPLE, snap=(0, 3))
    return prefill, decode


def check_captures(label, engine, results, rep, steps):
    """A padded serve captured its decode step once per batch of at least
    ``MIN_GRAPH_STEPS`` steps, and replayed every step of those batches
    but the first (the capture's warm-up step, run eagerly)."""
    from repro_torch.serving.engine import MIN_GRAPH_STEPS
    graphed = [r for r in results if r.iterations >= MIN_GRAPH_STEPS]
    check(engine.graph_captures == len(rep.captures) == len(graphed),
          f"{label}: {engine.graph_captures} captures for {len(graphed)} "
          f"batches of at least {MIN_GRAPH_STEPS} steps")
    check(rep.replayed_steps == sum(r.iterations - 1 for r in graphed),
          f"{label}: {rep.replayed_steps} replayed steps")
    rep.log(label, steps)


def profile_dense_window(torch, engine, reqs, bl, cache_len, steps=8,
                         label="padded", kernel="decode_split_kernel"):
    """Where a padded decode step's time goes on the card: prefill one
    batch of the serve's shape (its rows and lengths, random prompt ids)
    and copy its state; capture the decode step on the batch's state as
    ``serve_batch`` does (the warm-up step is the first step), and decode
    the copy eagerly with ``decode_multi``; hold the first ``steps``-step
    windows bit for bit (tokens, logits, positions, cache); then time and
    profile windows of ``steps`` steps through each (:func:`window_profile`:
    host ms, device busy ms and idle share a step, the readback
    included).  Returns {"graphed": ..., "eager": ...}."""
    from repro_torch.models import model as M
    from repro_torch.serving.graphs import DecodeGraph
    cfg, params, dtype = engine.cfg, engine.params, engine.dtype
    gen = torch.Generator(device="cuda").manual_seed(3)
    lengths = torch.tensor([min(r.length, bl) for r in reqs],
                           dtype=torch.int32, device="cuda")
    tokens = torch.randint(3, cfg.vocab_size, (len(reqs), bl), generator=gen,
                           device="cuda", dtype=torch.int32)
    logits, cache = M.prefill(params, cfg, {"tokens": tokens,
                                            "lengths": lengths},
                              act_dtype=dtype, cache_len=cache_len)
    eager = {"cache": {key: tuple(t.clone() for t in leaves)
                       for key, leaves in cache.items()},
             "logits": logits.clone(), "positions": lengths.clone()}

    def run_eager():
        e = eager
        e["logits"], e["cache"], e["positions"], toks = M.decode_multi(
            params, cfg, e["cache"], {"logits": e["logits"],
                                      "positions": e["positions"]},
            num_steps=steps, act_dtype=dtype)
        e["toks"] = toks.cpu()
        return steps

    graph = DecodeGraph.padded(params, cfg, cache, logits, lengths,
                               act_dtype=dtype, max_steps=steps,
                               stream=torch.cuda.Stream())
    toks = graph.window(steps, 1).cpu()
    run_eager()
    same = (torch.equal(toks, eager["toks"])
            and torch.equal(graph.state["logits"], eager["logits"])
            and torch.equal(graph.state["positions"], eager["positions"])
            and all(torch.equal(a, b) for key, leaves in cache.items()
                    for a, b in zip(leaves, eager["cache"][key])))
    check(same, f"{label}: graphed and eager windows differ")
    log(f"{label}: graphed and eager {steps}-step windows at {len(reqs)} "
        f"rows: tokens, logits, positions and cache bit-equal")

    def run_graphed():
        graph.window(steps).cpu()
        return steps

    where = f"decode window at {len(reqs)} rows, cache {cache_len}"
    return {"eager": window_profile(torch, run_eager,
                                    f"{label} eager {where}", kernel),
            "graphed": window_profile(torch, run_graphed,
                                      f"{label} graphed {where}", kernel)}


def log_profiles(label, profiles):
    log(f"{label}, graphed against eager: " + json.dumps(
        {mode: {key: round(v, 4) for key, v in m.items()}
         for mode, m in profiles.items()}))


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
    the mean time of one of the serve's launches.  A kernel that no
    single PyTorch call computes has no library time (null)."""
    mean = lambda xs: sum(xs) / len(xs)
    bound_by = {by for _, by in per["bound"]}
    row = {"ms": mean(per["ms"]), "plain_ms": mean(per["plain_ms"]),
           "library_ms": (mean(per["library_ms"]) if per["library_ms"]
                          else None),
           "bound_ms": mean([t for t, _ in per["bound"]]),
           "bound_by": bound_by.pop() if len(bound_by) == 1 else "bytes",
           "max_abs_err": max(e for e, _ in errs)}
    lib = ("none" if row["library_ms"] is None
           else f"{row['library_ms']:.4f}")
    log(f"time {name} over {len(errs)} served shapes (mean of per-shape "
        f"medians, CUDA events, ms): kernel {row['ms']:.4f} (shapes "
        f"{min(per['ms']):.4f}-{max(per['ms']):.4f}), plain "
        f"{row['plain_ms']:.4f}, library {lib}, bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']}; by shape "
        f"{sorted({by for _, by in per['bound']})}); max abs err "
        f"{row['max_abs_err']:.3e} at output scale up to "
        f"{max(sc for _, sc in errs):.1f}")
    return row


# ---------------------------------------------------------------------------
# phases 9-13: the SSM family and the int8 decode cache
# ---------------------------------------------------------------------------

def scan_inputs(torch, b, s, h, p, n, gen):
    """The reference test's distributions: x, b, c unit normal, dt =
    softplus(normal) > 0, a = -exp(normal) < 0."""
    f = dict(device="cuda", generator=gen)
    x = torch.randn(b, s, h, p, **f)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, **f))
    a = -torch.exp(torch.randn(h, **f))
    return x, dt, a, torch.randn(b, s, n, **f), torch.randn(b, s, n, **f)


def scan_err(got, want):
    """(max abs error, output scale) of a scan's (y, state) pair."""
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    scale = max(w.abs().max().item() for w in want)
    return err, scale


def ssm_int8_kernel_checks(torch, sops, sref, dops, dref, quant):
    """The scan at mamba2-780m's shapes against both plain versions: the
    chunked one at 2e-4 of the output's scale (f32 in 3xTF32 on the
    tensor cores; the kernel sums the cumulative log-decay and the dot
    products in another order), the per-token recurrence at the
    reference's 5e-3; through the wrapper, then at each P slice, with the
    C.B^T scratch held against c @ b^T on its lower triangle at 2e-4 of
    its scale.  The int8 decode at chatglm-6b's heads (32/32, D 128) and
    a GQA shape (40/8), f32 and bf16 queries, caches quantised with the
    model's ``_quant_i8``; then int8 extremes and NaN and inf scales past
    every row's length, which must change nothing."""
    from repro_torch.kernels.ssd_scan import kernel as skernel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    for b, s in ((1, 256), (8, 256), (1, 200), (8, 200)):
        args = scan_inputs(torch, b, s, 48, 64, 128, gen)
        n0 = sops.ssd_scan.launches
        outs = {"wrapper": sops.ssd_scan(*args, 128)}
        check(sops.ssd_scan.launches == n0 + 1, "ssd_scan did not launch")
        scratch = torch.full(skernel.scratch_shape(b, s, 128), float("nan"),
                             device="cuda")
        for pt in skernel.P_TILES:
            outs[f"P slice {pt}"] = skernel.ssd_scan_kernel(
                *args, chunk=128, p_tile=pt, scratch=scratch)
        chunked = sref.ssd_chunked_ref(*args, 128)
        naive = sref.ssd_scan_ref(*args)
        torch.cuda.synchronize()
        for how, out in outs.items():
            check(all(torch.isfinite(t).all().item() for t in out),
                  f"ssd_scan B={b} S={s} {how}: non-finite output")
            err, scale = scan_err(out, chunked)
            err_naive, _ = scan_err(out, naive)
            log(f"kernel ssd_scan mamba2-780m B={b} S={s} {how}: max_abs_err"
                f" {err:.3e} against the chunked version at scale "
                f"{scale:.1f} (tol {SCAN_TOL} of scale), {err_naive:.3e} "
                f"against the recurrence (tol 5e-3)")
            check(err <= SCAN_TOL * max(1.0, scale), f"ssd_scan B={b} S={s} "
                  f"{how}: err {err} at scale {scale}")
            check(err_naive <= 5e-3, f"ssd_scan B={b} S={s} {how}: err "
                  f"{err_naive} against the recurrence")
        bb, cc = args[3], args[4]
        for z in range(-(-s // 128)):
            m = min(128, s - z * 128)
            rows = slice(z * 128, z * 128 + m)
            want = torch.tril(cc[:, rows] @ bb[:, rows].transpose(1, 2))
            err = (torch.tril(scratch[:, z, :m, :m]) - want).abs().max().item()
            scale = want.abs().max().item()
            check(err <= SCAN_TOL * max(1.0, scale), f"ssd_scan B={b} S={s}: "
                  f"C.B^T scratch of chunk {z} err {err} at scale {scale}")
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    shapes = [("chatglm-6b", 16, 512, 32, 32, 128,       # b, s, hq, hkv, d
               cycle([1, 17, 31, 32, 33, 200, 511, 512], 16)),
              ("gqa 40/8", 8, 512, 40, 8, 128,
               [512, 13, 256, 1, 77, 300, 500, 64])]
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, s, hq, hkv, d, lengths in shapes:
            q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dtype)
            (kq, ks), (vq, vs) = (
                quant(torch.randn(b, s, hkv, d, generator=gen,
                                  device="cuda")) for _ in range(2))
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            out = dops.decode_attention_int8(q, kq, vq, ks, vs, lens)
            want = dref.decode_attention_int8_ref(q, kq, vq, ks, vs, lens)
            for i, n in enumerate(lengths):
                kq[i, n:], vq[i, n:] = 127, -128
                ks[i, n:], vs[i, n:] = float("nan"), float("inf")
            poisoned = dops.decode_attention_int8(q, kq, vq, ks, vs, lens)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            change = (poisoned.float() - out.float()).abs().max().item()
            log(f"kernel decode_attention_int8 {name} S={s} q {dtype}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]}); int8 extremes "
                f"and NaN/inf scales past the lengths change it by "
                f"{change:.3e}")
            check(torch.isfinite(out).all().item(), f"int8 {name}: NaN")
            check(err <= tol[dtype], f"int8 {name} {dtype}: err {err}")
            check(change == 0.0, f"int8 {name}: poison past the lengths "
                  f"changed the output by {change}")


def _rel_errs(torch, got, want):
    return [((a.cpu().float() - c.float()).abs().max()
             / (1 + c.float().abs().max())).item()
            for a, c in zip(got, want)]


def ssm_int8_model_checks(torch, np, quant):
    """Reduced mamba2-780m (padded prefill, then a fused decode window)
    and reduced chatglm-6b's fused decode on an int8 cache (the CPU
    prefill's cache quantised, the same int8 cache on both sides), in
    f32 on the card against the CPU: logits and caches at 2e-4 of scale,
    tokens equal."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    b, s, steps = 3, 32, 6
    lengths = np.array([32, 17, 5])
    cfg = get_config("mamba2-780m").reduced()
    params_cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = rng.integers(3, cfg.vocab_size, size=(b, s))
    results = {}
    for dev in ("cpu", "cuda"):
        params = params_cpu if dev == "cpu" else _to(torch, params_cpu, dev)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                      device=dev)
        logits, cache = M.prefill(params, cfg, {"tokens": t(tokens),
                                                "lengths": t(lengths)},
                                  act_dtype=torch.float32)
        out = [logits.clone()] + [c.clone() for c in cache["ssm"]]
        logits, cache, _, toks = M.decode_multi(
            params, cfg, cache, {"logits": logits, "positions": t(lengths)},
            num_steps=steps, act_dtype=torch.float32)
        results[dev] = (out + [logits, *cache["ssm"]], toks.cpu())
    errs = _rel_errs(torch, results["cuda"][0], results["cpu"][0])
    same = torch.equal(results["cuda"][1], results["cpu"][1])
    log(f"model mamba2-780m reduced f32 card vs cpu: max rel err "
        f"{max(errs):.3e} (tol 2e-4) over prefill logits and state, the "
        f"logits and state after {steps} fused decode steps; tokens equal: "
        f"{same}")
    check(same, "mamba2 decode tokens differ between card and cpu")
    check(max(errs) <= 2e-4, f"mamba2 model card vs cpu: {errs}")

    cfg = get_config("chatglm-6b").reduced()
    cfg8 = dataclasses.replace(cfg, cache_int8=True)
    params_cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.as_tensor(rng.integers(3, cfg.vocab_size, size=(b, s)),
                             dtype=torch.int32)
    lens = torch.as_tensor(lengths, dtype=torch.int32)
    logits, fcache = M.prefill(params_cpu, cfg, {"tokens": tokens,
                                                 "lengths": lens},
                               act_dtype=torch.float32, cache_len=s + 16)
    (kq, ks), (vq, vs) = quant(fcache["kv"][0]), quant(fcache["kv"][1])
    results = {}
    for dev in ("cpu", "cuda"):
        params = params_cpu if dev == "cpu" else _to(torch, params_cpu, dev)
        cache = {"kv": tuple(x.to(dev, copy=True) for x in (kq, vq, ks, vs))}
        lg, cache, _, toks = M.decode_multi(
            params, cfg8, cache, {"logits": logits.to(dev),
                                  "positions": lens.to(dev)},
            num_steps=4, act_dtype=torch.float32)
        results[dev] = (lg.cpu(), [x.cpu() for x in cache["kv"]],
                        toks.cpu())
    (lg_g, c_g, t_g), (lg_c, c_c, t_c) = results["cuda"], results["cpu"]
    err = _rel_errs(torch, [lg_g], [lg_c])[0]
    i8 = max((a.int() - c.int()).abs().max().item()
             for a, c in zip(c_g[:2], c_c[:2]))
    sc = max(((a.float() - c.float()).abs() / c.float().abs().clamp(
        min=1e-30)).max().item() for a, c in zip(c_g[2:], c_c[2:]))
    log(f"model chatglm-6b reduced f32 int8-cache decode, card vs cpu: max "
        f"rel err {err:.3e} (tol 2e-4) over the logits after 4 fused steps;"
        f" new int8 values differ by at most {i8} (tol 1), scales by "
        f"{sc:.2e} relative (tol one bf16 step, 2**-7); tokens equal: "
        f"{torch.equal(t_g, t_c)}")
    check(torch.equal(t_g, t_c), "int8 decode tokens differ, card vs cpu")
    check(err <= 2e-4 and i8 <= 1 and sc <= 2 ** -7,
          f"int8 model card vs cpu: {err}, {i8}, {sc}")


def ssm_serve(torch, ssm_module, hbm, reset_counts, counts):
    """Phase 11: mamba2-780m at full width in bf16 through
    ``run_engine_backend`` (``magnus``, the padded ``BatchEngine``) on
    phase 7's 64 Poisson requests, with the launch counts zeroed just
    before and read just after.  Returns (the launch counts, the kept
    layer-0 scan inputs, one per batch)."""
    from repro_torch.launch.serve import run_engine_backend
    from repro_torch.workload.generator import poisson_workload
    reqs = poisson_workload(8, 60, seed=0, max_len=DENSE_MAX_LEN,
                            max_gen=DENSE_MAX_GEN)[:DENSE_N_REQUESTS]
    targets = {r.req_id: min(r.gen_length, DENSE_MAX_GEN) for r in reqs}
    t0 = time.perf_counter()
    with Recorder(ssm_module, "ssd_scan", 48) as scans, replays() as rep:
        reset_counts()
        res = run_engine_backend(
            "mamba2-780m", 0.0, 0.0, "magnus", seed=0, reduced=False,
            device="cuda", dtype=torch.bfloat16, hbm_bytes=hbm,
            max_len=DENSE_MAX_LEN, max_gen=DENSE_MAX_GEN, requests=reqs)
        launches = counts("launches")
    plain = counts("plain_calls")
    engine, results = res.pop("engine"), res.pop("results")
    log(f"SSM padded serve mamba2-780m full width bf16 magnus: "
        f"{time.perf_counter() - t0:.1f} s with set-up; " + json.dumps(res))
    log(f"SSM padded serve batches (size, batch length, G(B), host "
        f"syncs): " + "; ".join(
            f"({r.batch_size}, {r.batch_length}, {r.iterations}, "
            f"{bin(r.iterations).count('1')})" for r in results))
    log(f"SSM padded serve kernel launches {launches}, plain calls {plain}")
    cfg = engine.cfg
    check((cfg.num_layers, cfg.d_model, cfg.ssm.d_inner(cfg.d_model),
           cfg.ssm.n_heads(cfg.d_model), cfg.ssm.d_state,
           cfg.padded_vocab) == (48, 1536, 3072, 48, 128, 51200),
          "the SSM serve did not run mamba2-780m at full width")
    check(res["requests"] == DENSE_N_REQUESTS,
          f"{res['requests']} of {DENSE_N_REQUESTS} requests served")
    check(sorted(rid for r in results for rid in r.generated)
          == sorted(targets), "the SSM batches did not serve each request "
          "once")
    for r in results:
        check(r.iterations == max(targets[i] for i in r.generated),
              f"an SSM batch ran {r.iterations} iterations, not its G(B)")
        for rid, toks in r.generated.items():
            check(len(toks) == targets[rid],
                  f"request {rid}: {len(toks)} of {targets[rid]} tokens")
            check(all(0 <= x < cfg.vocab_size for x in toks),
                  f"request {rid}: token out of range")
    check(res["host_syncs"] == sum(bin(r.iterations).count("1")
                                   for r in results),
          f"SSM host syncs {res['host_syncs']}: not one per window")
    check(launches["ssd_scan"] == cfg.num_layers * len(results),
          f"ssd_scan launches {launches['ssd_scan']} != 48 x "
          f"{len(results)} batches")
    check(all(v == 0 for k, v in launches.items() if k != "ssd_scan"),
          f"the SSM serve launched an attention kernel: {launches}")
    check(not any(plain.values()), f"plain versions ran on the SSM path: "
          f"{plain}")
    check(len(scans.kept) == len(results),
          f"kept {len(scans.kept)} scans for {len(results)} batches")
    check_captures("SSM padded serve", engine, results, rep,
                   sum(r.iterations for r in results))
    big = max(results, key=lambda r: r.batch_size)
    log_profiles(f"SSM padded decode step at {big.batch_size} rows",
                 profile_dense_window(
                     torch, engine,
                     [r for r in reqs if r.req_id in big.generated],
                     big.batch_length, big.batch_length + big.iterations,
                     label="SSM padded", kernel=None))
    return launches, scans.kept


def int8_window(torch, np, transformer, dref, reset_counts, counts):
    """Phase 12: the reference's test_perf_knobs procedure at full width.
    chatglm-6b in bf16, a dense prefill of INT8_ROWS 2,048-token prompts
    into a 2,112-slot cache, that cache quantised layer by layer with the
    model's ``_quant_i8`` into ``init_cache(cfg_int8)``, then a fused
    decode of INT8_STEPS steps (1 + 63, to read the first step's logits)
    on the bf16 cache with ``cfg`` and on the int8 cache with
    ``cfg_int8``.  Held: the launch counts of both windows, no plain
    call, finite logits and tokens in range.

    Witnesses decode the first step again on copies of the caches with
    the model's attention replaced by plain torch: the port's int8
    formulation (``decode_attention_int8_ref``, dequantised in f32), the
    reference model's (the cache dequantised into bf16, then the float
    decode attention) and, as a control, the bf16 window's own
    (``decode_attention_ref``).  With random weights at full width each
    head's softmax is nearly one-hot, so a change in the last bits of
    one layer moves the top key in a few heads of later ones, and the
    first step's logits move by several hundredths of their scale: the
    control measures that for the accepted bf16 kernel.  No bound in
    units of the scale holds there, not even the reference's own 0.05
    of float, so the distances are held against each other (distance =
    max over the logits, over the second one's scale):
    - the int8 window from its plain formulation at most 2x the bf16
      window from its own: the int8 kernel moves the model no more than
      the bf16 kernel does;
    - the int8 window from the bf16 window at most 1.25x the reference's
      formulation from it: the port's int8 decode is no further from
      float than the reference's;
    - the int8 window from the reference's formulation at most half its
      distance from the bf16 window: closer to the reference's int8
      decode than to float.
    Returns (the int8 launch counts, the kept calls)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("chatglm-6b")
    cfg8 = dataclasses.replace(cfg, cache_int8=True)
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    rows, cl = INT8_ROWS, INT8_PROMPT + INT8_STEPS
    tokens = torch.as_tensor(rng.integers(3, cfg.vocab_size,
                                          size=(rows, INT8_PROMPT)),
                             dtype=torch.int32, device="cuda")
    lengths = torch.full((rows,), INT8_PROMPT, dtype=torch.int32,
                         device="cuda")
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, cfg, {"tokens": tokens,
                                            "lengths": lengths},
                              act_dtype=torch.bfloat16, cache_len=cl)
    cache8 = M.init_cache(cfg8, rows, cl, device="cuda")
    k8, v8, ks8, vs8 = cache8["kv"]
    for i in range(cfg.num_layers):
        k8[i], ks8[i] = transformer._quant_i8(cache["kv"][0][i])
        v8[i], vs8[i] = transformer._quant_i8(cache["kv"][1][i])
    torch.cuda.synchronize()
    nbytes = lambda ts: sum(t.nbytes for t in ts)
    log(f"int8 window set-up: prefill of {rows} x {INT8_PROMPT} tokens and "
        f"quantisation {time.perf_counter() - t0:.1f} s; weights "
        f"{nbytes(_leaves(params)) / 1e9:.2f} GB, bf16 cache "
        f"{nbytes(cache['kv']) / 1e9:.2f} GB, int8 cache "
        f"{nbytes(cache8['kv']) / 1e9:.2f} GB")

    def window(c, kv_cache):
        first, kv_cache, pos, t1 = M.decode_multi(
            params, c, kv_cache, {"logits": logits, "positions": lengths},
            num_steps=1, act_dtype=torch.bfloat16)
        last, kv_cache, pos, t2 = M.decode_multi(
            params, c, kv_cache, {"logits": first, "positions": pos},
            num_steps=INT8_STEPS - 1, act_dtype=torch.bfloat16)
        return first.float(), last, torch.cat([t1, t2], dim=1)

    def first_step(c, kv_cache, name, attention):
        """The first step's logits on a copy of ``kv_cache``, with the
        model's attention entry point ``name`` replaced by ``attention``
        (plain torch, counted nowhere)."""
        kv = {"kv": tuple(x.clone() for x in kv_cache["kv"])}
        orig = getattr(transformer, name)
        setattr(transformer, name, attention)
        try:
            out = M.decode_multi(params, c, kv, {
                "logits": logits, "positions": lengths}, num_steps=1,
                act_dtype=torch.bfloat16)[0]
        finally:
            setattr(transformer, name, orig)
        return out.float()

    def reference_attention(q, kc, vc, ks, vs, lengths):
        kd, vd = (x.to(torch.bfloat16) * sc[..., None]
                  for x, sc in ((kc, ks), (vc, vs)))
        return dref.decode_attention_ref(q, kd, vd, lengths)

    plain_first = first_step(cfg8, cache8, "decode_attention_int8",
                             dref.decode_attention_int8_ref)
    ref_first = first_step(cfg8, cache8, "decode_attention_int8",
                           reference_attention)
    bf16_plain_first = first_step(
        cfg, cache, "gqa_decode_attention",
        lambda q, kc, vc, n: dref.decode_attention_ref(q[:, 0], kc, vc,
                                                       n)[:, None])

    reset_counts()
    t0 = time.perf_counter()
    first, last, toks = window(cfg, cache)
    torch.cuda.synchronize()
    t_bf16 = time.perf_counter() - t0
    bf16_launches = counts("launches")
    del cache
    with Recorder(transformer, "decode_attention_int8", cfg.num_layers,
                  lambda *a: tuple(x.clone() for x in a),
                  every=DECODE_SAMPLE) as kept:
        reset_counts()
        t0 = time.perf_counter()
        first8, last8, toks8 = window(cfg8, cache8)
        torch.cuda.synchronize()
        launches = counts("launches")
    t_int8 = time.perf_counter() - t0
    plain = counts("plain_calls")
    agree = (toks8 == toks).float().mean().item()
    log(f"int8 window chatglm-6b full width bf16, {rows} rows, "
        f"{INT8_STEPS} steps: {t_bf16:.1f} s (bf16 cache), {t_int8:.1f} s "
        f"(int8 cache) on the host clock; greedy tokens agree at "
        f"{agree:.4f} of {toks.numel()}; launches bf16 window "
        f"{bf16_launches}, int8 window {launches}, plain calls {plain}")

    def dist(x, y):
        """(max over all logits, median over rows of each row's max) over
        y's scale, and the share of rows whose top logit agrees"""
        d = (x - y).abs().amax(dim=-1) / y.abs().max()
        same = (x.argmax(-1) == y.argmax(-1)).float().mean().item()
        text = (f"{d.max().item():.3e} (row median "
                f"{d.median().item():.3e}, top logit agrees in {same:.3f} "
                f"of rows)")
        return d.max().item(), text

    (i8_plain, t1), (control, t2), (i8_bf16, t3), (ref_bf16, t4), \
        (i8_ref, t5) = (dist(first8, plain_first),
                        dist(first, bf16_plain_first), dist(first8, first),
                        dist(ref_first, first), dist(first8, ref_first))
    log(f"int8 window first step's logits, distance over their scale "
        f"{first.abs().max().item():.2f}: int8 window from its formulation "
        f"in plain torch {t1}; control, the bf16 window from its own {t2}; "
        f"int8 window from the bf16 window {t3}; the reference's "
        f"formulation (bf16 dequantisation) from the bf16 window {t4}; int8 "
        f"window from the reference's formulation {t5}")
    n = cfg.num_layers * INT8_STEPS
    check(bf16_launches["decode_attention"] == n,
          f"bf16 window: {bf16_launches['decode_attention']} dense decode "
          f"launches, not {n}")
    check(launches["decode_attention_int8"] == n,
          f"int8 window: {launches['decode_attention_int8']} int8 "
          f"launches, not 28 x {INT8_STEPS}")
    check(launches["decode_attention"] == 0,
          "the int8 window launched the float decode kernel")
    check(not any(plain.values()), f"plain versions ran: {plain}")
    check(kept.steps == INT8_STEPS, f"recorded {kept.steps} int8 steps")
    check(i8_plain <= 2 * control, f"int8 window {i8_plain} from its plain "
          f"formulation, past 2x the bf16 window's {control}")
    check(i8_bf16 <= 1.25 * ref_bf16, f"int8 window {i8_bf16} from the bf16"
          f" window, past 1.25x the reference formulation's {ref_bf16}")
    check(i8_ref <= 0.5 * i8_bf16, f"int8 window {i8_ref} from the "
          f"reference's formulation, past half its {i8_bf16} from float")
    check(all(torch.isfinite(x).all().item() for x in (first8, last8)),
          "non-finite logits on the int8 cache")
    check(toks8.min().item() >= 0 and toks8.max().item() < cfg.vocab_size,
          "int8 window: token out of range")
    return launches, kept.kept


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def time_scan(torch, sops, sref, calls, spin):
    """The scan kernel on each batch's layer-0 prefill scan of the SSM
    serve, held against the chunked plain version at 2e-4 of scale.  No
    single PyTorch call computes the scan, so there is no library time.
    The bound counts x, dt, b, c, y and the state once, and the chunked
    algorithm's operations: per row and chunk of n rows C.B^T over the
    lower triangle once (n (n + 1) N), per head the weighted sum over x
    (n (n + 1) P), the carried-state term and the state update (2 n P N
    each), at the 989 TFLOP/s of every bound here.  The log gives each
    shape's time beside its B, its time at the P slice the wrapper did not
    pick, and the mean bound at the rate where the kernel computes (3xTF32:
    three tf32 products each, 495 / 3 TFLOP/s) and at the f32 CUDA cores'
    67 TFLOP/s."""
    from repro_torch.kernels.ssd_scan import kernel as skernel
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    errs, tf32x3, f32 = [], [], []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for x, dt, a, b, c, chunk in calls:
        bsz, s, h, p = x.shape
        n = b.shape[-1]
        kern = lambda r: sops.ssd_scan(x, dt, a, b, c, chunk)
        plain = lambda r: sref.ssd_chunked_ref(x, dt, a, b, c, chunk)
        err, scale = scan_err(kern(0), plain(0))
        check(all(torch.isfinite(t).all().item() for t in kern(0)),
              "ssd_scan: non-finite at the serve's inputs")
        check(err <= SCAN_TOL * max(1.0, scale),
              f"ssd_scan: err {err} at scale {scale} at the serve's inputs")
        errs.append((err, scale))
        per["ms"].append(median_ms(torch, kern, PREFILL_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, PREFILL_REPS, spin))
        pt = skernel.p_tile_for(bsz, h, p, sms)
        other = 32 if pt == 64 else 64
        other_ms = median_ms(
            torch, lambda r: skernel.ssd_scan_kernel(
                x, dt, a, b, c, chunk=chunk, p_tile=other),
            PREFILL_REPS, spin)
        lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
        flops = bsz * sum(m * (m + 1) * n + h * (m * (m + 1) * p
                                                 + 4 * m * p * n)
                          for m in lens)
        nbytes = 4 * (2 * x.numel() + dt.numel() + a.numel() + b.numel()
                      + c.numel() + bsz * h * p * n)
        per["bound"].append(bound(nbytes, flops))
        tf32x3.append(max(nbytes / HBM_BYTES_PER_S,
                          3 * flops / TF32_FLOPS) * 1e3)
        f32.append(max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3)
        log(f"time ssd_scan B={bsz} S={s}: kernel {per['ms'][-1]:.4f} ms "
            f"(P slice {pt}; slice {other}: {other_ms:.4f}), plain "
            f"{per['plain_ms'][-1]:.4f}, bound {per['bound'][-1][0]:.4f} "
            f"({per['bound'][-1][1]}), 3xTF32 bound {tf32x3[-1]:.4f}")
    mean = lambda xs: sum(xs) / len(xs)
    log(f"ssd_scan mean bound at the 3xTF32 rate (495 / 3 TFLOP/s) "
        f"{mean(tf32x3):.4f} ms, at the f32 rate of the CUDA cores (67 "
        f"TFLOP/s) {mean(f32):.4f} ms, instead of 989 TFLOP/s")
    return per, errs


def time_int8(torch, dops, dref, calls, spin):
    """The int8 kernel on each kept decode step of the int8 window (its
    layer-0 query, the int8 cache and scales as the step met them, the
    lengths).  Yardsticks on the cache dequantised to bf16: SDPA with a
    length mask on the cache cut to its longest row (``library_ms``), the
    dequantisation pass that SDPA's input needs (the int8 cache cut to the
    longest row, times its scales, to bf16 in SDPA's layout), timed apart
    so that the log gives "SDPA + dequantisation", the PyTorch route's
    whole cost; and the bf16 dense decode kernel, which reads twice the
    bytes.  The bound counts q and out, int8 K/V and their bf16 scales up
    to each row's length."""
    import torch.nn.functional as F
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    bf16_ms, deq_ms, errs = [], [], []
    for q, kc, vc, ks, vs, lens in calls:
        b, hq, d = q.shape
        _, s, hkv, _ = kc.shape
        check(hq == hkv, "the yardstick assumes the served model's MHA")
        kern = lambda r: dops.decode_attention_int8(q, kc, vc, ks, vs, lens)
        plain = lambda r: dref.decode_attention_int8_ref(q, kc, vc, ks, vs,
                                                         lens)
        errs.append(hold(torch, "decode_attention_int8", kern(0), plain(0)))
        per["ms"].append(median_ms(torch, kern, DECODE_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, DECODE_REPS, spin))
        kd, vd = ((x.float() * sc.float()[..., None]).to(q.dtype)
                  for x, sc in ((kc, ks), (vc, vs)))
        w = int(lens.max())
        kt, vt = (x[:, :w].transpose(1, 2).contiguous() for x in (kd, vd))
        deq = lambda r: [(x[:, :w].float() * sc[:, :w].float()[..., None])
                         .to(q.dtype).transpose(1, 2).contiguous()
                         for x, sc in ((kc, ks), (vc, vs))]
        deq(0)
        deq_ms.append(median_ms(torch, deq, DECODE_REPS, spin))
        mask = (torch.arange(w, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = lambda r: F.scaled_dot_product_attention(q4, kt, vt,
                                                       attn_mask=mask)
        lib(0)
        per["library_ms"].append(median_ms(torch, lib, DECODE_REPS, spin))
        dense = lambda r: dops.decode_attention(q, kd, vd, lens)
        dense(0)
        bf16_ms.append(median_ms(torch, dense, DECODE_REPS, spin))
        del kd, vd, kt, vt
        n_keys = int(lens.clamp(max=s).sum())
        nbytes = (2 * q.numel() * q.element_size() + 2 * n_keys * hkv * d
                  + 2 * n_keys * hkv * ks.element_size() + b * 4)
        per["bound"].append(bound(nbytes, 4 * d * hq * n_keys))
    mean = lambda xs: sum(xs) / len(xs)
    log(f"decode_attention (bf16 kernel) on the same rows dequantised to "
        f"bf16: {mean(bf16_ms):.4f} ms (mean of per-shape medians over "
        f"{len(bf16_ms)} shapes); the dequantisation pass SDPA's input "
        f"needs {mean(deq_ms):.4f} ms, so SDPA + dequantisation "
        f"{mean(per['library_ms']) + mean(deq_ms):.4f} ms")
    return per, errs


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
        build_report(build, lib)

        # 3. kernels against their plain versions
        from repro_torch.kernels.decode_attention import ops, ref
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.flash_attention import ref as fref
        from repro_torch.kernels.ssd_scan import ops as sops
        from repro_torch.kernels.ssd_scan import ref as sref
        from repro_torch.models import ssm as ssm_module
        from repro_torch.models import transformer
        kernel_checks(torch, ops, ref)
        dense_kernel_checks(torch, fops, fref, ops, ref)
        all_kernels = ops.KERNELS + fops.KERNELS + sops.KERNELS

        def reset_counts():
            ops.reset_counts()
            fops.reset_counts()
            sops.reset_counts()

        def counts(attr):
            return {fn.__name__: getattr(fn, attr) for fn in all_kernels}

        # 4. the paged and dense models on the card against the CPU
        model_check(torch, np)
        dense_model_check(torch, np)

        # 9-10. the SSD scan and int8 decode kernels, then their models
        ssm_int8_kernel_checks(torch, sops, sref, ops, ref,
                               transformer._quant_i8)
        ssm_int8_model_checks(torch, np, transformer._quant_i8)

        # 5. serve chatglm-6b at full width through the paged engine
        from repro_torch.launch.serve import (run_engine_backend,
                                              run_paged_engine_backend)
        from repro_torch.workload.apps import make_shared_head_dataset
        reqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                        gen_length=GEN_LENGTH, seed=0)
        t0 = time.perf_counter()
        decoded, waves = paged_recorders(transformer, 28)
        with decoded, waves, replays(decoded) as windows:
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
        log(f"serve kernel launches {launches}, plain calls {plain_calls}, "
            f"{windows.windows} decode windows, {engine.graph_captures} "
            f"capture(s) of the decode step")
        windows.log("paged serve", engine.decode_steps)
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
        check(engine.graph_captures == 1
              and windows.replayed_steps == engine.decode_steps - 1,
              f"{engine.graph_captures} captures of the decode step and "
              f"{windows.replayed_steps} replayed steps of "
              f"{engine.decode_steps}: not one capture, whose warm-up step "
              f"is the first step, and replays for the rest")
        check(launches["paged_decode_attention"]
              == cfg.num_layers * engine.decode_steps
              and launches["paged_prefix_prefill_attention"]
              == cfg.num_layers * engine.prefill_dispatches,
              f"launches {launches} against {engine.decode_steps} steps "
              f"and {engine.prefill_dispatches} waves")
        check(res["host_syncs"] == windows.windows,
              f"{res['host_syncs']} host syncs in {windows.windows} "
              f"windows: not one readback a window")
        for r in reqs:
            toks = engine.generated[r.req_id]
            check(len(toks) == min(r.gen_length, SERVE["max_gen"]),
                  f"request {r.req_id}: {len(toks)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in toks),
                  f"request {r.req_id}: token out of range")
        check(torch.isfinite(engine.logits.float()).all().item(),
              "non-finite logits after serving")
        check(len(decoded.kept) * cfg.num_layers
              == launches["paged_decode_attention"]
              and len(waves.kept) * cfg.num_layers
              == launches["paged_prefix_prefill_attention"],
              f"recorded {len(decoded.kept)} decode steps and "
              f"{len(waves.kept)} waves against launches {launches}")
        log("serve waves (rows, bucket, table width, prefix_lens, "
            "suffix_lens): " + "; ".join(
                f"{tuple(q.shape[:2])} {t.shape[1]} {pl.tolist()} "
                f"{sl.tolist()}" for q, _, _, t, pl, sl in waves.kept))
        served = {"streams": [engine.generated[r.req_id] for r in reqs],
                  "launches": launches, "windows": windows.windows,
                  "host_syncs": res["host_syncs"],
                  "steps": engine.decode_steps,
                  "waves": engine.prefill_dispatches}
        profile_window(torch, engine, make_shared_head_dataset(
            SERVE["max_concurrency"], n_apps=3, gen_length=GEN_LENGTH,
            seed=1))
        pages = engine.pages
        res5 = {k: res[k] for k in ("wall_s", "token_tp")}
        del engine, res, windows   # the recorder holds the pools' views
        torch.cuda.empty_cache()

        # 14. phase 5's serve on an engine warmed up ahead of time
        wreqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                         gen_length=GEN_LENGTH, seed=0)
        w = warmed_serve(torch, wreqs, reset_counts, counts)
        wengine = w.pop("engine")
        check(w["captures"] == (1, 1),
              f"captures before and after the warmed serve: "
              f"{w['captures']}, not (1, 1)")
        check(w["stats"]["served"] == N_REQUESTS,
              f"warmed serve finished {w['stats']['served']} requests")
        check([wengine.generated.get(r.req_id) for r in wreqs]
              == served["streams"],
              "the warmed serve's streams differ from phase 5's")
        check(w["launches"] == served["launches"]
              and not any(w["plain_calls"].values()),
              f"warmed serve launches {w['launches']}, plain calls "
              f"{w['plain_calls']}; phase 5: {served['launches']}")
        check(wengine.decode_steps == served["steps"]
              == w["replayed_steps"]
              and w["launches"]["paged_decode_attention"]
              == 28 * served["steps"],
              f"warmed serve: {wengine.decode_steps} steps, "
              f"{w['replayed_steps']} replayed; phase 5: {served['steps']}")
        check(w["stats"]["host_syncs"] == w["windows"]
              == served["host_syncs"],
              f"warmed serve: {w['stats']['host_syncs']} host syncs in "
              f"{w['windows']} windows; phase 5: {served['host_syncs']}")
        wengine.assert_drained()
        log("warmed serve: streams, steps, windows, host syncs and "
            "launches equal phase 5's, no capture during the serve")
        graphed = profile_window(torch, wengine, make_shared_head_dataset(
            SERVE["max_concurrency"], n_apps=3, gen_length=GEN_LENGTH,
            seed=1), eager=True)
        log_profiles("decode step at 32 rows", graphed)
        streams5 = served["streams"]
        sched5 = {k: served[k] for k in ("steps", "waves", "host_syncs")}
        del wengine, w, served
        torch.cuda.empty_cache()

        # 6. paged timings at the serve's shapes
        spin = spin_ms(torch)
        log(f"spin kernel: {spin:.2f} ms")
        t = {"paged_decode_attention": summarize(
                 "paged_decode_attention", *time_decode(
                     torch, ops, ref, decoded.kept, pages["k"],
                     pages["v"], spin)),
             "paged_prefix_prefill_attention": summarize(
                 "paged_prefix_prefill_attention", *time_prefill(
                     torch, ops, ref, waves.kept, pages["k"],
                     pages["v"], spin))}
        paged_launches = launches
        del pages, decoded, waves
        torch.cuda.empty_cache()

        # 7. serve chatglm-6b at full width through the padded BatchEngine
        from repro_torch.workload.generator import poisson_workload
        dreqs = poisson_workload(8, 60, seed=0, max_len=DENSE_MAX_LEN,
                                 max_gen=DENSE_MAX_GEN)[:DENSE_N_REQUESTS]
        targets = {r.req_id: min(r.gen_length, DENSE_MAX_GEN) for r in dreqs}
        hbm = torch.cuda.get_device_properties(0).total_memory
        t0 = time.perf_counter()
        dprefill, ddecode = dense_recorders(transformer, 28)
        with dprefill, ddecode, replays(ddecode) as drep:
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
        check(ddecode.steps == steps,
              f"recorded {ddecode.steps} decode steps, not {steps}")
        check_captures("padded serve", dengine, results, drep, steps)
        check(not any(dplain.values()),
              f"plain versions ran on the padded path: {dplain}")
        kept = sum(t.nbytes for c in dprefill.kept + ddecode.kept for t in c)
        log(f"padded serve kept {len(dprefill.kept)} prefills and "
            f"{len(ddecode.kept)} decode steps ({kept / 2 ** 30:.2f} GiB)")
        big = max(results, key=lambda r: r.batch_size)
        log_profiles(f"padded decode step at {big.batch_size} rows",
                     profile_dense_window(
                         torch, dengine,
                         [r for r in dreqs if r.req_id in big.generated],
                         big.batch_length, 1 << (big.batch_length
                                                 + big.iterations
                                                 - 1).bit_length()))
        del dengine, dres, results, drep   # drep: the last batch's cache
        torch.cuda.empty_cache()

        # 8. padded timings at the serve's shapes
        t["flash_attention"] = summarize(
            "flash_attention", *time_flash(torch, fops, fref,
                                           dprefill.kept, spin))
        t["decode_attention"] = summarize(
            "decode_attention", *time_dense_decode(torch, ops, ref,
                                                   ddecode.kept, spin))
        del dprefill, ddecode
        torch.cuda.empty_cache()

        # 11. serve mamba2-780m at full width through the padded
        # BatchEngine, on phase 7's requests
        slaunches, scans = ssm_serve(torch, ssm_module, hbm, reset_counts,
                                     counts)
        torch.cuda.empty_cache()

        # 12. an int8 decode window of chatglm-6b at full width
        i8launches, i8calls = int8_window(torch, np, transformer, ref,
                                          reset_counts, counts)
        torch.cuda.empty_cache()

        # 13. timings of the scan and the int8 kernel at the kept inputs
        t["ssd_scan"] = summarize(
            "ssd_scan", *time_scan(torch, sops, sref, scans, spin))
        t["decode_attention_int8"] = summarize(
            "decode_attention_int8", *time_int8(torch, ops, ref, i8calls,
                                                spin))
        del scans, i8calls
        torch.cuda.empty_cache()

        # 15. the chaos serve: the lifecycle and the host swap tier
        from repro_torch.models import model as M
        cparams = M.init_params(cfg, seed=0, device="cuda",
                                dtype=torch.bfloat16)   # phase 5's weights
        t0 = time.perf_counter()
        chaos = chaos_serve(torch, cfg, cparams, "cuda", torch.bfloat16,
                            reset_counts, counts)
        log(f"chaos serve chatglm-6b full width bf16: "
            f"{time.perf_counter() - t0:.1f} s; launches "
            f"{chaos['launches']}, plain calls {chaos['plain_calls']}")
        guard = check_chaos(torch, chaos, cfg.num_layers)
        hold_chaos(torch, ops, ref, chaos)
        ceng = chaos["engine"]
        chaos16 = {"reqs": chaos["reqs"], "generated": ceng.generated,
                   "shapes": chaos["shapes"], "sheds": shed_list(chaos),
                   "counters": {n: getattr(ceng, n) for n in (
                       "decode_steps", "prefill_dispatches", "evictions",
                       "quarantined", "deadline_misses", "stall_ticks",
                       "swap_outs", "swap_ins", "swapped_blocks",
                       "host_syncs")}}
        log_chaos(chaos, guard, res5["wall_s"], res5["token_tp"])
        del chaos, ceng
        torch.cuda.empty_cache()
        quarantine_check(torch, cfg, cparams, "cuda", torch.bfloat16)
        torch.cuda.empty_cache()
        swap_roundtrip_check(torch, cfg, cparams, "cuda", torch.bfloat16)
        del cparams
        torch.cuda.empty_cache()
        shapes5, cmp32, wall32 = f32_witness(torch, cfg, reset_counts,
                                             counts, sched5, chaos16)
        cmp16 = compare_streams(chaos16["reqs"], chaos16["generated"],
                                chaos16["shapes"], reqs, streams5, shapes5)
        log_streams([("bf16 (phase 5's)", cmp16),
                     ("f32 (the witness)", cmp32)])
        log(f"f32 witness: chaos serve {wall32:.2f} s, counters and sheds "
            f"equal the bf16 chaos serve's")
        check(not cmp16[3], f"streams {cmp16[3]} differ from phase 5's "
              f"though their KV has phase 5's lineage")
        check(cmp32[0] == len(chaos16["generated"]),
              f"in f32, chaos streams {cmp32[1] + cmp32[2] + cmp32[3]} "
              f"differ from the unfaulted serve's")

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
                   dlaunches),
                  "decode_attention_int8":
                  ("src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:345",
                   i8launches),
                  "ssd_scan":
                  ("src/repro_torch/csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan/kernel.py:76",
                   slaunches)}
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
