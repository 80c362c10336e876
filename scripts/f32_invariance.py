#!/usr/bin/env python3
"""Does a token's f32 arithmetic depend on the batch that computes it?

    python3 scripts/f32_invariance.py                 # chatglm-6b, card
    python3 scripts/f32_invariance.py --device cpu --reduced

In f32 with TF32 off, on the paged path of the PyTorch port, it measures
where a speculative verify's arithmetic parts from a decode step's, once
in the default arithmetic and once inside ``model.batch_invariant()``:

1. products: rows of a 32-row product against the same rows inside a
   160-row one (a decode step's M against a W = 5 verify's), for each of
   chatglm-6b's weight shapes (attention, MLP in and out, LM head);
2. verify against decode: 32 rows of random prompts are prefilled, then
   decoded greedily for W = 5 steps; the same W tokens go through one
   ``verify_window`` from the pool as it stood before the steps.  Its W
   logit rows are held bit for bit against the steps' (rows that
   differ, the largest difference, greedy picks that differ), and the
   pools afterwards;
3. prefill split: the prompts prefilled in one wave, and again as a
   37-token prefix wave followed by the rest (a radix hit that ends
   inside a page): the last logits and the pools, bit for bit;
4. cost: one decode step and one verify window, CUDA events, median of
   5, in each arithmetic.

Prints one JSON object per line and, last, the card's name and power
limit."""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROWS, W, BT, PER, PREFIX = 32, 5, 16, 16, 37


def differ(a: torch.Tensor, b: torch.Tensor):
    """(rows that differ in any bit, the largest absolute difference)."""
    d = (a.double() - b.double()).abs().reshape(a.shape[0], -1)
    return int((d.amax(1) > 0).sum()), float(d.max())


def pools_differ(a, b) -> float:
    """Largest difference of two pools' K and V, past the null block."""
    return max(float((a[k][:, 1:] - b[k][:, 1:]).abs().max()) for k in a)


def sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def timed_ms(dev: str, fn) -> float:
    """Median of 5 calls, CUDA events on the card, else the host clock."""
    times = []
    for _ in range(5):
        if dev == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def products(dev: str, shapes, rows: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for k, n in shapes:
        x = torch.randn(rows * W, k, device=dev, generator=g)
        w = torch.randn(k, n, device=dev, generator=g) / k ** 0.5
        big = (x @ w).view(rows, W, n)
        worst = (0, 0.0)
        for j in range(W):
            d = differ(x.view(rows, W, k)[:, j].contiguous() @ w, big[:, j])
            worst = max(worst, d)
        out[f"{k}x{n}"] = {"rows_differ": worst[0],
                           "of": rows, "max_abs": worst[1]}
        del x, w, big
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="chatglm-6b cut to 2 layers, d_model 128")
    args = ap.parse_args()
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("chatglm-6b")
    rows = ROWS
    if args.reduced:
        cfg = cfg.reduced(num_layers=2, d_model=128)
        rows = 4
    d = cfg.d_model
    shapes = ((d, cfg.num_heads * cfg.head_dim), (d, cfg.d_ff),
              (cfg.d_ff, d), (d, cfg.padded_vocab))
    print(json.dumps({"products_32_vs_160_rows": products(dev, shapes,
                                                            rows)}),
          flush=True)

    params = M.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(1)
    nb = rows * PER + 1
    tables = (1 + torch.arange(rows * PER, device=dev, dtype=torch.int32)
              ).view(rows, PER)
    lens = torch.randint(60, 200, (rows,), device=dev, generator=g,
                         dtype=torch.int32)
    s = int(lens.max())
    toks = torch.randint(0, cfg.vocab_size, (rows, s), device=dev,
                         generator=g, dtype=torch.int32)
    zeros = torch.zeros_like(lens)
    slots = torch.arange(rows, device=dev, dtype=torch.int32)
    active = torch.ones(rows, dtype=torch.bool, device=dev)

    def wave(pages, tokens, plen, slen):
        st = {"tables": torch.zeros_like(tables), "positions": zeros.clone(),
              "active": active.clone(),
              "logits": torch.zeros(rows, cfg.padded_vocab, device=dev)}
        T.prefill_wave(params, cfg, pages, st, tokens=tokens, lengths=slen,
                       prefix_lens=plen, attn_tables=tables, tables=tables,
                       write_lens=slen, cow_src=zeros, cow_dst=zeros,
                       slots=slots, row_sel=slots, positions=plen + slen,
                       null_block=0, act_dtype=torch.float32)
        return st["logits"]

    for name, mode in (("default", contextlib.nullcontext),
                       ("batch_invariant", M.batch_invariant)):
        res = {"arithmetic": name}
        with mode():
            pa = T.init_paged_cache(cfg, nb, BT, dtype=torch.float32,
                                    device=dev)
            la = wave(pa, toks, zeros, lens)
            pb = T.init_paged_cache(cfg, nb, BT, dtype=torch.float32,
                                    device=dev)
            pre = torch.full_like(lens, PREFIX)
            wave(pb, toks[:, :PREFIX].contiguous(), zeros, pre)
            suffix = torch.zeros_like(toks)
            suffix[:, :s - PREFIX] = toks[:, PREFIX:]
            lb = wave(pb, suffix, pre, lens - PREFIX)
            res["prefill_split"] = {"logit_rows_differ": differ(la, lb),
                                    "pools_max_abs": pools_differ(pa, pb)}
            del pb
            saved = {k: v.clone() for k, v in pa.items()}
            tok = torch.argmax(la[:, :cfg.vocab_size], -1).to(torch.int32)
            steps, proposed = [], []
            for j in range(W):
                proposed.append(tok)
                lg, _ = T.decode_step_paged(params, cfg, pa, tok, lens + j,
                                            tables, act_dtype=torch.float32)
                steps.append(lg)
                tok = torch.argmax(lg[:, :cfg.vocab_size],
                                   -1).to(torch.int32)
            steps = torch.stack(steps, 1)
            after = {k: v.clone() for k, v in pa.items()}
            proposed = torch.stack(proposed, 1)

            def verify_all():
                """verify_window's W logit rows (its carry is one)."""
                for k in pa:
                    pa[k].copy_(saved[k])
                x = T._embed_in(params, proposed, torch.float32)
                wl = torch.full_like(lens, W)
                for i in range(cfg.num_layers):
                    bp = T._layer(params["blocks"], i)
                    h = T._norm(x, bp["norm1"], cfg.norm_eps)
                    y, _ = T._attention_prefill_suffix(
                        bp["attn"], h, cfg, pa["k"][i], pa["v"][i], tables,
                        lens, wl, write=(tables, wl, 0))
                    x = T._ffn(bp, x + y, cfg)
                return T._logits(params, cfg, x)

            rows_v = verify_all()
            # and the engine's own verify, whose carry is the last row
            for k in pa:
                pa[k].copy_(saved[k])
            carry, _, _, packed = T.verify_window(
                params, cfg, pa, proposed, la, lens, tables, active,
                torch.full_like(lens, W), null_block=0,
                act_dtype=torch.float32)
            picks = torch.argmax(rows_v[..., :cfg.vocab_size], -1)
            want = torch.argmax(steps[..., :cfg.vocab_size], -1)
            res["verify_vs_decode"] = {
                "logit_rows_differ": differ(rows_v.reshape(rows * W, -1),
                                            steps.reshape(rows * W, -1)),
                "of": rows * W,
                "picks_differ": int((picks != want).sum()),
                "carry_vs_last_step": differ(carry, steps[:, -1]),
                "accepted_per_row": packed[:, -1].float().mean().item(),
                "pools_max_abs": pools_differ(pa, after)}
            tok0 = proposed[:, 0]

            def one_step():
                T.decode_step_paged(params, cfg, pa, tok0, lens, tables,
                                    act_dtype=torch.float32)

            def one_verify():
                T.verify_window(params, cfg, pa, proposed, la, lens, tables,
                                active, torch.full_like(lens, W),
                                null_block=0, act_dtype=torch.float32)

            sync(dev)
            res["decode_step_ms"] = timed_ms(dev, one_step)
            res["verify_window_ms"] = timed_ms(dev, one_verify)
            del pa, saved, after
        print(json.dumps(res), flush=True)
    if dev == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
