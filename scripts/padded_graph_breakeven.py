"""Where capturing a padded batch's decode step starts to pay, on the card.

    PYTHONPATH=src python scripts/padded_graph_breakeven.py \
        [--arch chatglm-6b] [--rows 20] [--reps 3]

Serves one batch of ``rows`` requests (the first of ``chip_smoke.py``'s
padded traffic: a Poisson stream of prompts up to 256 tokens) at full
width in bf16 through ``BatchEngine.serve_batch``, at every G(B) from 1
to 8 (every request's generation length), once with the decode step
captured (``MIN_GRAPH_STEPS`` set to 1) and once eagerly (set above
G(B)), in turns, ``reps`` times.  Prints each G(B)'s median
``decode_time`` both ways (host clock, the capture and the readbacks
included) and the least G(B) from which the captured batch is the
faster.  Then times 8-step eager ``decode_multi`` windows on one
prefilled batch with no graph alive, with a graph captured on a copy of
the batch alive, and after that graph is dropped (host ms a step, the
readback included).  The last line is a JSON object of these numbers.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.types import Batch
from repro_torch.models import model as M
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.graphs import DecodeGraph
from repro_torch.workload.generator import poisson_workload

GENS = range(1, 9)
WINDOW = 8              # steps of each timed eager window
WINDOWS = 3             # timed windows a case


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "?"


def serve_times(eng, reqs, reps):
    """{G(B): {"graphed": [s], "eager": [s]}} of ``decode_time``."""
    out = {g: {"graphed": [], "eager": []} for g in GENS}
    for rep in range(reps):
        for g in GENS:
            for r in reqs:
                r.gen_length = g
            modes = ["graphed", "eager"]
            if (rep + g) % 2:
                modes.reverse()
            for mode in modes:
                engine_mod.MIN_GRAPH_STEPS = 1 if mode == "graphed" else g + 1
                captures = eng.graph_captures
                res = eng.serve_batch(Batch(requests=list(reqs)))
                if res.iterations != g or (eng.graph_captures - captures
                                           != (mode == "graphed")):
                    raise RuntimeError(f"G(B) {g} {mode}: {res.iterations} "
                                       f"steps, captures {captures} -> "
                                       f"{eng.graph_captures}")
                out[g][mode].append(res.decode_time)
    return out


def eager_window_ms(eng, state) -> float:
    """One eager ``WINDOW``-step window on ``state`` (advanced in place
    of its entries), host ms a step, ending in the readback."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, positions, toks = M.decode_multi(
        eng.params, eng.cfg, state["cache"],
        {"logits": state["logits"], "positions": state["positions"]},
        num_steps=WINDOW, act_dtype=eng.dtype)
    toks.cpu()
    state.update(logits=logits, cache=cache, positions=positions)
    return (time.perf_counter() - t0) * 1e3 / WINDOW


def eager_beside_graph(eng, reqs):
    """Median host ms a step of eager windows on one prefilled batch:
    before any graph, while a graph captured on a copy of the batch
    lives, and after it is dropped."""
    bl = 256
    lengths = torch.tensor([min(r.length, bl) for r in reqs],
                           dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(3, eng.cfg.vocab_size, (len(reqs), bl),
                           generator=gen, device="cuda", dtype=torch.int32)
    logits, cache = M.prefill(eng.params, eng.cfg,
                              {"tokens": tokens, "lengths": lengths},
                              act_dtype=eng.dtype, cache_len=512)
    state = {"cache": cache, "logits": logits, "positions": lengths.clone()}
    copy = ({key: tuple(t.clone() for t in leaves)
             for key, leaves in cache.items()}, logits.clone(),
            lengths.clone())
    eager_window_ms(eng, state)                       # warm
    out = {"no graph": [eager_window_ms(eng, state) for _ in range(WINDOWS)]}
    graph = DecodeGraph.padded(eng.params, eng.cfg, *copy,
                               act_dtype=eng.dtype, max_steps=WINDOW,
                               stream=torch.cuda.Stream())
    graph.window(WINDOW, 1).cpu()
    out["graph alive"] = [eager_window_ms(eng, state)
                          for _ in range(WINDOWS)]
    del graph, copy
    out["graph dropped"] = [eager_window_ms(eng, state)
                            for _ in range(WINDOWS)]
    return {k: statistics.median(v) for k, v in out.items()}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="chatglm-6b")
    ap.add_argument("--rows", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("padded_graph_breakeven: needs a CUDA card", file=sys.stderr)
        return 2
    print(card())
    eng = engine_mod.BatchEngine(get_config(args.arch), seed=0, max_gen=64,
                                 dtype=torch.bfloat16, device="cuda")
    reqs = poisson_workload(8, 60, seed=0, max_len=256,
                            max_gen=64)[:args.rows]
    for r in reqs:                                    # compile, warm
        r.gen_length = 4
    eng.serve_batch(Batch(requests=list(reqs)))
    times = serve_times(eng, reqs, args.reps)
    med = {g: {m: statistics.median(v) * 1e3 for m, v in t.items()}
           for g, t in times.items()}
    for g, m in med.items():
        print(f"{args.arch} {args.rows} rows, G(B) {g}: decode_time "
              f"graphed {m['graphed']:.1f} ms, eager {m['eager']:.1f} ms "
              f"(medians of {args.reps})")
    pays = next((g for g, m in med.items() if m["graphed"] < m["eager"]),
                None)
    print(f"capture pays from G(B) = {pays}")
    beside = eager_beside_graph(eng, reqs)
    print("eager window, host ms a step: " + "; ".join(
        f"{k} {v:.2f}" for k, v in beside.items()))
    print(json.dumps({"arch": args.arch, "rows": args.rows,
                      "decode_time_ms": med, "capture_pays_from": pays,
                      "eager_step_ms": beside}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
