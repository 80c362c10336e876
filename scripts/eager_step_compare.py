"""Time the padded path's eager decode step of chatglm-6b at full width
from several trees of the repository, in one process.

    python scripts/eager_step_compare.py TREE [TREE ...]

Each TREE is the root of a checkout: this one (``.``), or an older
commit unpacked with ``git archive`` into a directory of its own.  The
trees are taken in the order given (parent, change, change, parent
compares two commits on the same card).  For each, every
``repro_torch`` module is dropped, the tree's package is imported from
``TREE/src``, its kernels are built into ``TREE/build`` and loaded, and
chatglm-6b's weights are drawn in bf16 from seed 0 on the card.  Then,
at the shape of ``chip_smoke.py`` phase 7's largest batch (20 rows, a
256-token prompt bucket, a 512-slot cache; the lengths of the first 20
of phase 7's requests):

- ``fresh``: a prefill, then 8-step windows of the eager
  ``decode_multi``: timed on the host clock alone (the median of 3
  windows), timed and profiled with ``chip_smoke.window_profile`` (host
  ms, device busy ms and idle share a step), then timed alone again;
  before the tree has captured any graph in this process;
- ``phase7``: where the tree has the padded graph
  (``DecodeGraph.padded``), ``chip_smoke.profile_dense_window`` as phase
  7 runs it: the step captured on one batch's state and a copy decoded
  eagerly, the windows held bit for bit, then both profiled.

Prints one JSON line per tree, and the card's name and power limit
first.  Needs one CUDA card, the CUDA toolkit and ~30 GB of device
memory (one tree's weights at a time)."""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from chip_tools import use_tree  # noqa: E402

ROWS, BUCKET, CACHE_LEN, STEPS = 20, 256, 512, 8


def _fresh_eager(torch, M, cfg, params, lengths):
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(3, cfg.vocab_size, (ROWS, BUCKET), generator=gen,
                           device="cuda", dtype=torch.int32)
    logits, cache = M.prefill(params, cfg, {"tokens": tokens,
                                            "lengths": lengths},
                              act_dtype=torch.bfloat16, cache_len=CACHE_LEN)
    state = {"logits": logits, "cache": cache, "positions": lengths.clone()}

    def run():
        s = state
        s["logits"], s["cache"], s["positions"], toks = M.decode_multi(
            params, cfg, s["cache"], {"logits": s["logits"],
                                      "positions": s["positions"]},
            num_steps=STEPS, act_dtype=torch.bfloat16)
        toks.cpu()
        return STEPS

    run()                                   # first calls' loads
    out = {"host_ms_unprofiled": _host_ms(torch, run)}
    out.update(cs.window_profile(torch, run, f"fresh eager decode window "
                                 f"at {ROWS} rows, cache {CACHE_LEN}"))
    out["host_ms_after_profile"] = _host_ms(torch, run)
    return out


def _host_ms(torch, run, windows=3):
    """Median host ms a step over ``windows`` windows, no profiler."""
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / k)
    return statistics.median(times)


def main(trees) -> None:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for tree in trees:
        use_tree(tree)
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.models import model as M
        from repro_torch.serving import graphs
        from repro_torch.workload.generator import poisson_workload
        build.load_library()
        cfg = get_config("chatglm-6b")
        params = M.init_params(cfg, seed=0, device="cuda",
                               dtype=torch.bfloat16)
        reqs = poisson_workload(8, 60, seed=0, max_len=cs.DENSE_MAX_LEN,
                                max_gen=cs.DENSE_MAX_GEN)[:ROWS]
        lengths = torch.tensor([min(r.length, BUCKET) for r in reqs],
                               dtype=torch.int32, device="cuda")
        out = {"tree": tree, "src": M.__file__,
               "fresh": _fresh_eager(torch, M, cfg, params, lengths)}
        if hasattr(graphs.DecodeGraph, "padded"):
            engine = types.SimpleNamespace(cfg=cfg, params=params,
                                           dtype=torch.bfloat16)
            out["phase7"] = cs.profile_dense_window(
                torch, engine, reqs, BUCKET, CACHE_LEN, steps=STEPS)
        print(json.dumps(out), flush=True)
        del params, M, graphs
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
