"""Count the synchronising CUDA calls of the paged serves, and time them,
from several trees of the repository, in one process.

    python scripts/sync_compare.py TREE [TREE ...]

Each TREE is the root of a checkout: this one (``.``), or an older
commit unpacked with ``git archive`` into a directory of its own.  The
trees are taken in the order given (parent, change, change, parent
compares two commits on the same card).  For each, every
``repro_torch`` module is dropped, the tree's package is imported from
``TREE/src``, its kernels are loaded (the library of an identical
source hash is copied from the first tree's build, else built), and
chatglm-6b's weights are drawn in bf16 from seed 0 on the card.  Then,
each on a fresh engine warmed (its decode graph captured) ahead of time:

- ``serve``: ``chip_smoke.py`` phase 5's 48 requests at its geometry
  through ``drive_paged``, timed on the host clock (tokens/s over the
  generated tokens), with the detector off;
- ``serve_sync``: the same serve under ``chip_smoke.sync_detector``
  (``torch.cuda.set_sync_debug_mode("warn")``): the synchronising calls
  by innermost ``repro_torch`` frame, beside the engine's ``host_syncs``;
- ``chaos_sync``: phase 15's chaos plan, counted the same way.

Prints one JSON line per tree, and the card's name and power limit
first.  Needs one CUDA card and ~20 GB of device memory (one tree's
weights at a time)."""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from chip_tools import use_tree  # noqa: E402


def _load(build, built):
    """Load the tree's library, copying an identical build first."""
    lib = build.library_path()
    if not lib.exists() and lib.name in built:
        lib.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(built[lib.name], lib)
    build.load_library()
    built.setdefault(lib.name, str(lib))


def _serve(torch, E, cfg, params, reqs, detector=False, chaos=False):
    from repro_torch.serving.faults import FaultEvent, FaultInjector
    kw = dict(cs.SERVE, prefix_cache=True)
    inj = None
    if chaos:
        inj = FaultInjector(cs.chaos_plan(FaultEvent))
        kw = dict(cs.CHAOS, prefix_cache=True, faults=inj,
                  default_ttl=cs.CHAOS_TTL,
                  swap_blocks=cs.CHAOS_SWAP_BLOCKS)
    eng = E.PagedContinuousEngine(cfg, params, device="cuda",
                                  dtype=torch.bfloat16, warmup=True, **kw)
    torch.cuda.synchronize()
    det = cs.sync_detector(torch) if detector else None
    t0 = time.perf_counter()
    if det is not None:
        with det:
            st = E.drive_paged(eng, list(reqs), max_steps=100_000)
            torch.cuda.current_stream().query()
    else:
        st = E.drive_paged(eng, list(reqs), max_steps=100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if inj is not None:
        inj.release(eng.allocator)
    tokens = sum(len(t) for t in eng.generated.values())
    out = {"wall_s": wall, "tokens": tokens, "tok_s": tokens / wall,
           "served": st["served"], "host_syncs": eng.host_syncs}
    if det is not None:
        out["detector"] = len(det.records)
        out["by_line"] = sorted(
            ((str(r), det.records.count(r)) for r in set(det.records)),
            key=lambda kv: -kv[1])
    return out


def main(trees) -> None:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    built = {}
    for tree in trees:
        use_tree(tree)
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.models import model as M
        from repro_torch.serving import engine as E
        from repro_torch.workload.apps import make_shared_head_dataset
        _load(build, built)
        cfg = get_config("chatglm-6b")
        params = M.init_params(cfg, seed=0, device="cuda",
                               dtype=torch.bfloat16)
        reqs = make_shared_head_dataset(cs.N_REQUESTS, n_apps=3,
                                        gen_length=cs.GEN_LENGTH, seed=0)
        out = {"tree": tree, "src": E.__file__,
               "serve": _serve(torch, E, cfg, params, reqs),
               "serve_sync": _serve(torch, E, cfg, params, reqs,
                                    detector=True),
               "chaos_sync": _serve(torch, E, cfg, params, reqs,
                                    detector=True, chaos=True)}
        print(json.dumps(out), flush=True)
        del params, M, E
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
