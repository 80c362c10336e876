"""Time the SSD scan's backward kernel at ``chip_smoke.py``'s
``SCAN_BWD`` calls from several trees of the repository, in one process,
and split each call's device time by the CUDA kernels it runs.

    python scripts/ssd_scan_bwd_compare.py TREE [TREE ...]

Each TREE is the root of a checkout: this one (``.``), or an older
commit unpacked with ``git archive`` into a directory of its own.  The
trees are taken in the order given (parent, change, change, parent
compares two commits on the same card).  For each, every
``repro_torch`` module is dropped, the tree's package is imported from
``TREE/src`` and its kernels are built into ``TREE/build`` and loaded.
At each of ``SCAN_BWD``'s six calls (B, S, H, P, N, chunk and whether
the final state's gradient is given), on inputs drawn on the card from
seed 33 (the same for every tree), the tree's forward kernel writes the
chunk states and the C.B^T scratch, then its backward kernel
(``kernel.ssd_scan_bwd_kernel``) is timed: the median of
``chip_smoke.TRAIN_REPS`` CUDA-event times behind a spin, and one
profiled window of 5 calls under ``torch.profiler``, each CUDA kernel's
device ms a call (``chip_smoke.kernel_split``).  The outputs are held
against the first tree's: each output's largest difference over its
largest magnitude.

Prints the card's name and power limit first, then one JSON line per
tree.  Needs one CUDA card and the CUDA toolkit."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from chip_tools import use_tree  # noqa: E402

SEED = 33


def run_tree(torch, tree: str, spin: float, first: dict) -> dict:
    use_tree(tree)
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import kernel as skernel
    t0 = time.perf_counter()
    build.build()
    build.load_library()
    row = {"tree": tree, "build_s": round(time.perf_counter() - t0, 1),
           "calls": []}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for i, (b, s, h, p, n, chunk, given) in enumerate(cs.SCAN_BWD):
        args, dy, ds = cs.scan_bwd_inputs(torch, gen, b, s, h, p, n)
        ds = ds if given else None
        cb = torch.empty(skernel.scratch_shape(b, s, chunk), device="cuda")
        _, _, states = skernel.ssd_scan_kernel(*args, chunk=chunk,
                                               scratch=cb, with_states=True)
        bwd = lambda *_: skernel.ssd_scan_bwd_kernel(*args, dy, states, cb,
                                                     ds, chunk=chunk)
        got = bwd()
        torch.cuda.synchronize()
        diff = {}
        if i in first:
            for name, g, w in zip(cs.SCAN_BWD_NAMES, got, first[i]):
                scale = max(w.abs().max().item(), 1e-30)
                diff[name] = float(f"{(g - w).abs().max().item() / scale:.3e}")
        else:
            first[i] = [t.clone() for t in got]
        row["calls"].append({
            "call": [b, s, h, p, n, chunk, given],
            "ms": round(cs.median_ms(torch, bwd, cs.TRAIN_REPS, spin), 5),
            "kernels_ms": {k: round(v, 5) for k, v in
                           cs.kernel_split(torch, bwd).items()},
            "diff_vs_first_tree": diff})
        del args, dy, ds, cb, states, got
        torch.cuda.empty_cache()
    return row


def main() -> int:
    trees = sys.argv[1:] or ["."]
    import torch
    if not torch.cuda.is_available():
        print("ssd_scan_bwd_compare: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    spin = cs.spin_ms(torch)
    first: dict = {}
    for tree in trees:
        print(json.dumps(run_tree(torch, tree, spin, first)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
