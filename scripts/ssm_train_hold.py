"""Ground ``chip_smoke.py`` phase 24 (b)'s hold: run it at more than one
seed and show that it fails a wrong wiring of the scan's gradient.

For each seed, mamba2-780m and hymba-1.5b at full width cut to 2 layers
take one f32 train step on the CPU (f64 and f32), on the card through the
kernels and on the card through the plain versions, held as phase 24 (b)
holds them (``train_f32_hold`` against the card's plain-version step at
``TRAIN_F32_FACTOR``).  At the first seed the card's kernel step is then
run again with each planted fault in the wiring of the scan's backward
(``kernel.ssd_scan_bwd_kernel`` patched in this process, the repository's code
untouched), and held the same way: a fault the hold does not fail is
printed as such.  Phase 24 (a) runs first (the kernels against their
plain versions) and (e) last (their times).

    PYTHONPATH=src python scripts/ssm_train_hold.py [--seeds 0 1]

Prints one JSON object last: each (seed, model)'s verdict and its
largest ratio to the yardstick, and each fault's verdict.  Exits 1 if a
seed's hold fails, if a fault passes it, or if (a) fails."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def faults(torch):
    """{name: a function of the backward kernel's wrapper
    (``kernel.ssd_scan_bwd_kernel``) and its arguments that calls it once
    and returns its outputs (dx, ddt, da, db, dc) wired wrongly}."""
    def swap_bc(bwd, args, kw):
        dx, ddt, da, db, dc = bwd(*args, **kw)
        return dx, ddt, da, dc, db

    def no_inter(bwd, args, kw):
        # the chunk states read as zero: every term that carries the
        # state across a chunk boundary (into dc, ddt, da) dropped
        args = list(args)
        args[6] = torch.zeros_like(args[6])
        return bwd(*args, **kw)

    def no_da(bwd, args, kw):
        dx, ddt, da, db, dc = bwd(*args, **kw)
        return dx, ddt, torch.zeros_like(da), db, dc

    def no_ddt(bwd, args, kw):
        dx, ddt, da, db, dc = bwd(*args, **kw)
        return dx, torch.zeros_like(ddt), da, db, dc

    return {"db and dc swapped": swap_bc,
            "chunk states read as zero": no_inter,
            "da dropped": no_da, "ddt dropped": no_ddt}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    seeds = ap.parse_args().seeds
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    t0 = time.perf_counter()
    build.build()
    build.load_library()
    cs.log(f"build {time.perf_counter() - t0:.1f} s; "
           f"{torch.cuda.get_device_name(0)}")
    out, ok = {"seeds": {}, "faults": {}}, True
    try:
        out["a"] = cs.scan_kernel_checks(torch, sops, sref)
    except cs.SmokeFailure as e:
        cs.log(f"phase 24 (a) failed: {e}")
        return 1
    real = skernel.ssd_scan_bwd_kernel
    for seed in seeds:
        for arch in cs.SSM_TRAIN_ARCHS:
            label = f"phase 24 (b) {arch} seed {seed}"
            metrics, grads = cs.train_two_layer_steps(
                torch, fops, label, cs.train_f32_runs(torch, True),
                arch=arch, sops=sops, seed=seed)
            hold = ("cuda plain float32", cs.TRAIN_F32_FACTOR)
            try:
                ratio, where = cs.train_f32_hold(metrics, grads, arch, label,
                                                 *hold)
                verdict = "passed"
            except cs.SmokeFailure as e:
                ratio, where, verdict, ok = None, None, f"failed: {e}", False
            out["seeds"][f"{arch} seed {seed}"] = {
                "verdict": verdict, "largest ratio": ratio, "at": where}
            if seed != seeds[0]:
                continue
            for name, fault in faults(torch).items():
                skernel.ssd_scan_bwd_kernel = (
                    lambda *args, _f=fault, **kw: _f(real, args, kw))
                try:
                    m, g = cs.train_two_layer_steps(
                        torch, fops, f"{label}, {name}",
                        [("cuda", torch.float32, torch.float32, False)],
                        arch=arch, sops=sops, seed=seed)
                finally:
                    skernel.ssd_scan_bwd_kernel = real
                try:
                    cs.train_f32_hold({**metrics, **m}, {**grads, **g}, arch,
                                      f"{label}, fault {name}", *hold)
                    verdict, ok = "passed (the hold missed it)", False
                except cs.SmokeFailure as e:
                    verdict = f"failed: {e}"
                out["faults"][f"{arch}: {name}"] = verdict
            torch.cuda.empty_cache()
    out["e"] = cs.time_scan_train(torch, sops, sref, cs.spin_ms(torch))
    cs.log(f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
