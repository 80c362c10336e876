"""Run ``chip_smoke.py`` phase 24 alone: the SSD scan's backward kernel
and the forward's stored chunk states against their plain versions, one
full-width train step of mamba2-780m and of hymba-1.5b (cut to 2 layers)
on the card against the CPU, both trained uncut through
``repro_torch.launch.train`` (f32) and hymba-1.5b through
``trainer.train`` with bf16 activations, and the scan's forward and
backward timed at the training calls, after building the kernels and
printing phase 2's register, spill and tensor-core report.

    PYTHONPATH=src python scripts/ssm_train_phase.py

The quickest rerun of the phase on a card after a change to its path;
``python3 chip_smoke.py`` runs it after phases 1-23.  Prints the
backward kernel's kernels-line row; exits 1 if a check fails."""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    cs.log(f"build {time.perf_counter() - t0:.1f} s; "
           f"{torch.cuda.get_device_name(0)}")
    kernels = ops.KERNELS + fops.KERNELS + sops.KERNELS

    def reset_counts():
        for mod in (ops, fops, sops):
            mod.reset_counts()

    def counts(attr):
        return {fn.__name__: getattr(fn, attr, 0) for fn in kernels}

    try:
        cs.build_report(build, lib)
        row, launches = cs.ssm_train_phase(torch, np, fops, sops, sref,
                                           cs.spin_ms(torch), reset_counts,
                                           counts)
        cs.log("phase 24 alone: " + json.dumps(
            {"name": "ssd_scan_bwd", "launches": launches, **row}))
    except Exception:
        import traceback
        traceback.print_exc()
        return 1
    cs.log(f"phase 24 alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
