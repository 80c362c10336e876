"""Run ``chip_smoke.py`` phase 23 alone: the flash forward and backward
kernels against their plain versions in f32 and bf16, one full-width
train step of smollm-135m (cut to 2 layers) on the card against the CPU
in f32 and in bf16, and smollm-135m trained uncut through
``repro_torch.launch.train`` (f32) and ``trainer.train`` with bf16
activations, after building the kernels.

    PYTHONPATH=src python scripts/train_phase.py

The quickest rerun of the phase on a card after a change to its path;
``python3 chip_smoke.py`` runs it after phases 1-22.  Prints the
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
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_scan import ops as sops
    t0 = time.perf_counter()
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
        row, launches = cs.train_phase(torch, np, fops, fref,
                                       cs.spin_ms(torch), reset_counts,
                                       counts)
        cs.log("phase 23 alone: " + json.dumps(
            {"name": "flash_attention_bwd",
             "launches": launches["flash_attention_bwd"], **row}))
    except Exception:
        import traceback
        traceback.print_exc()
        return 1
    cs.log(f"phase 23 alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
