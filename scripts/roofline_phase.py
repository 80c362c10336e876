"""Run ``chip_smoke.py`` phase 27 alone, after building the kernels:
phase 2's host cost of a registered op, then (a) ``launch/dryrun.py
--all`` and ``launch/hillclimb.py`` in subprocesses on a fake 512-rank
group (0 error records, no CUDA context in either), and (b) smollm-135m's
and mamba2-780m's f32 training steps and chatglm-6b's bf16 padded decode
step at full width against their dry runs (equal FLOPs, busy against
the roofline's floor, predicted peak against the allocator's).

    PYTHONPATH=src python scripts/roofline_phase.py

``python3 chip_smoke.py`` runs it after phases 1-26.  Exits 1 if a check
fails."""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load_library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cs.log(f"build {time.perf_counter() - t0:.1f} s; {card}; torch "
           f"{torch.__version__} cuda {torch.version.cuda}")
    try:
        cs.op_host_cost(torch, card)
        cs.roofline_phase(torch, card)
    except Exception:
        import traceback
        traceback.print_exc()
        return 1
    cs.log(f"phase 27 alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
