"""Run ``chip_smoke.py`` phase 25 alone: the port's hot-path lint swept
over ``src/repro_torch``, then the six counted sync sites driven under
``REPRO_SANITIZE=1`` and ``torch.cuda.set_sync_debug_mode("warn")``,
after building the kernels.

    PYTHONPATH=src python scripts/sync_phase.py

The quickest rerun of the phase on a card after a change to the engines'
readbacks or to the lint; ``python3 chip_smoke.py`` runs it after phases
1-24.  Exits 1 if a check fails."""
from __future__ import annotations

import os
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
    cs.log(f"build {time.perf_counter() - t0:.1f} s; "
           f"{torch.cuda.get_device_name(0)}")
    try:
        cs.sync_phase(torch, os.path.join(ROOT, "src"))
    except Exception:
        import traceback
        traceback.print_exc()
        return 1
    cs.log(f"phase 25 alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
