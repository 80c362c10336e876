"""Run ``chip_smoke.py`` phase 28 alone, after building the kernels:
chatglm-6b uncut in bf16 through ``ContinuousEngine`` (32 slots,
``max_len`` 256, ``max_gen`` 64) on phase 5's 48 requests, by the
reference's join-while-room, step, repeat loop; its step captured once
as a CUDA graph, its token readback overlapped with the step, an 8-step
window held bit for bit against ``decode_step`` run eagerly, graphed
and eager windows profiled; the flash and dense decode kernels held
against their plain versions and timed at the serve's own inputs.

    PYTHONPATH=src python scripts/continuous_phase.py

``python3 chip_smoke.py`` runs it after phase 25, beside phase 14's
paged serve of the same requests (whose tokens/s it logs for the
paged-vs-dense comparison; not run here).  Exits 1 if a check fails."""
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
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_scan import ops as sops
    t0 = time.perf_counter()
    build.load_library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cs.log(f"build {time.perf_counter() - t0:.1f} s; {card}; torch "
           f"{torch.__version__} cuda {torch.version.cuda}")
    kernels = ops.KERNELS + fops.KERNELS + sops.KERNELS

    def reset_counts():
        ops.reset_counts()
        fops.reset_counts()
        sops.reset_counts()

    def counts(attr):
        return {fn.__name__: getattr(fn, attr, 0) for fn in kernels}

    try:
        cs.continuous_phase(torch, ops, ref, fops, fref, cs.spin_ms(torch),
                            reset_counts, counts, card=card)
    except Exception:
        import traceback
        traceback.print_exc()
        return 1
    cs.log(f"phase 28 alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
