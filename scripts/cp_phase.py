"""Run ``chip_smoke.py`` phase 26 alone: the context-parallel decode of
qwen2.5-14b (48 query heads, decode_cp) at decode_32k's 32,768-slot
cache, after building the kernels: (a) one device, no mesh, bit-equal
to the flag off; (b) one layer's attention on two ranks of the one card
over gloo against the one-device kernel; (c) whole f32 decode steps on
the two ranks against one device, on an f32 and an int8 cache; the
partial kernels, the merge and the steps timed.

    PYTHONPATH=src python scripts/cp_phase.py

Needs one H100 (the two ranks are processes on it) and ~72 GiB of its
memory; ``python3 chip_smoke.py`` runs it after phases 1-25.  Exits 1
if a check fails."""
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
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
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
        rows, launches, _ = cs.cp_phase(torch, ops, ref, cs.spin_ms(torch),
                                        reset_counts, counts)
    except Exception:
        import traceback
        traceback.print_exc()
        return 1
    cs.log(json.dumps({name: {**row, "launches": launches[name]}
                       for name, row in rows.items()}))
    cs.log(f"phase 26 alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
