"""Run ``chip_smoke.py`` phases 20 and 21 alone: deepseek-v3-671b's MLA
padded serve at its published widths (2 layers, no MTP module) and
internvl2-26b's vlm padded serve uncut, after building the kernels.

    PYTHONPATH=src python scripts/mla_vlm_phases.py [--only 20|21]

The quickest rerun of the phases on a card after a change to either
path; ``python3 chip_smoke.py`` runs them after phases 1-19, with phase
7's tokens/s beside theirs.  Exits 1 if a check fails."""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=int, choices=(20, 21), default=None)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import mla as mla_module
    from repro_torch.models import transformer
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

    hbm = torch.cuda.get_device_properties(0).total_memory
    try:
        if args.only in (None, 20):
            launches = cs.mla_phase(torch, transformer, mla_module, hbm, {},
                                    reset_counts, counts)
            cs.log(f"phase 20 alone: launches {launches}")
        if args.only in (None, 21):
            t21, launches = cs.vlm_phase(
                torch, ops, ref, fops, fref, transformer, hbm,
                cs.spin_ms(torch), {}, reset_counts, counts)
            cs.log(f"phase 21 alone: launches {launches}; timings {t21}")
    except Exception:
        import traceback
        traceback.print_exc()
        return 1
    cs.log(f"phases alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
