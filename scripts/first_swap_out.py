"""Whether ``warmup()`` takes the first swap-out's one-off cost out of a
serve: ``chip_smoke.py`` phase 15's chaos serve (chatglm-6b at full width
in bf16, its 128-block pool and pinned tier, its fault plan) in a fresh
process, on an engine built with or without ``warmup=True``.

    PYTHONPATH=src python scripts/first_swap_out.py            # unwarmed
    PYTHONPATH=src python scripts/first_swap_out.py --warmup   # warmed

Needs the card.  Prints the card's name and power limit, the engine's
build (and warmup) time, and each swap-out's host ms, the first also in
its parts (``split_first_swap_out``).  Run each in a process of its own:
a one-off cost of the process (a kernel's first load, the first pinned
allocation) is paid by whatever swaps first."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def split_first_swap_out(parts: dict) -> None:
    """Time the process's first swap-out that gathers pages in its parts,
    each synchronised on both sides: the gather of the image's pages
    (with the upload of its block ids and the allocator's new
    reservations), the pinned buffer for the logits row, and the copies
    into the pinned store.  Fills ``parts`` with {part: (host ms, MiB
    reserved anew)}; later swap-outs run untouched."""
    import time

    from repro_torch.models import model as M
    from repro_torch.serving.engine import PagedContinuousEngine
    swap_out = PagedContinuousEngine._swap_out

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            r0, t0 = torch.cuda.memory_reserved(), time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[name] = (round((time.perf_counter() - t0) * 1e3, 3),
                           round((torch.cuda.memory_reserved() - r0)
                                 / 2 ** 20, 1))
            return out
        return call

    def split(engine, slot):
        if parts:
            return swap_out(engine, slot)
        gather, tier = M.gather_pages, engine.swap
        M.gather_pages = timed("gather", gather)
        tier.host_empty = timed("pinned logits row", tier.host_empty)
        tier.swap_out = timed("copies into the store", tier.swap_out)
        try:
            return swap_out(engine, slot)
        finally:
            M.gather_pages = gather
            del tier.host_empty, tier.swap_out

    PagedContinuousEngine._swap_out = split


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", action="store_true",
                    help="build the engine with warmup=True")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("first_swap_out: needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    build.build()
    build.load_library()
    cfg = get_config("chatglm-6b")
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    parts = {}
    split_first_swap_out(parts)
    r = chip_smoke.chaos_serve(torch, cfg, params, "cuda", torch.bfloat16,
                               lambda: None, lambda attr: {},
                               warmup=args.warmup)
    eng = r["engine"]
    r["inj"].release(eng.allocator)
    eng.assert_drained()
    print(json.dumps({
        "warmup": args.warmup, "build_and_warmup_s": round(r["build_s"], 3),
        "swap_outs_ms": [round(t * 1e3, 3) for t, _, _ in r["outs"]],
        "swap_out_blocks": [b for _, _, b in r["outs"]],
        "device_work_queued": r["queued"],
        "first_in_parts": parts,
        "served": r["stats"]["served"], "wall_s": round(r["wall"], 3)}))


if __name__ == "__main__":
    main()
