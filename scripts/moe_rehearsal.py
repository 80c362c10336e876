"""The schedule of ``chip_smoke.py`` phase 18's MoE serve, rehearsed on
the CPU with a reduced model.

    PYTHONPATH=src python scripts/moe_rehearsal.py

A paged serve's schedule is length-scripted, so its decode steps,
admission waves, windows and host syncs do not depend on the model's
width.  This runs phase 18's serve (phase 5's 48 requests through
``run_paged_engine_backend`` at phase 5's geometry with the radix cache)
on olmoe-1b-7b's ``reduced()`` config in f32, and prints its counts, the
paged kernels' launches they imply at full width (16 layers), and each
admission wave's rows, suffix bucket and token count T with the groups
and capacity that T gets at full width (64 experts, top 8, capacity
factor 1.25, groups of up to 256 tokens), beside a decode step's (T =
the 32 slots).  ``chip_smoke.MOE_SCHEDULE`` holds the counts; the card's
run must show them."""
from __future__ import annotations

import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import run_paged_engine_backend  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.workload.apps import make_shared_head_dataset  # noqa: E402


def dispatch(cfg, t: int) -> dict:
    """Groups and capacity of ``moe_forward`` over T tokens."""
    m = cfg.moe
    g = moe._num_groups(t, cfg.moe_group_size)
    cap = max(1, math.ceil(t // g * m.top_k / m.num_experts
                           * m.capacity_factor))
    return {"T": t, "groups": g, "cap": cap}


def main() -> None:
    torch.manual_seed(0)
    full = get_config(cs.MOE_ARCH)
    reqs = make_shared_head_dataset(cs.N_REQUESTS, n_apps=3,
                                    gen_length=cs.GEN_LENGTH, seed=0)
    shapes, suffix = [], transformer.prefill_suffix

    def recorded(params, cfg, pages, tokens, *a, **kw):
        shapes.append(tuple(tokens.shape))      # a wave: [rows, bucket]
        return suffix(params, cfg, pages, tokens, *a, **kw)

    transformer.prefill_suffix = recorded
    try:
        res = run_paged_engine_backend(
            cs.MOE_ARCH, 0.0, 0.0, "magnus-paged", seed=0, reduced=True,
            device="cpu", dtype=torch.float32, prefix_cache=True,
            requests=reqs, **cs.SERVE)
    finally:
        transformer.prefill_suffix = suffix
    eng = res.pop("engine")
    eng.assert_drained()
    layers = full.num_layers
    print(json.dumps({
        "requests": res["requests"], "decode_steps": eng.decode_steps,
        "waves": eng.prefill_dispatches, "host_syncs": eng.host_syncs,
        "prefix_hits": res["prefix_hits"], "evictions": eng.evictions,
        "decode_launches": layers * eng.decode_steps,
        "prefill_launches": layers * eng.prefill_dispatches}), flush=True)
    for rows, bucket in shapes:
        print(json.dumps({"wave": [rows, bucket],
                          **dispatch(full, rows * bucket)}), flush=True)
    print(json.dumps({"decode": cs.SERVE["max_concurrency"],
                      **dispatch(full, cs.SERVE["max_concurrency"])}),
          flush=True)


if __name__ == "__main__":
    main()
