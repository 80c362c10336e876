"""Hillclimbing runner (the reference package's ``launch/hillclimb.py``):
run named variants of the three selected (arch x shape) pairs through the
port's dry run and append a record per variant (baseline first) to
``runs/hillclimb_torch.jsonl``.  Each variant carries its hypothesis,
written for what the variant changes in the port's program: the port has
no SPMD compiler, so a sharding override changes nothing but which rows
of the batch and which block of the cache a rank holds.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--pair qwen_decode]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.launch.dryrun import (cuda_footprint, dryrun_one,
                                       init_fake_group, summary_line)

# (name, arch, shape, hypothesis, overrides, variant)
Variant = Tuple[str, str, str, str, Optional[Dict[str, Any]],
                Optional[Dict[str, Any]]]

_BATCH2D = {"act_batch": ("data", "model"), "act_seq": None,
            "q_heads": None, "kv_heads": None, "mlp": None, "vocab": None,
            "act_heads": None, "act_mlp": None, "act_vocab": None,
            "expert_groups": ("data", "model")}

PAIRS: Dict[str, List[Variant]] = {
    # 1. the reference's worst useful-FLOPs fraction among train shapes
    "smollm_train": [
        ("baseline", "smollm-135m", "train_4k",
         "every rank holds the whole model and its 16 of the 256 rows "
         "(act_batch over data); the model axis holds copies", None, None),
        ("batch2d", "smollm-135m", "train_4k",
         "a placement only: act_batch over (data, model) gives each rank "
         "1 of the 256 rows; predicts every activation term 16x smaller, "
         "the weights and optimizer state unchanged", _BATCH2D, None),
        ("batch2d_noremat", "smollm-135m", "train_4k",
         "on top of batch2d, remat_mode none: no block is recomputed in "
         "the backward; predicts ~25% fewer FLOPs and a higher peak (each "
         "block's activations kept)", _BATCH2D, {"remat_mode": "none"}),
    ],
    # 2. the reference's most collective-bound pair
    "deepseek7b_train": [
        ("baseline", "deepseek-7b", "train_4k",
         "every rank holds the whole model and its 16 rows; no "
         "collective runs (the port has no sequence parallelism)",
         None, None),
        ("heads_attention", "deepseek-7b", "train_4k",
         "a placement only, and act_seq places nothing in the port: "
         "predicts the baseline's counts unchanged", {"act_seq": None},
         None),
        ("hybrid_sp", "deepseek-7b", "train_4k",
         "a placement only, and act_heads places nothing in the port: "
         "predicts the baseline's counts unchanged", {"act_heads": None},
         None),
        ("no_remat", "deepseek-7b", "train_4k",
         "remat_mode none: no block is recomputed; predicts ~25% fewer "
         "FLOPs and a higher peak", None, {"remat_mode": "none"}),
        ("no_remat_heads_attn", "deepseek-7b", "train_4k",
         "no_remat with a placement that places nothing: predicts "
         "no_remat's counts", {"act_seq": None}, {"remat_mode": "none"}),
    ],
    # 3. the paper's hot path: 32k-cache batched decode
    "qwen_decode": [
        ("baseline", "qwen2.5-14b", "decode_32k",
         "each rank holds the whole model in bf16 and its 8 of the 128 "
         "rows of a 32k bf16 cache; the cache read dominates", None, None),
        ("pad_heads48", "qwen2.5-14b", "decode_32k",
         "pad q-heads 40 -> 48 (zero heads, function-preserving): with "
         "whole weights on every rank, predicts more weight bytes and "
         "FLOPs (+20% in wq, wo and attention), no saving", None,
         {"pad_heads_to": 48}),
        ("int8_kv", "qwen2.5-14b", "decode_32k",
         "int8 KV cache with per-(token, head) bf16 scales, read by the "
         "int8 decode kernel: predicts the cache's bytes and the memory "
         "term roughly halved", None, {"cache_int8": True}),
        ("pad_heads48_int8", "qwen2.5-14b", "decode_32k",
         "both composed", None, {"pad_heads_to": 48, "cache_int8": True}),
        ("cp_flash_decode", "qwen2.5-14b", "decode_32k",
         "context-parallel decode: each rank runs all 128 rows against "
         "its 8-row, 2k-slot block of the cache (the decode kernel's "
         "partial mode) and merges over the model axis with three "
         "all-reduces; predicts 16x fewer cache bytes a rank and a "
         "nonzero collective term", None,
         {"decode_cp": True, "pad_heads_to": 48}),
        ("cp_flash_decode_int8", "qwen2.5-14b", "decode_32k",
         "all three composed: the int8 partial kernel reads the block "
         "without a dequantised copy", None,
         {"decode_cp": True, "pad_heads_to": 48, "cache_int8": True}),
    ],
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default=None, choices=list(PAIRS) + [None])
    ap.add_argument("--out", default="runs/hillclimb_torch.jsonl")
    args = ap.parse_args()
    pairs = [args.pair] if args.pair else list(PAIRS)
    init_fake_group()
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    n_fail = 0
    for pair in pairs:
        for name, arch, shape, hypothesis, overrides, variant in PAIRS[pair]:
            rec = dryrun_one(arch, shape, verbose=False,
                             overrides=overrides, variant=variant)
            rec["pair"] = pair
            rec["iteration"] = name
            rec["hypothesis"] = hypothesis
            print(json.dumps({k: rec.get(k) for k in
                              ("pair", "iteration", "status", "t_compute_s",
                               "t_memory_s", "t_collective_s", "dominant",
                               "static_mem_gib", "peak_mem_gib",
                               "useful_flops_frac")},
                             default=str), flush=True)
            if rec["status"] == "error":
                n_fail += 1
                print(rec["error"][-1500:], flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")
    print(summary_line(sum(map(len, (PAIRS[p] for p in pairs))), n_fail,
                       [cuda_footprint()]), flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} hillclimb failures")


if __name__ == "__main__":
    main()
