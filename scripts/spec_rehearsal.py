"""The schedule of ``chip_smoke.py`` phase 16's self-draft serves,
rehearsed on the CPU with a reduced model.

    PYTHONPATH=src python scripts/spec_rehearsal.py

A paged serve's schedule is length-scripted, and a self-draft accepts
every proposal in exact arithmetic, so the spec windows, waves, decode
steps and host syncs of phase 16 (a) and (c) do not depend on the
model's width: this runs phase 5's requests through the port's launcher
at phase 5's geometry (and at phase 16 (c)'s smaller pool) with
chatglm-6b's ``reduced()`` config in f32, spec off and on, and prints
each serve's counts and the launches they imply at full width (28
layers).  The spec-off serve must give phase 5's schedule (128 decode
steps, 5 waves, 9 host syncs), which shows that the width does not move
it."""
from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from repro_torch.launch.serve import run_paged_engine_backend  # noqa: E402
from repro_torch.workload.apps import make_shared_head_dataset  # noqa: E402

LAYERS = 28            # chatglm-6b at full width


def serve(num_blocks: int, spec: bool) -> dict:
    reqs = make_shared_head_dataset(chip_smoke.N_REQUESTS, n_apps=3,
                                    gen_length=chip_smoke.GEN_LENGTH, seed=0)
    geometry = dict(chip_smoke.SERVE, num_blocks=num_blocks)
    res = run_paged_engine_backend(
        "chatglm-6b", 0.0, 0.0, "magnus-paged", seed=0, reduced=True,
        device="cpu", dtype=torch.float32, prefix_cache=True,
        requests=reqs, spec_decode=spec, draft_k=chip_smoke.DRAFT_K,
        **geometry)
    eng = res.pop("engine")
    eng.assert_drained()
    waves, windows = eng.prefill_dispatches, eng.spec_windows
    out = {"num_blocks": num_blocks, "spec": spec,
           "requests": res["requests"], "decode_steps": eng.decode_steps,
           "waves": waves, "host_syncs": eng.host_syncs,
           "evictions": eng.evictions}
    if spec:
        w = eng.spec_w
        out.update(spec_windows=windows,
                   acceptance_rate=res["acceptance_rate"],
                   accepted_per_dispatch=res["accepted_per_dispatch"],
                   draft_prefill_tokens=eng.draft_prefill_tokens,
                   decode_launches=LAYERS * w * windows,
                   prefill_launches=LAYERS * (2 * waves + windows))
    else:
        out.update(decode_launches=LAYERS * eng.decode_steps,
                   prefill_launches=LAYERS * waves)
    return out


def main() -> None:
    torch.manual_seed(0)
    for num_blocks, spec in ((chip_smoke.SERVE["num_blocks"], False),
                             (chip_smoke.SERVE["num_blocks"], True),
                             (chip_smoke.SPEC_F32_BLOCKS, True)):
        print(json.dumps(serve(num_blocks, spec)), flush=True)


if __name__ == "__main__":
    main()
