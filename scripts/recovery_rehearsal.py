"""The schedule of ``chip_smoke.py`` phase 17's kill-and-recover runs,
rehearsed on the CPU with a reduced model.

    PYTHONPATH=src python scripts/recovery_rehearsal.py

A paged serve's schedule is length-scripted, so where the crash fires,
which snapshots land before it, what the restored image holds and what
the recovery replays do not depend on the model's width.  This runs
phase 17's own ``crash_run`` and ``recover_run`` (with the phase's
snapshot cadence and fault plans) on chatglm-6b's ``reduced()`` config
in f32: (a) phase 5's requests at phase 5's geometry, driven as the
launcher drives them, and (c)'s smaller f32 pool; (b) phase 15's
geometry with its pinned tier, crashed mid-swap.  For each it prints
the crashed run, each snapshot's blocks and its bytes at full width
(chatglm-6b: 458,752 B a token's K and V, 16 tokens a block; twice that
in f32), the restored image, the recovery's report, and the counts the
card's run must show: decode steps, waves, host syncs, and the paged
kernels' launches at 28 layers."""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving.faults import FaultEvent  # noqa: E402

LAYERS = 28                    # chatglm-6b at full width
TOKEN_BYTES = 458_752         # a token's K and V over 28 layers, bf16


def rehearse(label, kind, geometry, every, recovery_every, service,
             swap_blocks, f32):
    cfg = get_config("chatglm-6b").reduced()
    tmp = tempfile.mkdtemp(prefix="recovery-rehearsal-")
    timer = cs.snapshot_parts()
    block = TOKEN_BYTES * geometry["block_tokens"] * (2 if f32 else 1)
    try:
        with timer:
            crashed = cs.crash_run(
                torch, cfg, None, "cpu", torch.float32, tmp, every=every,
                events=cs.p17_events(FaultEvent, kind), geometry=geometry,
                service=service, swap_blocks=swap_blocks)
            eng = crashed["engine"]
            dead = {"crash": crashed["crash"], "windows": eng.windows,
                    "decode_steps": eng.decode_steps,
                    "waves": eng.prefill_dispatches,
                    "host_syncs": eng.host_syncs,
                    "finished": len(eng.generated),
                    "active": eng.num_active,
                    "suspended": eng.num_suspended,
                    "swap_outs": eng.swap_outs}
            n_crash = len(timer.snaps)
            restored = {}

            def built(engine):
                restore = engine.restore

                def watched(path):
                    restore(path)
                    restored.update(
                        file=os.path.basename(path),
                        active=engine.num_active,
                        suspended=engine.num_suspended,
                        finished=len(engine.generated),
                        decode_steps=engine.decode_steps,
                        waves=engine.prefill_dispatches,
                        host_syncs=engine.host_syncs)
                engine.restore = watched

            rec, report = cs.recover_run(
                torch, cfg, eng.params, "cpu", torch.float32, tmp,
                every=recovery_every, geometry=geometry,
                swap_blocks=swap_blocks, warm=False, built=built)
            rec.assert_drained()
        steps = dead["decode_steps"] + rec.decode_steps \
            - restored["decode_steps"]
        waves = dead["waves"] + rec.prefill_dispatches - restored["waves"]
        out = {
            "label": label, "crashed": dead,
            "snapshots": [{"window": s["window"], "blocks": s["blocks"],
                           "full_width_GB": round(s["blocks"] * block / 1e9,
                                                  3)}
                          for s in timer.snaps],
            "crashed_snapshots": n_crash, "restored": restored,
            "report": {k: v for k, v in report.items()
                       if k not in ("stats", "restore_s", "snapshot_used")},
            "recovered": {"decode_steps": rec.decode_steps,
                          "waves": rec.prefill_dispatches,
                          "host_syncs": rec.host_syncs,
                          "swap_ins": rec.swap_ins,
                          "served": len(rec.generated)},
            "launches": {"paged_decode_attention": LAYERS * steps,
                         "paged_prefix_prefill_attention": LAYERS * waves}}
        print(json.dumps(out), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    rehearse("(a)", "window", cs.SERVE, cs.RECOVER_EVERY,
             cs.RECOVERY_EVERY, True, 0, False)
    rehearse("(b)", "swap", cs.CHAOS, cs.SWAP_EVERY, cs.SWAP_RECOVERY_EVERY,
             False, cs.CHAOS_SWAP_BLOCKS, False)
    rehearse("(c)", "window", dict(cs.SERVE, num_blocks=cs.SPEC_F32_BLOCKS),
             cs.RECOVER_EVERY, cs.RECOVERY_EVERY, True, 0, True)


if __name__ == "__main__":
    main()
