"""The schedules of ``chip_smoke.py`` phases 20 and 21 (the MLA and vlm
padded serves), rehearsed on the CPU with reduced models.

    PYTHONPATH=src python scripts/mla_vlm_rehearsal.py [--hbm-bytes N]

Phase 20 serves deepseek-v3-671b cut to ``chip_smoke.MLA_CUT`` (2 layers,
no MTP module) and phase 21 internvl2-26b uncut, each through the padded
launcher's loop (``serve_padded``: ``magnus``, ``BatchEngine``) on phase
7's 64 Poisson requests, with ``hbm_bytes`` the card's memory.  Which
batches the Magnus batcher forms depends on the memory model
(``core/wma.py`` ``MemoryModel``: the weights' bytes and a request's
cache bytes, which count no patch token), and a reduced config's model
is not the served one's.  So each phase is scheduled with the served
config's ``MemoryModel`` at ``hbm_bytes`` (the default is an H100
80GB's, as ``torch.cuda.get_device_properties(0).total_memory`` gives
it) and each batch served on a ``BatchEngine`` of its ``reduced()``
config in f32 on the CPU, in the launcher's loop.  A padded batch is
length-scripted: its size, length and G(B) come from the batcher and the
requests, not from the model.

It prints one JSON line a phase: the schedule as ``chip_smoke.py``'s
``padded_schedule`` gives it (batches, decode steps, host syncs, the
captures a card would make, the WMA total, the batches' shapes), which
``chip_smoke.MLA_SCHEDULE`` and ``VLM_SCHEDULE`` hold; the launches it
implies at the served depth (MLA: none; internvl2: flash once a layer
and batch, dense decode once a layer and step); and the memory model's
Theta beside the largest batch's bytes."""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.magnus import MagnusConfig, MagnusService  # noqa: E402
from repro_torch.core.predictor import GenerationLengthPredictor  # noqa: E402
from repro_torch.core.wma import MemoryModel  # noqa: E402
from repro_torch.serving.engine import (MIN_GRAPH_STEPS,  # noqa: E402
                                        BatchEngine)
from repro_torch.workload.apps import make_dataset  # noqa: E402
from repro_torch.workload.generator import poisson_workload  # noqa: E402

# total_memory of an NVIDIA H100 80GB HBM3 (700.00 W), as chip_smoke.py
# phase 19 logs it
H100_80GB = 85_017_493_504


def rehearse(served, hbm_bytes):
    """The launcher's loop with ``served``'s memory model and its
    reduced model on the CPU; returns (schedule, Theta, largest batch's
    bytes)."""
    torch.manual_seed(0)
    memory = MemoryModel(served, hbm_bytes=hbm_bytes,
                         max_len=cs.DENSE_MAX_LEN, max_gen=cs.DENSE_MAX_GEN)
    predictor = GenerationLengthPredictor(seed=0).fit(
        make_dataset(60, seed=1))
    svc = MagnusService(memory, MagnusConfig(strategy="magnus"),
                        predictor=predictor)
    engine = BatchEngine(served.reduced(), seed=0, max_gen=cs.DENSE_MAX_GEN,
                         device="cpu")
    reqs = poisson_workload(8, 60, seed=0, max_len=cs.DENSE_MAX_LEN,
                            max_gen=cs.DENSE_MAX_GEN)[:cs.DENSE_N_REQUESTS]
    for r in reqs:
        svc.on_request(r, r.arrival_time)
    now, results, peak = 0.0, [], 0
    while len(svc.batcher.queue) > 0:
        b = svc.next_batch(now)
        if b is None:
            break
        peak = max(peak, memory.mem_of(b, predicted=False))
        res = engine.serve_batch(b)
        results.append(res)
        now += res.wall_time
    assert sum(r.batch_size for r in results) == len(reqs)
    sched = {"batches": len(results),
             "decode_steps": sum(r.iterations for r in results),
             "host_syncs": engine.host_syncs,
             "captures": sum(r.iterations >= MIN_GRAPH_STEPS
                             for r in results),
             "wma_total": sum(r.wma for r in results),
             "shapes": sorted([r.batch_size, r.batch_length, r.iterations]
                              for r in results)}
    assert sched["host_syncs"] == sum(bin(r.iterations).count("1")
                                      for r in results)
    return sched, memory.theta, peak


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hbm-bytes", type=int, default=H100_80GB)
    args = ap.parse_args(argv)
    for phase, served in ((20, cs.mla_config()),
                          (21, get_config(cs.VLM_ARCH))):
        sched, theta, peak = rehearse(served, args.hbm_bytes)
        attends = not served.uses_mla
        layers = served.num_layers
        print(json.dumps({
            "phase": phase, "arch": served.name,
            "layers": layers, "schedule": sched,
            "flash_launches": layers * sched["batches"] if attends else 0,
            "decode_launches": (layers * sched["decode_steps"]
                                if attends else 0),
            "hbm_bytes": args.hbm_bytes, "theta": theta,
            "largest_batch_bytes": peak}), flush=True)


if __name__ == "__main__":
    main()
