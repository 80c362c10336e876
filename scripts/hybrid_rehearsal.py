"""The schedule of ``chip_smoke.py`` phase 19's hybrid padded serve,
rehearsed on the CPU with a reduced model.

    PYTHONPATH=src python scripts/hybrid_rehearsal.py [--hbm-bytes N]

Phase 19 serves hymba-1.5b at full width through ``run_engine_backend``
(``magnus``, the padded ``BatchEngine``) on phase 7's 64 Poisson
requests, with ``hbm_bytes`` the card's memory.  Which batches the Magnus
batcher forms depends on the memory model (``core/wma.py``
``MemoryModel``: the weights' bytes, a request's KV up to the window and
its recurrent state), and the reduced config's model is not the full
one's.  So this schedules with the FULL config's ``MemoryModel`` at the
card's ``hbm_bytes`` (the default is an H100 80GB's, as
``torch.cuda.get_device_properties(0).total_memory`` gives it) and serves
each batch on a ``BatchEngine`` of the ``reduced()`` config in f32 on the
CPU, in the launcher's loop (every request queued before the first
batch, then ``next_batch`` until the queue is empty).  A padded batch is
length-scripted: its size, length and G(B) come from the batcher and
the requests, not from the model.

It prints the batches (size, batch length, G(B)), the decode steps, the
host syncs (popcount G(B) a batch), the captures (one a batch of at
least ``MIN_GRAPH_STEPS`` steps on the card; this CPU engine captures
none), the WMA total, the launches they imply at full width (32 layers:
flash and the scan once a layer and batch, dense decode once a layer
and step), and the memory model's Theta beside the largest batch's
bytes.  ``chip_smoke.HYBRID_SCHEDULE`` holds these counts; the card's
run must show them."""
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hbm-bytes", type=int, default=H100_80GB)
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    full = get_config(cs.HYBRID_ARCH)
    memory = MemoryModel(full, hbm_bytes=args.hbm_bytes,
                         max_len=cs.DENSE_MAX_LEN, max_gen=cs.DENSE_MAX_GEN)
    predictor = GenerationLengthPredictor(seed=0).fit(
        make_dataset(60, seed=1))
    svc = MagnusService(memory, MagnusConfig(strategy="magnus"),
                        predictor=predictor)
    engine = BatchEngine(full.reduced(), seed=0, max_gen=cs.DENSE_MAX_GEN,
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
    layers = full.num_layers
    steps = sum(r.iterations for r in results)
    out = {
        "requests": sum(r.batch_size for r in results),
        "batches": len(results),
        "batch_shapes": [[r.batch_size, r.batch_length, r.iterations]
                         for r in results],
        "decode_steps": steps,
        "host_syncs": engine.host_syncs,
        "popcount_syncs": sum(bin(r.iterations).count("1")
                              for r in results),
        "captures": sum(r.iterations >= MIN_GRAPH_STEPS for r in results),
        "wma_total": sum(r.wma for r in results),
        "flash_launches": layers * len(results),
        "scan_launches": layers * len(results),
        "decode_launches": layers * steps,
        "hbm_bytes": args.hbm_bytes, "theta": memory.theta,
        "largest_batch_bytes": peak}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
