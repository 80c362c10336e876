"""The schedule of ``chip_smoke.py`` phase 22 (whisper-large-v3's padded
serve), rehearsed on the CPU with the reduced model.

    PYTHONPATH=src python scripts/encdec_rehearsal.py [--hbm-bytes N]

Phase 22 serves whisper-large-v3 uncut through the padded launcher's
loop (``run_engine_backend``: ``magnus``, ``BatchEngine``, zero audio
frames) on phase 7's 64 Poisson requests, with ``hbm_bytes`` the card's
memory.  Which batches the Magnus batcher forms depends on the memory
model (``core/wma.py`` ``MemoryModel``: the weights' bytes, and a
request's self K/V bytes plus its cross K/V at ``encoder_seq`` rows), so
the schedule is taken with the full config's ``MemoryModel`` at
``hbm_bytes`` (the default is an H100 80GB's) and each batch served on a
``BatchEngine`` of the ``reduced()`` config in f32 on the CPU, in the
launcher's loop, as ``scripts/mla_vlm_rehearsal.py`` does for phases 20
and 21.

It prints one JSON line: the schedule as ``chip_smoke.py``'s
``padded_schedule`` gives it, which ``chip_smoke.ENCDEC_SCHEDULE``
holds; the launches it implies at the served depth (flash three times a
layer and batch: the encoder's 32 layers, the decoder's self-attention
and its cross attention in each of its 32; dense decode twice a layer
and step: self and cross); and the memory model's Theta beside the
largest batch's bytes."""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mla_vlm_rehearsal import H100_80GB, rehearse  # noqa: E402  (first:
#                                         it puts the repo root on the path)
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hbm-bytes", type=int, default=H100_80GB)
    args = ap.parse_args(argv)
    served = get_config(cs.ENCDEC_ARCH)
    sched, theta, peak = rehearse(served, args.hbm_bytes)
    print(json.dumps({
        "phase": 22, "arch": served.name,
        "layers": [served.encoder_layers, served.num_layers],
        "schedule": sched,
        "flash_launches": ((served.encoder_layers + 2 * served.num_layers)
                           * sched["batches"]),
        "decode_launches": 2 * served.num_layers * sched["decode_steps"],
        "hbm_bytes": args.hbm_bytes, "theta": theta,
        "largest_batch_bytes": peak}), flush=True)


if __name__ == "__main__":
    main()
