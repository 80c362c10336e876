"""Training launcher (the reference package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 100 --batch-size 8 --seq-len 256 [--reduced | --full] \
        [--ckpt runs/ck.npz] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given, in f32 with TF32
off (the reference trains in f32).  ``--reduced`` (the default) trains
the CPU-sized variant (``--layers``, ``--d-model``); ``--full`` the
published config, on the card: the attention's forward and backward run
through the hand-written flash kernels there.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.train.data import DataConfig
from repro_torch.train.trainer import TrainConfig, train


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse ``argv`` (default: the command line), train, and return the
    trainer's result ({"params", "opt_state", "history"})."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--d-model", type=int, default=256,
                    help="reduced-variant width")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=args.layers, d_model=args.d_model)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps @ b={args.batch_size} s={args.seq_len} "
          f"on {device}")
    out = train(cfg,
                TrainConfig(steps=args.steps, log_every=args.log_every,
                            ckpt_path=args.ckpt),
                DataConfig(batch_size=args.batch_size, seq_len=args.seq_len),
                act_dtype=torch.float32, device=device)
    final = out["history"][-1]
    print(f"done: loss {final['loss']:.4f} in {final['wall']:.1f}s")
    return out


if __name__ == "__main__":
    main()
