"""Training loop (the reference package's ``train/trainer.py``): an AdamW
train step, metrics, periodic checkpointing.

The step is eager PyTorch: ``torch.autograd.grad`` of ``model.loss_fn``
(on the card the attention's forward and backward are the flash kernels),
then :func:`optimizer.update` under ``no_grad``.  A logged step reads its
metrics back to the host once, as the reference's ``float(v)`` does;
other steps read nothing back."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.data import DataConfig, batches


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.AdamWConfig,
                    act_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: metrics {"loss", "ce", "aux", "grad_norm",
    "lr"} as tensors on the parameters' device.  Activations are
    ``act_dtype``, bf16 unless the caller says otherwise, as the
    reference's; :func:`train` passes its own (f32 by default).
    ``params`` is a tree of tensors, which the step leaves as they are
    (it differentiates detached views of them) and returns anew, as the
    reference's."""

    def train_step(params, opt_state, batch):
        params = opt_lib.tree_map(lambda p: p.detach().requires_grad_(True),
                                  params)
        leaves = opt_lib.tree_leaves(params)
        loss, metrics = M.loss_fn(params, cfg, batch, act_dtype=act_dtype)
        grads = iter(torch.autograd.grad(loss, leaves))
        grad_tree = opt_lib.tree_map(lambda _: next(grads), params)
        with torch.no_grad():
            params, opt_state, opt_m = opt_lib.update(
                opt_cfg, grad_tree, opt_state,
                opt_lib.tree_map(torch.Tensor.detach, params))
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **opt_m}
        return params, opt_state, out

    return train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0            # 0 = only at the end
    ckpt_path: Optional[str] = None
    seed: int = 0


def _batch(raw: Dict[str, Any], device) -> Dict:
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


def read_metrics(m: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The metrics as floats, in one read from the device."""
    vals = torch.stack([v.float() for v in m.values()]).tolist()
    return dict(zip(m, vals))


def train(cfg: ModelConfig, tc: TrainConfig, dc: Optional[DataConfig] = None,
          opt_cfg: Optional[opt_lib.AdamWConfig] = None,
          act_dtype: torch.dtype = torch.float32,
          device=None) -> Dict[str, Any]:
    """Train ``cfg`` for ``tc.steps`` steps on the packed synthetic
    corpus; returns {"params", "opt_state", "history"}, one history row
    per logged step ({"loss", "ce", "aux", "grad_norm", "lr", "step",
    "wall"}).  The params are ``model.init_params(cfg, seed=tc.seed)`` on
    ``device`` (the card unless the caller passes the CPU).  A row's
    ``wall`` is read after its metrics reach the host, so on the card it
    counts the device's work up to that step."""
    dev = resolve_device(device)
    dc = dc or DataConfig()
    opt_cfg = opt_cfg or opt_lib.AdamWConfig(total_steps=tc.steps)
    params = M.init_params(cfg, seed=tc.seed, device=dev)
    opt_state = opt_lib.init(opt_cfg, params)
    step_fn = make_train_step(cfg, opt_cfg, act_dtype=act_dtype)
    it = batches(cfg, dc)
    history = []
    t0 = time.perf_counter()
    for step in range(1, tc.steps + 1):
        params, opt_state, m = step_fn(params, opt_state,
                                       _batch(next(it), dev))
        if step % tc.log_every == 0 or step == tc.steps:
            row = read_metrics(m)
            row["step"] = step
            row["wall"] = time.perf_counter() - t0
            history.append(row)
            print(f"step {step:5d} loss {row['loss']:.4f} "
                  f"grad_norm {row['grad_norm']:.3f} lr {row['lr']:.2e}")
        if (tc.ckpt_every and tc.ckpt_path
                and step % tc.ckpt_every == 0):
            ckpt_lib.save(tc.ckpt_path, {"params": params}, step)
    if tc.ckpt_path:
        ckpt_lib.save(tc.ckpt_path, {"params": params}, tc.steps)
    return {"params": params, "opt_state": opt_state, "history": history}
