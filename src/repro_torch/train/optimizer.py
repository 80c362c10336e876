"""AdamW with global-norm clipping and a linear-warmup, cosine-decay
schedule (the reference package's ``train/optimizer.py``), over nested
dicts of tensors.

As the reference's, it is functional: :func:`update` returns new
parameters and a new state and leaves its inputs as they are.  The
arithmetic is the reference's, in f32: the clip scale ``min(1, clip /
(gnorm + 1e-9))``, the bias corrections ``1 - beta ** step``, and
decoupled weight decay on tensors of two or more dimensions only."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar, on the parameters' device
    mu: Any
    nu: Any


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (a parameter tree), with
    the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (f32): linear warmup to ``lr`` over
    ``warmup_steps``, then a cosine decay to a tenth of it at
    ``total_steps``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(cfg: AdamWConfig, params: Any) -> AdamWState:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def update(cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}), the
    gradients clipped to ``clip_norm`` by their global norm first."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.beta1, step.float())
    b2c = 1 - torch.pow(cfg.beta2, step.float())

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu_n = cfg.beta1 * mu.float() + (1 - cfg.beta1) * g
        nu_n = cfg.beta2 * nu.float() + (1 - cfg.beta2) * g * g
        upd_ = (mu_n / b1c) / (torch.sqrt(nu_n / b2c) + cfg.eps)
        if p.dim() >= 2:                     # decoupled decay on matrices
            upd_ = upd_ + cfg.weight_decay * p.float()
        p_n = p.float() - lr * upd_
        return p_n.to(p.dtype), mu_n.to(mu.dtype), nu_n.to(nu.dtype)

    out = tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return pick(0), AdamWState(step, pick(1), pick(2)), \
        {"grad_norm": gnorm, "lr": lr}
