"""AdamW with decoupled weight decay and global-norm clipping, ported from
``repro/optim/adamw.py``.

State layout mirrors the parameter tree: ``{"mu": tree, "nu": tree,
"count": int32 scalar}``, with float32 moments whatever the parameter's
dtype, so the optimizer is stable when the parameters are bf16.
Decay applies to every leaf of two or more dimensions, the layer-stacked
``(L, d_model)`` norm scales among them, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.profiler

from repro_torch.layers import base


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


def init(params: Any) -> dict:
    def zeros():
        return base.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=base.tree_leaves(params)[0].device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in base.tree_leaves(tree)))


def update(cfg: AdamWConfig, grads: Any, state: dict, params: Any, *,
           grad_norm: torch.Tensor | None = None
           ) -> tuple[Any, dict, dict]:
    """Returns ``(params, state, metrics)``.

    ``grad_norm`` is the global gradient norm where the caller computed it
    (the sharded step: over the unique shards of every rank); by default
    :func:`global_norm` of ``grads``.

    The parameters and the moments are updated in place (``copy_`` under
    ``torch.no_grad()``), so no second copy of the model is made; the
    returned trees are the ones passed in, and ``state["count"]`` is a new
    tensor.  Each new parameter is computed in float32 and cast back to
    its dtype.  The update runs under the profiler range
    ``adamw.update``."""
    with torch.no_grad(), torch.profiler.record_function("adamw.update"):
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        clip = torch.clamp_max(cfg.grad_clip_norm
                               / torch.clamp_min(gnorm, 1e-9), 1.0)
        count = state["count"] + 1
        lr = (cfg.lr(count) if callable(cfg.lr)
              else torch.tensor(cfg.lr, dtype=torch.float32,
                                device=count.device))
        b1c = 1.0 - cfg.b1 ** count.float()
        b2c = 1.0 - cfg.b2 ** count.float()
        leaves = map(base.tree_leaves,
                     (params, grads, state["mu"], state["nu"]))
        for p, g, mu, nu in zip(*leaves):
            gf = g.float() * clip
            mu.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
            nu.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
            del gf
            step = (mu / b1c).div_(torch.sqrt(nu / b2c).add_(cfg.eps))
            pf = p.float()
            if p.dim() >= 2:                  # no decay on 1-d norms/biases
                step.add_(pf, alpha=cfg.weight_decay)
            p.copy_(pf - lr * step)
    new_state = {"mu": state["mu"], "nu": state["nu"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
