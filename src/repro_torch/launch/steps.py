"""The training step, ported from ``repro/launch/steps.py``:
``lm.loss_fn``, its gradients over every parameter leaf
(``torch.autograd.grad``, the port's ``jax.value_and_grad``), and the
AdamW update.  The abstract input specs and ``plan_cell`` stay with the
dry-run, which comes with the multi-device slice of the port.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.layers import base
from repro_torch.models import lm
from repro_torch.optim import adamw, schedule


def default_opt_config(total_steps: int = 1000) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(
        lr=schedule.warmup_cosine(3e-4, min(100, total_steps // 10 + 1),
                                  total_steps))


def _unflatten(like: Any, leaves: list) -> Any:
    """``leaves`` (in :func:`base.tree_leaves` order) in ``like``'s nested
    dict structure."""
    it = iter(leaves)
    return base.tree_map(lambda _: next(it), like)


def make_train_step(cfg: ModelConfig, rt: RuntimeConfig,
                    opt_cfg: adamw.AdamWConfig) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    The parameters and the optimizer state are updated in place
    (:func:`adamw.update`); ``metrics`` holds ``loss``, ``nll``,
    ``router_aux_loss``, ``drop_fraction``, ``grad_norm`` and ``lr`` as
    tensors.  The step runs under ``torch.enable_grad()`` whatever the
    caller's grad mode."""
    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            # aliases of the parameters that autograd may differentiate
            # against; the update writes the parameters themselves
            live = base.tree_map(lambda p: p.detach().requires_grad_(),
                                 params)
            loss, metrics = lm.loss_fn(live, batch, cfg, rt)
            flat = base.tree_leaves(live)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = _unflatten(params, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(flat, grads)])
        del live, flat
        params, opt_state, opt_metrics = adamw.update(opt_cfg, grads,
                                                      opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **opt_metrics}
    return train_step
