"""The explicit data-parallel train step, ported from
``repro/distributed/data_parallel.py``.

Every rank of the mesh's ``"data"`` axis holds the parameters and the
optimizer state whole, takes its contiguous slice of the global batch (the
JAX package's ``P("data")``), runs the local forward and backward (the
port's kernels, whatever ``loss_fn`` lowers to), and reduces the gradients
across the axis by hand with :mod:`repro_torch.distributed.collectives`:

* **compressed reduction**: int8 block-quantised gradients with an
  error-feedback accumulator (:mod:`repro_torch.distributed.compression`);
  the quantise/dequantise round trip happens before the wire, and the
  residual stays in the train state;
* **explicit collective choice**: a flat mean all-reduce, or the
  reduce-scatter + all-gather decomposition (the ZeRO-2 building block).

AdamW then runs on every rank on the same reduced gradients, so the
parameters stay equal across ranks, and the step's metrics are averaged
across the axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed import collectives, compression
from repro_torch.layers import base
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class DPConfig:
    compress: bool = False           # int8 error-feedback gradient payload
    reduce_scatter: bool = False     # reduce-scatter + all-gather mean


def init_state(params: Any, opt_state: Any, *,
               compress: bool = False) -> dict:
    """Train state for :func:`make_dp_train_step`.  The error-feedback
    accumulator is parameter-shaped and lives in the state, so it rides
    checkpoints with everything else."""
    state = {"params": params, "opt": opt_state}
    if compress:
        state["err"] = compression.init_error_state(params)
    return state


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's contiguous slice of every batch leaf's leading dim."""
    n, r = mesh.extent("data"), mesh.coords.get("data", 0)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch leaf {k!r} of {v.shape[0]} rows does "
                             f"not split over data={n}")
        size = v.shape[0] // n
        out[k] = v[r * size:(r + 1) * size]
    return out


def _reduce_mean(grads: Any, mesh, dp: DPConfig) -> Any:
    """Mean all-reduce over the data axis, leaf by leaf.  The
    reduce-scatter path is the same reduction decomposed for leaves whose
    leading dim splits evenly; ragged leaves take the flat mean."""
    n = mesh.extent("data")

    def leaf(g: torch.Tensor) -> torch.Tensor:
        if dp.reduce_scatter and g.dim() and g.shape[0] % n == 0:
            piece = collectives.reduce_scatter_mean(g, mesh, "data", 0)
            return collectives.all_gather(piece, mesh, "data", 0)
        return collectives.all_reduce(g.contiguous(), mesh, "data").div_(n)

    return base.tree_map(leaf, grads)


def _compress_in_place(grads: dict, err: dict) -> None:
    """:func:`compression.compress_decompress` leaf by leaf, each new
    gradient and residual replacing the old in its dict at once, so one
    leaf's temporaries are alive at a time (not a second copy of the
    gradients and of the error state)."""
    for k in grads:
        if isinstance(grads[k], dict):
            _compress_in_place(grads[k], err[k])
        else:
            grads[k], err[k] = compression.compress_decompress(grads[k],
                                                               err[k])


def make_dp_train_step(loss_fn: Callable[[Any, Any], tuple],
                       opt_cfg: adamw.AdamWConfig, mesh,
                       dp: DPConfig = DPConfig()) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> (loss, metrics)`` is differentiated
    locally on each rank; ``state`` is :func:`init_state`'s dict (updated
    in place and returned); ``batch`` is the *global* batch, of which each
    rank takes its slice.  ``metrics`` holds the cross-rank means of
    ``loss_fn``'s metrics and the loss, and AdamW's ``grad_norm`` and
    ``lr`` (the same on every rank)."""
    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        local = shard_batch(batch, mesh)
        with torch.enable_grad():
            live = base.tree_map(lambda p: p.detach().requires_grad_(),
                                 params)
            loss, metrics = loss_fn(live, local)
            flat = base.tree_leaves(live)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(flat, grads)])
        grads = base.tree_map(lambda _: next(it), params)
        del live, flat, it
        if dp.compress:
            _compress_in_place(grads, state["err"])
        grads = _reduce_mean(grads, mesh, dp)
        state["params"], state["opt"], opt_metrics = adamw.update(
            opt_cfg, grads, state["opt"], params)
        # shard-local metrics (loss, nll, aux) become the cross-rank mean;
        # grad_norm and lr are the same on every rank already
        n = mesh.extent("data")
        names = sorted({**metrics, "loss": loss})
        local_m = torch.stack([
            (loss if k == "loss" else metrics[k]).detach().float().reshape(())
            for k in names])
        collectives.all_reduce(local_m, mesh, "data").div_(n)
        out = dict(zip(names, local_m.unbind()))
        out.update({k: v.detach() for k, v in opt_metrics.items()})
        return state, out

    return step


def wire_bytes(grads: Any, *, compress: bool) -> int:
    """Bytes one rank contributes to the gradient reduction."""
    if compress:
        return compression.compressed_bytes(grads)
    return sum(g.numel() * g.element_size() for g in base.tree_leaves(grads))
