"""The training steps, ported from ``repro/launch/steps.py``:
``lm.loss_fn``, its gradients over every parameter leaf
(``torch.autograd.grad``, the port's ``jax.value_and_grad``), and the
AdamW update; and the sharded step, the port's ``jax.jit(step,
in_shardings=...)`` of the JAX package's GSPMD trainer
(:func:`make_sharded_train_step`).  The abstract input specs and
``plan_cell`` stay with the dry-run (ROADMAP.md queue 1, item 6d).

GSPMD keeps the global program's numbers and chooses the data movement;
the sharded step makes the data movement explicit, ZeRO-3 style, with
Megatron tensor parallelism over ``"model"`` for attention and the MLP.
Each rank holds its shard of every parameter and AdamW moment under the
repaired specs (``distributed.sharding``) and, each step:

* runs ``lm.loss_fn`` on its slice of the batch (split over the batch
  axes, replicated over ``"model"``; a masked mean over the global label
  count, ``lm._global_mean``);
* gathers each layer's parameters just before the layer runs, over the
  mesh axes their specs name, except that the attention and MLP leaves
  split over ``"model"`` keep that split (each rank computes its
  contiguous slice of the heads, or of the ``d_ff`` columns, under
  ``RuntimeConfig.tp_axis``; ``lm.tp_kept``); a gathered parameter is
  not kept for the backward, which gathers it again (:class:`_Zero3`).
  The embedding, the head and the final norm are gathered once a step;
* reduces each gradient to its shard as the backward makes it: averaged
  over the batch axes (a reduce-scatter along a dim its spec splits over
  ``"data"``, an all-reduce otherwise), then sliced to its shard (the
  ``"model"`` ranks hold the same gradient of every leaf computed
  whole);
* takes the global gradient norm as the sum of squares over the unique
  shards (a leaf replicated over an axis counted once, not once a rank),
  all-reduced over the mesh, and applies AdamW to its shards.

Compute outside attention and the MLP (norms, the embedding, the vocab
head and loss, MoE experts, mamba mixers) runs whole in every ``"model"``
rank: the numbers are the global program's, only the storage and the
attention and MLP compute are split.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, RuntimeConfig
from repro_torch.core.partition import MeshAxes, PartitionSpec as P, \
    spec_axes
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
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


# ---------------------------------------------------------------------------
# The sharded step.
# ---------------------------------------------------------------------------

def _maybe_batch_spec(tree: dict, mesh: Any) -> dict:
    """Shard the leading batch dim of every leaf of ``tree`` (the batch, or
    anything with ``.shape``) when it divides the batch axes' extent;
    otherwise replicate (long_500k has global_batch=1)."""
    axes = shd.batch_axes(mesh)
    extent = 1
    for a in spec_axes(axes):
        extent *= MeshAxes.from_mesh(mesh).extent(a)

    def leaf(x):
        shape = tuple(x.shape)
        if shape and shape[0] % extent == 0 and shape[0] > 0:
            return P(axes, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return {k: leaf(v) for k, v in tree.items()}


def zip_map(fn: Callable, tree: Any, *others: Any) -> Any:
    """``fn(leaf, *other_leaves)`` over trees of ``tree``'s nested-dict
    structure (the others' leaves may be any objects: specs, flags)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, tree[k], *(o[k] for o in others))
                for k in sorted(tree)}
    return fn(tree, *others)


def shard_tree(tree: Any, specs: Any, mesh: Any) -> Any:
    """This rank's shard of every leaf of a global tree."""
    return zip_map(lambda x, s: collectives.shard(x, s, mesh), tree, specs)


def gather_tree(tree: Any, specs: Any, mesh: Any) -> Any:
    """The global tree of every rank's shards, one leaf at a time, in rank
    0's host memory (None on every other rank), so no rank holds more
    than one whole leaf on the device: a checkpoint's gather (collective:
    every rank calls it)."""
    mine = mesh.rank == 0

    def leaf(x, s):
        whole = collectives.gather(x, s, mesh)
        return whole.cpu() if mine else None

    out = zip_map(leaf, tree, specs)
    return out if mine else None


def _gather_spec(spec: P, keep: bool) -> P:
    """The axes a leaf is gathered over for compute: all of its spec's, or,
    for a kept leaf, all but ``"model"``."""
    if not keep:
        return spec
    parts = []
    for entry in spec:
        axes = spec_axes(entry)
        if "model" in axes and len(axes) > 1:
            raise ValueError(f"spec {spec}: 'model' shares a dim with "
                             f"{axes}; a kept split needs it alone")
        parts.append(None if "model" in axes else entry)
    return P(*parts)


def _replicas(spec: P, mesh: Any) -> int:
    """How many ranks hold the same shard under ``spec``: the product of
    the extents of the mesh axes it does not name."""
    named = {a for entry in spec for a in spec_axes(entry)}
    n = 1
    for a in mesh.axis_names:
        if a not in named:
            n *= mesh.extent(a)
    return n


def sharded_grad_norm(grads: Any, specs: Any, mesh: Any) -> torch.Tensor:
    """The global norm of a gradient held as shards: each rank's sum of
    squares, every leaf divided by its replica count, summed over the
    whole mesh."""
    leaves = base.tree_leaves(grads)
    local = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g, spec in zip(leaves, base.tree_leaves(specs)):
        local = local + torch.sum(torch.square(g.float())) / _replicas(
            spec, mesh)
    collectives.all_reduce_axes(local, mesh, mesh.axis_names)
    return torch.sqrt(local)


def _reduce_grad(g: torch.Tensor, spec: P, keep: bool, mesh: Any,
                 batch: tuple[str, ...], owned: bool = False
                 ) -> torch.Tensor:
    """This rank's shard of the batch-mean of ``g`` (computed on the
    compute layout: whole but for a kept ``"model"`` split), in storage of
    its own; an ``owned`` ``g`` may be all-reduced in place."""
    n = 1
    for a in batch:
        n *= mesh.extent(a)
    rest = list(spec)
    if keep:        # the kept model split is this rank's already
        rest = [None if "model" in spec_axes(e) else e for e in rest]
    data_dims = [d for d, e in enumerate(rest) if e == "data"]
    if batch == ("data",) and len(data_dims) == 1 and n > 1:
        d = data_dims[0]
        g = collectives.reduce_scatter_mean(g, mesh, "data", d)
        rest[d] = None
    elif n > 1:
        if not (owned and g.is_contiguous()):
            g = g.clone(memory_format=torch.contiguous_format)
        for a in batch:
            collectives.all_reduce(g, mesh, a)
        g = g.div_(n)
    out = collectives.shard(g, P(*rest), mesh)
    if out.untyped_storage().nbytes() > out.numel() * out.element_size():
        out = out.clone()           # not a view keeping the whole alive
    return out


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """How the sharded step moves one parameter, or one layer of a
    layer-stacked one: gathered over ``gspec``'s axes for compute, its
    gradient reduced to this rank's shard under ``pspec``."""

    pspec: P
    gspec: P
    keep: bool


class _Fetch(torch.autograd.Function):
    """A parameter's compute layout from this rank's shard: gathered
    forward; backward, the cotangent reduced to the shard at once, so no
    whole gradient outlives its layer's backward."""

    @staticmethod
    def forward(ctx, shard, leaf, zero):
        ctx.leaf, ctx.zero = leaf, zero
        return zero.gather(shard, leaf)

    @staticmethod
    def backward(ctx, g):
        return ctx.zero.reduce(g, ctx.leaf), None, None


class _Zero3:
    """The sharded step's parameter movement (ZeRO-3): each layer's
    parameters gathered just before it runs (``lm.loss_fn``'s ``fetch``),
    their gradients reduced to the shards as the backward makes them, and,
    while the forward runs (:meth:`hooks`), a gathered parameter kept out
    of autograd's saved tensors: a tensor on its storage is saved as the
    shard and gathered again when the backward reads it.  So a rank holds
    one layer's whole parameters at a time, besides its shards."""

    def __init__(self, mesh: Any, batch_axes: tuple[str, ...], leaves: Any):
        self.mesh, self.batch_axes, self.leaves = mesh, batch_axes, leaves
        self.live: dict = {}

    def gather(self, shard: torch.Tensor, leaf: _Leaf) -> torch.Tensor:
        return collectives.gather(shard, leaf.gspec, self.mesh)

    def reduce(self, g: torch.Tensor, leaf: _Leaf) -> torch.Tensor:
        return _reduce_grad(g, leaf.pspec, leaf.keep, self.mesh,
                            self.batch_axes)

    def _one(self, shard: torch.Tensor, leaf: _Leaf) -> torch.Tensor:
        whole = _Fetch.apply(shard, leaf, self)
        key = whole.untyped_storage().data_ptr()
        if key != shard.untyped_storage().data_ptr():   # a gather, not
            self.live[key] = (weakref.ref(whole), shard, leaf)  # the shard
        return whole

    def fetch(self, path: tuple, tree: Any) -> Any:
        """``tree`` (shards of the parameters under ``path``; one layer of
        a stacked subtree) in its compute layout."""
        leaves = self.leaves
        for k in path:
            leaves = leaves[k]
        return zip_map(self._one, tree, leaves)

    def _pack(self, t: torch.Tensor) -> Any:
        hit = self.live.get(t.untyped_storage().data_ptr())
        if hit is None:
            return t
        whole = hit[0]()
        if whole is None or whole.dtype != t.dtype:
            return t
        return (hit[1], hit[2], t.size(), t.stride(), t.storage_offset())

    def _unpack(self, packed: Any) -> torch.Tensor:
        if isinstance(packed, torch.Tensor):
            return packed
        shard, leaf, size, stride, offset = packed
        return self.gather(shard, leaf).as_strided(size, stride, offset)

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        self._unpack)


#: The parameter subtrees ``lm`` fetches a layer at a time (``blocks`` and
#: ``tail`` stacked over layers, ``shared_attn`` at each use); every other
#: top-level leaf (embedding, head, final norm, frontend projection) is
#: gathered once a step and its whole gradient reduced after the
#: backward.
_LAYERED = ("blocks", "tail", "shared_attn")


def _layer_leaf(spec: P, keep: bool, stacked: bool) -> _Leaf:
    if stacked:
        if spec and spec[0] is not None:
            raise ValueError(f"spec {spec}: the sharded step gathers a "
                             f"layer at a time, so the layers dim stays "
                             f"whole")
        spec = P(*tuple(spec)[1:])
    return _Leaf(spec, _gather_spec(spec, keep), keep)


def make_sharded_grad_fn(cfg: ModelConfig, rt: RuntimeConfig, mesh: Any,
                         pspecs: Any) -> Callable:
    """``grads(params, batch) -> (grads, metrics)``: this rank's shards of
    the global batch's gradient (``params``: this rank's shards under
    ``pspecs``; ``batch``: the global batch), and the loss metrics of the
    global batch, the same on every rank.  The first half of
    :func:`make_sharded_train_step`'s step."""
    batch_axes = spec_axes(shd.batch_axes(mesh))
    keep = lm.tp_kept(cfg, pspecs, mesh.extent("model"))
    tp = any(base.tree_leaves(keep))
    rt_step = dataclasses.replace(rt, tp_axis="model") if tp else rt
    leaves = {k: zip_map(lambda s, f, st=k in ("blocks", "tail"):
                         _layer_leaf(s, f, st), pspecs[k], keep[k])
              for k in pspecs}
    n_batch = 1
    for a in batch_axes:
        n_batch *= mesh.extent(a)

    def grads_fn(params, batch):
        bspecs = _maybe_batch_spec(batch, mesh)
        local_batch = {k: collectives.shard(v, bspecs[k], mesh)
                       for k, v in batch.items()}
        split = any(s[0] is not None for s in bspecs.values())
        zero = _Zero3(mesh, batch_axes if n_batch > 1 else (), leaves)
        top = [k for k in sorted(params) if k not in _LAYERED]
        with torch.no_grad():
            whole = {k: zip_map(lambda p, lf: zero.gather(p, lf), params[k],
                                leaves[k]) for k in top}
        with torch.enable_grad(), collectives.region(
                mesh, batch_axes if n_batch > 1 and split else ()):
            live = base.tree_map(lambda p: p.detach().requires_grad_(),
                                 {**params, **whole})
            del whole
            flat = base.tree_leaves(live)
            with zero.hooks():
                loss, metrics = lm.loss_fn(live, local_batch, cfg, rt_step,
                                           fetch=zero.fetch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = _unflatten(params, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(flat, grads)])
        del live, flat
        with torch.no_grad():
            # the layers' gradients are shards already (_Fetch); the
            # top-level leaves' are whole, and this step's own
            for k in top:
                grads[k] = zip_map(lambda g, lf: _reduce_grad(
                    g, lf.pspec, lf.keep, mesh, zero.batch_axes,
                    owned=True), grads[k], leaves[k])
        # shard-local metrics (loss, nll, aux) become the batch-axes mean
        names = sorted(metrics)
        local_m = torch.stack([metrics[k].detach().float().reshape(())
                               for k in names])
        for a in batch_axes:
            collectives.all_reduce(local_m, mesh, a)
        local_m.div_(n_batch)
        return grads, dict(zip(names, local_m.unbind()))

    return grads_fn


def make_sharded_train_step(cfg: ModelConfig, rt: RuntimeConfig,
                            opt_cfg: adamw.AdamWConfig, mesh: Any,
                            pspecs: Any) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    over the shards of ``pspecs`` (repaired specs, as
    ``repair_specs(param_specs(axes, rules, mesh))`` gives them): the
    module docstring's step.  ``params`` and ``opt_state`` hold this
    rank's shards (:func:`shard_tree`) and are updated in place;
    ``batch`` is the global batch.  Every rank returns the same
    metrics: the losses averaged over the batch axes, AdamW's
    ``grad_norm`` and ``lr``."""
    grads_fn = make_sharded_grad_fn(cfg, rt, mesh, pspecs)

    def step(params, opt_state, batch):
        grads, metrics = grads_fn(params, batch)
        with torch.no_grad():
            gnorm = sharded_grad_norm(grads, pspecs, mesh)
        params, opt_state, opt_metrics = adamw.update(
            opt_cfg, grads, opt_state, params, grad_norm=gnorm)
        metrics.update({k: v.detach() for k, v in opt_metrics.items()})
        return params, opt_state, metrics

    return step
