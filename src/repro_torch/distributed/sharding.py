"""Logical-axis -> mesh-axis sharding rules, ported from
``repro/distributed/sharding.py``.

Models annotate parameters with logical axes (``param_axes`` beside each
layer's ``init``; :func:`repro_torch.models.lm.param_axes` for a whole
model); this module turns an axes tree into a
:class:`~repro_torch.core.partition.PartitionSpec` tree for a mesh.  The
default rule set:

    heads / kv_heads / ffn / vocab  -> "model"   (tensor parallelism)
    fsdp                            -> "data"    (ZeRO-3 parameter sharding)
    experts                         -> "data"    (expert parallelism)
    layers                          -> None      (the stacked layer axis)

Multi-pod meshes add a leading "pod" axis; by default it extends data
parallelism (batch sharded over ("pod", "data")), with parameters *not*
sharded over "pod" (each pod keeps a full FSDP shard set, so cross-pod
traffic is only the gradient reduction).  ``fsdp_over_pod=True`` folds
"pod" into the FSDP axis instead.

Every function reads only a mesh's ``axis_names`` and per-axis extents
(through :meth:`~repro_torch.core.partition.MeshAxes.from_mesh`), so the
port's :class:`~repro_torch.launch.mesh.Mesh`, a
:class:`~repro_torch.core.partition.MeshAxes` or any object with
``axis_names`` and a ``shape`` (a tuple, or a dict of extents) will do.
The JAX package's ``param_shardings`` has no counterpart: it wraps each
spec in a ``NamedSharding`` for ``jax.jit``, and the port's sharded step
(:func:`repro_torch.launch.steps.make_sharded_train_step`) reads the
specs themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.partition import MeshAxes, PartitionSpec as P
from repro_torch.layers import base


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    tp_axes: tuple[str, ...] = ("heads", "kv_heads", "ffn", "vocab")
    fsdp: bool = True
    fsdp_over_pod: bool = False
    expert_axis: str = "data"

    def mesh_axis_for(self, logical: str | None, mesh: Any) -> Any:
        names = MeshAxes.from_mesh(mesh).names
        if logical is None or logical == "layers":
            return None
        if logical in self.tp_axes:
            return "model" if "model" in names else None
        if logical == "fsdp":
            if not self.fsdp:
                return None
            if self.fsdp_over_pod and "pod" in names:
                return ("pod", "data")
            return "data" if "data" in names else None
        if logical == "experts":
            ax = self.expert_axis
            return ax if ax in names else None
        raise ValueError(f"unknown logical axis {logical!r}")


def spec_for_axes(axes: tuple[str | None, ...], rules: ShardingRules,
                  mesh: Any) -> P:
    """A PartitionSpec, dropping conflicts: a mesh axis may appear at most
    once per spec (the first logical dim wins)."""
    used: set[str] = set()
    parts = []
    for logical in axes:
        ax = rules.mesh_axis_for(logical, mesh)
        if ax is None:
            parts.append(None)
            continue
        flat = ax if isinstance(ax, tuple) else (ax,)
        if any(a in used for a in flat):
            parts.append(None)
            continue
        used.update(flat)
        parts.append(ax)
    return P(*parts)


def param_specs(axes_tree: Any, rules: ShardingRules, mesh: Any) -> Any:
    """:func:`spec_for_axes` over every leaf of an axes tree."""
    return base.axes_map(lambda axes: spec_for_axes(axes, rules, mesh),
                         axes_tree)


def repair_spec(shape: tuple[int, ...], spec: P, mesh: Any) -> P:
    """Drop mesh axes that do not evenly divide their dim extent.

    Production meshes are fixed (16x16 / 2x16x16) while arch dims come from
    the literature verbatim (vocab=50280, 40 experts, ...).  Rather than
    pad tensors (which changes numerics at the loss softmax) the offending
    dim is replicated and the rest of the spec kept.  For a tuple entry the
    divisible prefix is kept."""
    extent_of = MeshAxes.from_mesh(mesh).extent
    parts: list = []
    for dim, entry in zip(shape,
                          tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            parts.append(None)
            continue
        flat = entry if isinstance(entry, tuple) else (entry,)
        kept: list[str] = []
        extent = 1
        for a in flat:
            if dim % (extent * extent_of(a)) == 0:
                kept.append(a)
                extent *= extent_of(a)
            else:
                break
        parts.append(tuple(kept) if len(kept) > 1
                     else (kept[0] if kept else None))
    return P(*parts)


def repair_specs(shapes_tree: Any, specs_tree: Any, mesh: Any) -> Any:
    """Tree-wise :func:`repair_spec`; ``shapes_tree`` leaves need
    ``.shape`` (tensors, or anything shaped)."""
    if isinstance(specs_tree, dict):
        return {k: repair_specs(shapes_tree[k], specs_tree[k], mesh)
                for k in sorted(specs_tree)}
    return repair_spec(tuple(shapes_tree.shape), specs_tree, mesh)


def batch_axes(mesh: Any) -> Any:
    """Mesh axes the global batch dim is sharded over."""
    return ("pod", "data") if "pod" in MeshAxes.from_mesh(mesh).names \
        else "data"


def batch_spec(batch: dict, mesh: Any) -> dict:
    """Shard every batch array on its leading (batch) dim."""
    ax = batch_axes(mesh)
    return {k: P(ax, *([None] * (len(x.shape) - 1)))
            for k, x in batch.items()}


def opt_state_specs(pspecs: Any, mesh: Any) -> dict:
    """AdamW moments shard like their params; the count is replicated."""
    return {"mu": pspecs, "nu": pspecs, "count": P()}


def cache_spec(cache: Any, mesh: Any) -> Any:
    """Decode caches: batch dim sharded over data axes; the KV sequence dim
    over model (sequence-parallel KV: each model shard scores its slice of
    the cache, and the softmax statistics and partial outputs reduce over
    model, not the cache gathered).

    Cache dataclasses that declare ``CACHE_AXES`` are sharded from their
    declaration: the slot dim over the data axes, a declared KV-head dim
    over "model" when divisible, and pool leaves never over the batch axes
    (shared physical blocks: per-shard writes into slot-partitioned
    replicas would diverge): the port's ``KVCache``, ``PagedKVCache``
    and ``MambaCache`` declare theirs, the protocol
    :func:`repro_torch.core.partition.plan_decode_cache` reads.  Plain
    trees take the shape heuristics:

      KV k/v   : (layers, B, G, S, hd)  -> (None, data, None, model, None)
      KV length: (layers, B)            -> (None, data)
      Mamba conv : (layers, B, cw-1, C) -> (None, data, None, model)
      Mamba state: (layers, B, H, N, P) -> (None, data, model, None, None)

    The kv-head dim G is model-sharded on the heuristic path only where it
    divides the model extent; otherwise the sequence dim is, where
    decode's memory traffic lives.  Dataclass caches come back as the same
    class with a spec in each field; leaves need ``.shape``."""
    axes = MeshAxes.from_mesh(mesh)
    ax = batch_axes(mesh)
    model = axes.extent("model")

    def declared_spec(x, decl):
        rank = len(x.shape)
        parts: list = [None] * rank
        slot = decl.get("slot")
        if slot is not None and not decl.get("pool"):
            parts[slot % rank] = ax
        md = decl.get("model")
        if (md is not None and model > 1
                and x.shape[md % rank] % model == 0):
            parts[md % rank] = "model"
        return P(*parts)

    def leaf_spec(x):
        ndim = len(x.shape)
        if ndim == 5:
            if x.shape[3] >= 1024:               # kv cache (layers,B,G,S,hd)
                if x.shape[2] % model == 0:      # G divisible: head-sharded
                    return P(None, ax, "model", None, None)
                return P(None, ax, None, "model", None)  # else: shard S
            return P(None, ax, "model", None, None)   # ssm state: shard H
        if ndim == 4:          # mamba conv (layers, B, cw-1, C)
            return P(None, ax, None, "model")
        if ndim == 2:          # lengths (layers, B)
            return P(None, ax)
        return P(*([None] * ndim))

    def node(n):
        if isinstance(n, dict):
            return {k: node(v) for k, v in n.items()}
        decl = getattr(type(n), "CACHE_AXES", None)
        if decl is not None:
            return type(n)(**{f: declared_spec(getattr(n, f), d)
                              for f, d in decl.items()})
        if dataclasses.is_dataclass(n):
            return type(n)(**{f.name: node(getattr(n, f.name))
                              for f in dataclasses.fields(n)})
        return leaf_spec(n)

    return node(cache)
