"""Mesh partition planner: sharded depth-first execution for ``optimize()``,
ported from ``repro/core/partition.py``.

BrainSlug's depth-first collapse wins by shrinking the working set to fit
fast memory; on a mesh of ranks the same resource argument applies *per
shard*.  This module derives, from an ``OptimizeConfig``'s ``mesh`` and
``partition``, the :class:`PartitionSpec` of every stack input and output
and every registry-kernel operand, and the **per-shard** shapes the
collapser must size its tiles against (a batch-sharded stack sees 1/N of
its rows on each rank; a head-sharded flash attention 1/N of its heads).

A dim is sharded only when

* the partition mode asks for it (``data`` shards the leading batch or row
  dim over the ``"data"`` axis; ``tensor`` shards head and feature dims
  over ``"model"``; ``both`` does both),
* its extent divides the axis extent exactly (no padding: padding changes
  numerics at norms and softmaxes),
* the region stays shard-local under the split: ``ROW_NORM`` and
  ``ROW_SOFTMAX`` fence feature sharding, vocab-CE fences vocab sharding,
  attention fences key sequence sharding.  A split that would need a
  collective *inside* a kernel is never emitted (``dist.collective-
  placement``, which the verifier re-checks).

Anything that fails these tests is replicated, never mis-sharded.

The serving engine's decode cache has a planner of its own,
:func:`plan_decode_cache`: slots over ``"data"`` (dense layout only),
KV heads over ``"model"``, from the ``CACHE_AXES`` the cache dataclasses
declare.

The planner and the ``dist.*`` verifier reason about :class:`MeshAxes`, the
(axis name, extent) skeleton of a mesh, so ``repro_torch.lint`` checks
every shipped arch against a production-shaped mesh in one process; only
codegen's sharded call needs a live :class:`repro_torch.launch.mesh.Mesh`.

:class:`PartitionSpec` stands in for ``jax.sharding.PartitionSpec``: a
tuple, one entry per dim, each an axis name, a tuple of axis names or
``None``, compared as a tuple.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.core import ir

#: Partition modes OptimizeConfig.partition accepts.
PARTITIONS = ("none", "data", "tensor", "both")

#: Mesh axis names the planner assigns work to.
DATA_AXIS = "data"
MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """Per-dim mesh axes of one operand: ``PartitionSpec("data", None)``
    shards dim 0 over ``"data"`` and keeps dim 1 whole.  A tuple, so two
    specs (or a spec and ``tuple(jax_spec)``) compare entry by entry."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    __str__ = __repr__


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """The shape skeleton of a mesh: axis names and extents, no ranks.

    The partition planner and the ``dist.*`` verifier reason about this,
    so ``repro_torch.lint`` can check every shipped arch against a
    production-shaped mesh in one process.  Build one from a live mesh
    with :meth:`from_mesh`."""

    names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.names) != len(self.shape):
            raise ValueError(
                f"mesh axes/shape mismatch: {self.names} vs {self.shape}")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"non-positive mesh axis extent in {self.shape}")

    @classmethod
    def from_mesh(cls, mesh: Any) -> "MeshAxes":
        """From a :class:`MeshAxes` (itself), the port's
        :class:`~repro_torch.launch.mesh.Mesh`, or anything with
        ``axis_names`` and a per-axis ``shape``."""
        if isinstance(mesh, MeshAxes):
            return mesh
        names = tuple(mesh.axis_names)
        shape = mesh.shape
        if isinstance(shape, Mapping):
            return cls(names, tuple(int(shape[a]) for a in names))
        return cls(names, tuple(int(s) for s in shape))

    def extent(self, name: str) -> int:
        """Extent of axis ``name``; 1 when the mesh has no such axis."""
        try:
            return self.shape[self.names.index(name)]
        except ValueError:
            return 1

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def replicated(rank: int) -> PartitionSpec:
    return PartitionSpec(*([None] * rank))


def data_extent(axes: MeshAxes, partition: str) -> int:
    return axes.extent(DATA_AXIS) if partition in ("data", "both") else 1


def model_extent(axes: MeshAxes, partition: str) -> int:
    return axes.extent(MODEL_AXIS) if partition in ("tensor", "both") else 1


def spec_axes(entry) -> tuple[str, ...]:
    """The axis names one spec entry shards over (``()`` for ``None``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_factors(spec, axes: MeshAxes) -> tuple[int, ...]:
    """Per-dim divide factor a spec implies on ``axes``."""
    factors = []
    for entry in tuple(spec):
        f = 1
        for a in spec_axes(entry):
            f *= axes.extent(a)
        factors.append(f)
    return tuple(factors)


def shard_shapes(shapes: Mapping[str, tuple[int, ...]],
                 specs: Mapping[str, Any],
                 axes: MeshAxes) -> dict[str, tuple[int, ...]]:
    """Per-shard view of ``shapes`` under ``specs``: what one rank's
    sharded call sees, and therefore what the collapser sizes tiles
    against."""
    out: dict[str, tuple[int, ...]] = {}
    for name, shape in shapes.items():
        spec = specs.get(name)
        out[name] = (tuple(shape) if spec is None
                     else shard_shape(shape, spec, axes))
    return out


def shard_shape(shape: tuple[int, ...], spec, axes: MeshAxes
                ) -> tuple[int, ...]:
    """Per-shard shape of one operand under ``spec``."""
    factors = spec_factors(spec, axes)
    factors = factors + (1,) * (len(shape) - len(factors))
    return tuple(d // f for d, f in zip(shape, factors))


# ---------------------------------------------------------------------------
# Stack partitioning (fused depth-first regions).
# ---------------------------------------------------------------------------

#: Op kinds that reduce over the trailing (feature) axis: a feature split
#: across one would need an in-kernel collective, so they fence ``tensor``
#: sharding of rows-layout stacks.
_FEATURE_REDUCING = frozenset({ir.OpKind.ROW_NORM, ir.OpKind.ROW_SOFTMAX})


@dataclasses.dataclass(frozen=True)
class SegmentPartition:
    """The partition decision for one compiled segment (stack or kernel).

    ``in_specs`` / ``out_specs`` are the sharded call's boundary specs;
    ``param_specs`` covers the parameter leaves the region reads (always
    replicated: parameters are broadcast).  ``active`` is False when every
    operand ended up replicated: codegen then skips the sharded call (a
    replicated region is pure overhead)."""

    in_specs: dict[str, Any]
    out_specs: dict[str, Any]
    param_specs: dict[str, Any]
    shard_shapes: dict[str, tuple[int, ...]]
    notes: tuple[str, ...] = ()

    @property
    def active(self) -> bool:
        return any(p is not None for s in (*self.in_specs.values(),
                                           *self.out_specs.values())
                   for p in tuple(s))


def stack_param_names(program: ir.StackProgram) -> tuple[str, ...]:
    """Parameter names a stack executor reads (scale/bias constants bound
    at trace time, broadcast into the region)."""
    return tuple(program.param_names)


def _rows_shard_ok(shape: tuple[int, ...], n: int, sublane: int) -> bool:
    """A leading-dim split is legal when the extent divides and each shard
    keeps whole sublanes of rows."""
    if not shape or shape[0] % n:
        return False
    rows = 1
    for d in shape[:-1]:
        rows *= d
    return (rows // n) % sublane == 0 or (rows // n) >= sublane


def plan_stack(program: ir.StackProgram,
               in_shapes: Mapping[str, tuple[int, ...]],
               param_shapes: Mapping[str, tuple[int, ...]] | None,
               partition: str, axes: MeshAxes, *,
               sublane: int = 8) -> SegmentPartition:
    """Derive the sharded call's boundary specs of one fused stack.

    rows layout: the leading (row/batch) dim shards over ``"data"``; the
    trailing feature dim over ``"model"`` only when no op reduces along
    features.  nhwc layout: the batch dim over ``"data"``; the channel dim
    over ``"model"`` (every nhwc op is channel-local).  An operand that
    fails divisibility replicates the whole stack: a half-sharded region
    would reshard at every boundary."""
    shapes = dict(ir.infer_shapes(program, in_shapes))
    n_data = data_extent(axes, partition)
    n_model = model_extent(axes, partition)
    notes: list[str] = []

    feature_ok = n_model > 1 and not any(
        op.kind in _FEATURE_REDUCING for op in program.ops)
    if n_model > 1 and not feature_ok:
        notes.append("feature split fenced: program reduces along features")

    boundary = (*program.inputs, *program.outputs)
    # The row split must agree across every non-broadcast operand.
    row_dims = {shapes[v][0] for v in boundary
                if len(shapes[v]) >= 2 and shapes[v][0] != 1}
    rows_ok = (n_data > 1 and len(row_dims) == 1 and all(
        _rows_shard_ok(shapes[v], n_data, sublane) for v in boundary
        if len(shapes[v]) >= 2 and shapes[v][0] != 1))
    if n_data > 1 and not rows_ok:
        notes.append(f"row split fenced: leading dims {sorted(row_dims)} "
                     f"not cleanly divisible by data={n_data}")

    feat_dims = {shapes[v][-1] for v in boundary if len(shapes[v]) >= 1}
    feature_ok = feature_ok and len(feat_dims) == 1 and all(
        d % n_model == 0 and (d // n_model) % sublane == 0
        for d in feat_dims)

    def spec_for(shape: tuple[int, ...]) -> PartitionSpec:
        parts: list = [None] * len(shape)
        if rows_ok and len(shape) >= 2 and shape[0] != 1:
            parts[0] = DATA_AXIS
        if feature_ok and len(shape) >= 1:
            parts[-1] = MODEL_AXIS
        return PartitionSpec(*parts)

    in_specs = {v: spec_for(tuple(shapes[v])) for v in program.inputs}
    out_specs = {v: spec_for(tuple(shapes[v])) for v in program.outputs}

    # Parameters broadcast into the region, replicated, but for a
    # per-feature vector under a feature split: it is split with the
    # features it scales (the JAX planner replicates it, handing each shard
    # all F entries against F/n features).  A stack whose param rank is
    # unknown cannot be wrapped: replicate it whole.
    feature = next(iter(feat_dims)) if feature_ok else None
    param_specs: dict[str, Any] = {}
    for name in stack_param_names(program):
        shape = None
        if param_shapes is not None and name in param_shapes:
            shape = param_shapes[name]
        elif name in shapes:
            shape = shapes[name]
        if shape is None:
            notes.append(f"param {name!r} has no recorded shape; replicated")
            in_specs = {v: replicated(len(shapes[v])) for v in program.inputs}
            out_specs = {v: replicated(len(shapes[v]))
                         for v in program.outputs}
            param_specs = {}
            break
        param_specs[name] = (
            PartitionSpec(*([None] * (len(shape) - 1)), MODEL_AXIS)
            if shape and shape[-1] == feature else replicated(len(shape)))

    # Per-shard shapes: shard the boundary operands, then re-infer the
    # intermediates from the sharded inputs (they shrink with the rows).
    shard_inputs = shard_shapes(
        {v: tuple(shapes[v]) for v in program.inputs}, in_specs, axes)
    per_shard = dict(ir.infer_shapes(program, shard_inputs))
    return SegmentPartition(in_specs=in_specs, out_specs=out_specs,
                            param_specs=param_specs,
                            shard_shapes=per_shard, notes=tuple(notes))


# ---------------------------------------------------------------------------
# Registry-kernel partitioning.
# ---------------------------------------------------------------------------

def plan_kernel(op: ir.OpNode, partition: str, axes: MeshAxes,
                *, sublane: int = 8) -> SegmentPartition:
    """Derive per-slot specs for one registry KERNEL op.

    Legal splits per kernel (everything else replicates):

    =========  =========================  ===========================
    kernel     data ("data" axis)         tensor ("model" axis)
    =========  =========================  ===========================
    attention  batch dim of q/k/v/out     head dim of q/k/v/out (BHSD)
    rmsnorm    leading row dim of x/out   (trailing-axis reduction)
    swiglu     leading row dim            feature dim (elementwise)
    vocab_ce   token rows of h/labels     (log-sum-exp over vocab)
    =========  =========================  ===========================
    """
    kernel = op.attrs["kernel"]
    arg_shapes = tuple(tuple(s) for s in op.attrs["arg_shapes"])
    out_shape = tuple(op.attrs["out_shape"])
    n_data = data_extent(axes, partition)
    n_model = model_extent(axes, partition)
    notes: list[str] = []

    arg_parts = [[None] * len(s) for s in arg_shapes]
    out_parts: list = [None] * len(out_shape)

    def try_split(axis: str, n: int, slot_dims: dict[int, int],
                  out_dim: int | None, what: str,
                  align_quotient: bool = False) -> None:
        """Shard dim ``slot_dims[i]`` of slot i (and ``out_dim`` of the
        output) over ``axis``: all or nothing across the listed slots."""
        if n <= 1:
            return
        ok = all(arg_shapes[i][d] % n == 0
                 and (not align_quotient
                      or (arg_shapes[i][d] // n) % sublane == 0)
                 for i, d in slot_dims.items())
        if out_dim is not None:
            ok = ok and out_shape[out_dim] % n == 0
        if not ok:
            notes.append(f"{kernel}: {what} not divisible by "
                         f"{axis}={n}; replicated")
            return
        for i, d in slot_dims.items():
            arg_parts[i][d] = axis
        if out_dim is not None:
            out_parts[out_dim] = axis

    def try_data(slot_dims, out_dim):
        try_split(DATA_AXIS, n_data, slot_dims, out_dim, "batch/rows")

    def try_model(slot_dims, out_dim, *, align_quotient=False):
        try_split(MODEL_AXIS, n_model, slot_dims, out_dim,
                  "head/feature dim", align_quotient)

    if kernel == "attention":
        # slots: q, k, v: (B, H, S, D) or single-head (B, S, D)
        try_data({i: 0 for i in range(3)}, 0)
        if all(len(s) == 4 for s in arg_shapes) and len(out_shape) == 4:
            try_model({i: 1 for i in range(3)}, 1)
    elif kernel == "rmsnorm":
        # slots: x (..., F), gain (F,): rows shard, features fenced.  A
        # gain broadcast to x's full shape carries the row dim too.
        if len(arg_shapes[0]) >= 2:
            rows = {0: 0}
            if (len(arg_shapes) > 1
                    and len(arg_shapes[1]) == len(arg_shapes[0])
                    and arg_shapes[1][0] == arg_shapes[0][0]):
                rows[1] = 0
            try_data(rows, 0)
    elif kernel == "swiglu":
        # slots: gate, up: (..., F) elementwise
        if len(arg_shapes[0]) >= 2:
            try_data({0: 0, 1: 0}, 0)
        try_model({0: len(arg_shapes[0]) - 1, 1: len(arg_shapes[1]) - 1},
                  len(out_shape) - 1, align_quotient=True)
    elif kernel == "vocab_ce":
        # slots: h (T, D), w, labels (T,): token rows shard; the vocab
        # log-sum-exp fences both the D and V dims
        try_data({0: 0, 2: 0}, 0)
    else:
        notes.append(f"unknown kernel {kernel!r}: replicated")

    in_specs = {f"arg{i}": PartitionSpec(*p) for i, p in enumerate(arg_parts)}
    out_specs = {op.output: PartitionSpec(*out_parts)}
    per_shard = shard_shapes(
        {f"arg{i}": s for i, s in enumerate(arg_shapes)}, in_specs, axes)
    per_shard[op.output] = shard_shape(out_shape, out_specs[op.output], axes)
    return SegmentPartition(in_specs=in_specs, out_specs=out_specs,
                            param_specs={}, shard_shapes=per_shard,
                            notes=tuple(notes))


# ---------------------------------------------------------------------------
# Whole-compile planning (one entry point for core.api.compile_stacks).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Partition decisions for every shardable segment of one compile."""

    axes: MeshAxes
    partition: str
    segments: dict[int, SegmentPartition]

    def get(self, idx: int) -> SegmentPartition | None:
        return self.segments.get(idx)


def plan_segments(segments, shapes: Mapping[str, tuple[int, ...]],
                  param_shapes: Mapping[str, tuple[int, ...]] | None,
                  partition: str, mesh: Any, *,
                  sublane: int = 8) -> PartitionPlan:
    """Partition every stack and registry-kernel segment of a compile.

    OPAQUE and backbone segments take no entry.  In the JAX package XLA's
    partitioner places them from the neighbouring shardings; here they run
    on the replicated global tensors in every rank (each sharded call
    gathers its outputs), so their work is not split."""
    axes = MeshAxes.from_mesh(mesh)
    plans: dict[int, SegmentPartition] = {}
    if partition == "none":
        return PartitionPlan(axes=axes, partition=partition, segments=plans)
    for idx, seg in enumerate(segments):
        if seg.is_stack:
            in_shapes = {v: tuple(shapes[v]) for v in seg.stack.inputs}
            plans[idx] = plan_stack(seg.stack, in_shapes, param_shapes,
                                    partition, axes, sublane=sublane)
        elif seg.op.kind == ir.OpKind.KERNEL:
            plans[idx] = plan_kernel(seg.op, partition, axes,
                                     sublane=sublane)
    return PartitionPlan(axes=axes, partition=partition, segments=plans)


# ---------------------------------------------------------------------------
# Serving decode-cache planning (the mesh engine's step).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeLeaf:
    """One cache leaf's partition decision.

    ``path`` is the "/"-joined path in the cache tree; ``kind`` is
    ``"slot"`` (per-slot state: dense KV columns, lengths, the mamba conv
    window and SSM state), ``"pool"`` (a block pool every slot shares) or
    ``"opaque"`` (a leaf with no ``CACHE_AXES`` declaration, always
    replicated); ``slot_dim`` / ``model_dim`` are the resolved
    non-negative dims (None where the leaf does not carry that extent).
    """

    path: str
    kind: str
    shape: tuple[int, ...]
    spec: Any
    slot_dim: int | None = None
    model_dim: int | None = None


@dataclasses.dataclass(frozen=True)
class DecodeCachePlan:
    """Partition of the engine's decode cache and step operands.

    Built by :func:`plan_decode_cache` from the ``CACHE_AXES``
    declarations of the cache dataclasses (``layers.attention.KVCache`` /
    ``PagedKVCache``, ``layers.mamba2.MambaCache``): per field, the
    *negative* dim that carries the slot extent and the one that carries
    the KV-head extent, so one declaration covers a layer's node and the
    engine's (L, ...)-stacked leaves.

    ``use_data``: slots split over ``"data"``.  Sound only for the dense
    layout: the paged pools have no slot dim (every slot writes into one
    shared pool), so ranks that split the slots while each holds a pool
    would let the pools diverge after the first write (the
    ``dist.serve-pool-write`` invariant).

    ``use_model``: KV-head dims split over ``"model"`` (attention tensor
    parallelism; each rank runs ``lm.tp_local_config``'s head counts and
    the out-projection's partial sums are all-reduced over the axis).
    """

    axes: MeshAxes
    partition: str
    slots: int
    use_data: bool
    use_model: bool
    leaves: tuple[DecodeLeaf, ...]
    notes: tuple[str, ...] = ()

    @property
    def active(self) -> bool:
        return self.use_data or self.use_model

    def spec_tree(self, cache: Any) -> Any:
        """A tree of :class:`PartitionSpec` congruent with ``cache``,
        rebuilt from the per-leaf plan: a declared cache dataclass comes
        back as its class with a spec in each field."""
        specs = {leaf.path: leaf.spec for leaf in self.leaves}

        def build(node, path):
            decl = getattr(type(node), "CACHE_AXES", None)
            if decl is not None:
                return type(node)(**{
                    f: specs["/".join((*path, f))] for f in decl})
            if isinstance(node, Mapping):
                return {k: build(node[k], (*path, str(k))) for k in node}
            if hasattr(node, "shape"):
                return specs.get("/".join(path),
                                 replicated(len(node.shape)))
            raise TypeError(
                f"unrecognized cache node at {'/'.join(path) or '<root>'}: "
                f"{type(node).__name__}")

        return build(cache, ())

    def operand_spec(self, rank: int, *,
                     slot_dim: int | None = 0) -> PartitionSpec:
        """Spec of one step operand: ``slot_dim`` (its per-slot batch dim)
        splits over "data" exactly when the cache slots do; ``None``
        means the operand has no slot dim and is replicated."""
        parts: list = [None] * rank
        if self.use_data and slot_dim is not None and rank:
            parts[slot_dim] = DATA_AXIS
        return PartitionSpec(*parts)


def _resolve_dim(decl_dim: int | None, rank: int) -> int | None:
    if decl_dim is None:
        return None
    dim = decl_dim + rank if decl_dim < 0 else decl_dim
    return dim if 0 <= dim < rank else None


def plan_decode_cache(cache: Any, partition: str, axes: Any, *,
                      slots: int,
                      head_extents: tuple[int, ...] = ()) -> DecodeCachePlan:
    """The serving partition of a decode cache tree.

    ``partition`` is one of :data:`PARTITIONS` or ``"auto"`` (every split
    that is sound); ``head_extents`` are extents that must divide the
    "model" axis for the head split to engage (the engine passes
    ``(cfg.n_heads, cfg.n_kv_heads)``: the rank-local config divides
    both).  Only ``.shape`` and the node types are read, so a cache built
    on the ``meta`` device will do.  A split that fails a soundness test
    is left out with a note, never applied wrongly.
    """
    axes = MeshAxes.from_mesh(axes)
    if partition not in (*PARTITIONS, "auto"):
        raise ValueError(f"unknown serve partition {partition!r}; allowed: "
                         f"{(*PARTITIONS, 'auto')}")
    eff = "both" if partition == "auto" else partition
    n_data = data_extent(axes, eff)
    n_model = model_extent(axes, eff)
    notes: list[str] = []
    # (path, kind, shape, slot_dim, model_dim)
    raw: list[tuple[str, str, tuple[int, ...], int | None, int | None]] = []

    def walk(node, path):
        decl = getattr(type(node), "CACHE_AXES", None)
        if decl is not None:
            for field, d in decl.items():
                shape = tuple(getattr(node, field).shape)
                raw.append(("/".join((*path, field)),
                            "pool" if d.get("pool") else "slot", shape,
                            _resolve_dim(d.get("slot"), len(shape)),
                            _resolve_dim(d.get("model"), len(shape))))
            return
        if isinstance(node, Mapping):
            for k in node:
                walk(node[k], (*path, str(k)))
            return
        if hasattr(node, "shape"):
            raw.append(("/".join(path), "opaque", tuple(node.shape), None,
                        None))
            return
        raise TypeError(
            f"unrecognized cache node at {'/'.join(path) or '<root>'}: "
            f"{type(node).__name__}")

    walk(cache, ())
    kinds = {kind for _, kind, *_ in raw}

    use_data = n_data > 1
    if use_data and "pool" in kinds:
        use_data = False
        notes.append("slot split fenced: physical pool leaves are shared "
                     "across slots (per-shard scatter writes into a "
                     "replicated pool would diverge)")
    if use_data and "opaque" in kinds:
        use_data = False
        notes.append("slot split fenced: cache holds leaves with no "
                     "CACHE_AXES declaration")
    if use_data and slots % n_data:
        use_data = False
        notes.append(f"slot split fenced: {slots} slots not divisible by "
                     f"data={n_data}")
    if use_data and any(slot_dim is not None and shape[slot_dim] % n_data
                        for _, _, shape, slot_dim, _ in raw):
        use_data = False
        notes.append(f"slot split fenced: a slot dim does not divide "
                     f"data={n_data}")
    use_model = n_model > 1
    if use_model and any(e % n_model for e in head_extents):
        use_model = False
        notes.append(f"head split fenced: head extents {head_extents} not "
                     f"divisible by model={n_model}")
    if use_model and any(model_dim is not None and shape[model_dim] % n_model
                         for _, _, shape, _, model_dim in raw):
        use_model = False
        notes.append(f"head split fenced: a KV-head dim does not divide "
                     f"model={n_model}")

    leaves = []
    for path, kind, shape, slot_dim, model_dim in raw:
        parts: list = [None] * len(shape)
        if use_data and slot_dim is not None:
            parts[slot_dim] = DATA_AXIS
        if use_model and model_dim is not None:
            parts[model_dim] = MODEL_AXIS
        leaves.append(DecodeLeaf(path=path, kind=kind, shape=shape,
                                 spec=PartitionSpec(*parts),
                                 slot_dim=slot_dim, model_dim=model_dim))
    return DecodeCachePlan(axes=axes, partition=eff, slots=slots,
                           use_data=use_data, use_model=use_model,
                           leaves=tuple(leaves), notes=tuple(notes))


def batch_leaf_spec(shape: tuple[int, ...], partition: str,
                    axes: MeshAxes) -> PartitionSpec:
    """Placement spec for one input leaf of an optimized callable: shard
    the leading dim over "data" when it divides, else replicate."""
    n = data_extent(axes, partition)
    if n > 1 and len(shape) >= 1 and shape[0] and shape[0] % n == 0:
        return PartitionSpec(DATA_AXIS, *([None] * (len(shape) - 1)))
    return replicated(len(shape))
