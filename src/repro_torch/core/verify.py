"""Static plan verifier, ported from ``repro/core/verify.py``: proves every
compile artifact sound *before* it runs.

BrainSlug's promise is transparency: the user hands over a plain PyTorch
function and the pipeline substitutes fused depth-first kernels, registry
rewrites and autotuned variants.  The worst way such a system can fail is a
silent miscompile, so this module re-derives, independently of the code
that produced them, the invariants every compile artifact must satisfy and
reports each violation as a :class:`Finding`:

1. **Graph / program well-formedness** (``graph.*`` / ``program.*``): SSA
   def-before-use and single assignment, dead values, and shape / dtype
   inference over every :class:`~repro_torch.core.ir.OpNode`, re-derived
   from the op semantics (not by calling :func:`repro_torch.core.ir.
   infer_shapes`) and held against that function and the traced avals: a
   disagreement with ``ir.infer_shapes`` is itself a finding.
2. **CollapsePlan legality** (``plan.*``): sequence splits partition the
   program; nhwc halo arithmetic is re-derived by receptive-field interval
   composition and must match the levels the kernels use, at the plan's
   tile and at the tile each kernel picks itself (``nhwc.fused_plan``,
   ``nhwc_bwd.launch_plan``); the working set, recomputed through
   :mod:`repro_torch.core.resource`, fits the plan's device; the shared
   memory the nhwc kernels size for themselves (``nhwc.channel_block``,
   ``nhwc_bwd.desc_smem``) fits the 232,448 B a CTA may opt in to.
3. **Grid write races** (``grid.*``): the write model of each fused-stack
   kernel (``write_model`` in ``kernels/fused_stack/{rows,rows_bwd,nhwc,
   nhwc_bwd}.py``, built from the launch plan the wrapper launches) is
   enumerated over its whole grid: every live point writes inside its
   array, distinct points write disjoint blocks, and a model that claims
   its array covers every element of it.  A CUDA grid runs its programs
   concurrently, so the Pallas package's sequential-grid ``"grid-sum"``
   accumulator is always an error here; the sanctioned idioms are ``None``
   (disjoint writes), ``"overlap-slot"`` (private halo patch slots, summed
   outside the kernel) and ``"partials"`` (program ``p`` writes row ``p``
   of a partials buffer that a second kernel sums in a fixed order).
4. **Registry rewrite soundness** (``kernel.*``): every ``KERNEL`` op's id
   resolves, its slots agree with its operands, its recorded avals equal
   the traced ones and its kernel's output contract
   (:func:`repro_torch.core.registry.expected_out_shape`), and in a
   differentiable net it declares its VJP.
5. **Serving block tables** (``kv.*``): :func:`check_block_tables`, which
   the paged engine runs every tick.
6. **Mesh partitions** (``dist.*``): :func:`check_partitions` re-derives
   every committed partition spec's rank, mesh axes and divisibility,
   refuses a split of a dim its region reduces over, and refits each
   sharded stack plan's per-shard working set on the haircut device
   (:func:`repro_torch.core.resource.shard_view`).
7. **Serving decode-cache partitions** (``dist.serve-*``):
   :func:`check_decode_plan`, which ``Engine(mesh=...)`` runs on its
   :func:`repro_torch.core.partition.plan_decode_cache` plan.

The pass runs behind ``OptimizeConfig.verify`` (``"off" | "warn" |
"strict"``, default ``"warn"``) between planning and codegen, and
``python -m repro_torch.lint`` drives it over the shipped configurations.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
import warnings
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import autodiff, ir, resource
from repro_torch.core import partition as partition_mod
from repro_torch.core import registry as registry_mod
from repro_torch.kernels.fused_stack import nhwc, nhwc_bwd, rows, rows_bwd

#: Verification modes ``OptimizeConfig.verify`` and the engine accept.
VERIFY_MODES = ("off", "warn", "strict")

#: Grid points enumerated per write spec before the check degrades to a
#: truncated (warning-level) scan.  The enumeration is vectorised; every
#: shipped plan at full width is far below this.
_GRID_ENUM_CAP = 1 << 21

#: SMs of an H100 SXM: the count the write models assume off the card.
MODEL_SM_COUNT = 132

_TRACE = "src/repro_torch/core/trace.py"
_IR = "src/repro_torch/core/ir.py"
_COLLAPSE = "src/repro_torch/core/collapse.py"
_REGISTRY = "src/repro_torch/core/registry.py"
_ENGINE = "src/repro_torch/launch/engine.py"
_PARTITION = "src/repro_torch/core/partition.py"

#: invariant id -> (source module the artifact came from, description).
INVARIANTS: dict[str, tuple[str, str]] = {
    "graph.def-before-use": (
        _TRACE, "every NetGraph op reads only values already defined"),
    "graph.redefinition": (
        _TRACE,
        "no NetGraph value is assigned twice (SSA single assignment)"),
    "graph.output-undefined": (
        _TRACE, "the NetGraph output names a defined value"),
    "graph.dead-value": (
        _TRACE, "no NetGraph op output is produced but never consumed"),
    "graph.shape-mismatch": (
        _TRACE,
        "recorded traced shapes agree with re-derived op output shapes"),
    "graph.dtype-mismatch": (
        _TRACE,
        "recorded traced dtypes agree with re-derived op output dtypes"),
    "program.def-before-use": (
        _IR, "every StackProgram op reads only values already defined"),
    "program.redefinition": (
        _IR,
        "no StackProgram value is assigned twice (SSA single assignment)"),
    "program.output-undefined": (
        _IR, "every StackProgram output names a defined value"),
    "program.dead-value": (
        _IR, "no StackProgram op output is produced but never consumed"),
    "program.unknown-fn": (
        _IR,
        "every EW_UNARY/EW_BINARY/POOL2D fn exists in the semantics table"),
    "program.shape-mismatch": (
        _IR,
        "ir.infer_shapes and the recorded shapes agree with the re-derived "
        "shapes of every op"),
    "program.dtype-mismatch": (
        _IR, "recorded dtypes agree with re-derived op output dtypes"),
    "plan.partition-gap": (
        _COLLAPSE,
        "sequence splits cover every program op exactly once, in order"),
    "plan.partition-overlap": (
        _COLLAPSE, "no program op is assigned to more than one sequence"),
    "plan.budget-exceeded": (
        "src/repro_torch/core/resource.py",
        "the (joint fwd+bwd when differentiable) working set of every "
        "sequence, recomputed from the resource model, stays under the "
        "device budget, and the shared memory the nhwc kernels size for "
        "themselves fits what a CTA may opt in to"),
    "plan.tile-coverage": (
        _COLLAPSE,
        "output tiles (the plan's and the ones the kernels pick) exactly "
        "cover the output extent: no dead tiles, no uncovered positions"),
    "plan.halo-mismatch": (
        "src/repro_torch/kernels/fused_stack/nhwc.py",
        "the kernels' per-level halo extents/origins equal the receptive-"
        "field intervals re-derived from pool arithmetic"),
    "plan.missing-vjp": (
        "src/repro_torch/core/autodiff.py",
        "every op of a differentiable plan has an autodiff VJP rule"),
    "grid.write-race": (
        "src/repro_torch/kernels/fused_stack/rows.py",
        "distinct grid points write pairwise-disjoint output blocks"),
    "grid.accumulator": (
        "src/repro_torch/kernels/fused_stack/rows_bwd.py",
        "an accumulating write follows a concurrent-grid idiom: a private "
        "patch slot or one partials row per program, summed outside the "
        "kernel (never the sequential-grid shared-block sum)"),
    "grid.out-of-bounds": (
        "src/repro_torch/kernels/fused_stack/nhwc.py",
        "every live grid point's block lies inside the output array"),
    "grid.coverage": (
        "src/repro_torch/kernels/fused_stack/nhwc_bwd.py",
        "a write model that claims its array covers every element of it: "
        "the wrappers allocate outputs uninitialised"),
    "kernel.unknown": (
        _REGISTRY, "every KERNEL op's kernel id resolves to a registry entry"),
    "kernel.slots-mismatch": (
        _REGISTRY, "KERNEL slot bookkeeping is consistent with op "
        "inputs/params"),
    "kernel.aval-mismatch": (
        _REGISTRY,
        "recorded KERNEL arg/out shapes and dtypes equal the traced ones of "
        "the consumed cluster and the kernel's output contract"),
    "kernel.no-vjp": (
        _REGISTRY,
        "a KERNEL op in a differentiable net declares where its VJP comes "
        "from"),
    "kv.block-out-of-bounds": (
        _ENGINE,
        "every block id a slot table, the free list or the prefix cache "
        "holds lies inside the physical pool"),
    "kv.length-uncovered": (
        _ENGINE,
        "every slot's mapped blocks cover its logical KV length"),
    "kv.refcount-mismatch": (
        _ENGINE,
        "every block's refcount equals the number of slot tables mapping "
        "it plus its prefix-cache reference, and free blocks hold none"),
    "kv.shared-writable": (
        _ENGINE,
        "no block a dispatch is about to write is mapped by more than one "
        "owner (copy-on-write must have forked it first)"),
    "kv.freed-reachable": (
        _ENGINE,
        "no block on the free list is still reachable from a slot table "
        "or the prefix cache"),
    "dist.spec-rank": (
        _PARTITION,
        "every committed partition spec has rank <= its operand's rank and "
        "every sharded dim divides its mesh-axis extent exactly"),
    "dist.mesh-axis": (
        _PARTITION,
        "every mesh axis a committed partition spec names exists on the "
        "configured mesh"),
    "dist.vmem-refit": (
        "src/repro_torch/core/resource.py",
        "every mesh-partitioned stack plan's per-shard working set, "
        "re-derived from the global shapes and committed specs "
        "(resource.shard_view), fits the haircut per-rank budget, and the "
        "plan was collapsed against exactly that shard view"),
    "dist.collective-placement": (
        _PARTITION,
        "no committed spec shards a dim its region reduces over (norm / "
        "softmax feature axes, attention key sequence, the vocab-CE "
        "log-sum-exp): a split that would need an in-kernel collective"),
    "dist.serve-slot-axis": (
        _PARTITION,
        "every slot-bearing decode-cache leaf shards its slot dim over the "
        "same mesh axes as every other (and as the step operands): a slot "
        "split applied to only part of the per-slot state desynchronizes "
        "the shards"),
    "dist.serve-pool-write": (
        _PARTITION,
        "no physical-pool decode-cache leaf shards over the batch/data "
        "axis: the pool is shared by every slot, so per-shard writes into "
        "slot-partitioned replicas would diverge"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant check result.

    ``invariant`` is a key of :data:`INVARIANTS`; ``severity`` is
    ``"error"`` (soundness at stake: raises under ``"strict"``) or
    ``"warning"`` (recorded, never raised); ``subject`` names the offending
    op, program, plan, slot or block; ``source`` the module that produced
    the artifact."""

    invariant: str
    severity: str
    subject: str
    detail: str
    source: str = ""

    def __post_init__(self) -> None:
        if not self.source and self.invariant in INVARIANTS:
            object.__setattr__(self, "source", INVARIANTS[self.invariant][0])

    def __str__(self) -> str:
        return (f"[{self.severity}] {self.invariant} @ {self.subject}: "
                f"{self.detail} (source: {self.source or 'unknown'})")

    def to_json(self) -> dict[str, str]:
        return {"invariant": self.invariant, "severity": self.severity,
                "subject": self.subject, "detail": self.detail,
                "source": self.source}


class VerifyError(Exception):
    """Verification failed under ``"strict"``.  Carries every error
    finding; the message names the first."""

    def __init__(self, findings: Sequence[Finding]) -> None:
        self.findings = tuple(findings)
        first = self.findings[0] if self.findings else None
        head = (f"static verification found {len(self.findings)} invariant "
                f"violation(s)")
        if first is not None:
            head += f"; first: {first}"
        super().__init__(head)


@dataclasses.dataclass
class PassStats:
    """The pipeline passes run in this process (:func:`verify_segments`,
    :func:`verify_trace`, :func:`verify_graph`) and the host seconds they
    took: the verifier's cost at compile time."""

    passes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.passes, self.seconds = 0, 0.0


STATS = PassStats()


def _timed(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            STATS.passes += 1
            STATS.seconds += time.perf_counter() - t
    return run


def errors(findings: Iterable[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == "error"]


def enforce(findings: Sequence[Finding], mode: str, subject: str = "") -> None:
    """Apply the mode to a batch of findings: ``strict`` raises
    :class:`VerifyError` on any error finding, ``warn`` emits one
    :class:`UserWarning` summarising the waived errors, ``off`` does
    nothing."""
    if mode not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {mode!r}; allowed: "
                         f"{VERIFY_MODES}")
    if mode == "off":
        return
    errs = errors(findings)
    if not errs:
        return
    if mode == "strict":
        raise VerifyError(errs)
    warnings.warn(
        f"repro_torch.verify: waived {len(errs)} invariant violation(s) "
        f"(verify='warn'){' in ' + subject if subject else ''}; first: "
        f"{errs[0]}", UserWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# (1) Well-formedness: SSA, dead values, shape/dtype inference.
# ---------------------------------------------------------------------------

#: Kinds whose output shape equals their first input's shape.
_SHAPE_PASSTHROUGH = frozenset({
    ir.OpKind.EW_UNARY, ir.OpKind.AFFINE, ir.OpKind.ROW_NORM,
    ir.OpKind.ROW_SOFTMAX,
})

#: Kinds whose output dtype equals their (floating) first input's dtype.
_DTYPE_PASSTHROUGH = frozenset({
    ir.OpKind.EW_UNARY, ir.OpKind.AFFINE, ir.OpKind.ROW_NORM,
    ir.OpKind.ROW_SOFTMAX, ir.OpKind.POOL2D,
})


def _broadcast_shapes(a: tuple[int, ...], b: tuple[int, ...]
                      ) -> tuple[int, ...] | None:
    """Numpy-style broadcast, None on incompatibility: written out here so
    a drift in the production rule cannot hide itself."""
    n = max(len(a), len(b))
    ax = (1,) * (n - len(a)) + tuple(a)
    bx = (1,) * (n - len(b)) + tuple(b)
    out = []
    for x, y in zip(ax, bx):
        if x == y or x == 1 or y == 1:
            out.append(max(x, y))
        else:
            return None
    return tuple(out)


def _derive_op_shape(op: ir.OpNode,
                     shapes: Mapping[str, tuple[int, ...]]
                     ) -> tuple[int, ...] | None:
    """Output shape of one op, re-derived from the op semantics
    (deliberately not a call into :func:`ir.infer_shapes`)."""
    ins = [tuple(shapes[v]) for v in op.inputs if v in shapes]
    if len(ins) != len(op.inputs):
        return None
    if op.kind == ir.OpKind.POOL2D:
        if len(ins[0]) != 4:
            return None
        n, h, w, c = ins[0]
        kh, kw = op.attrs["window"]
        sh, sw = op.attrs["stride"]
        ph, pw = op.attrs["padding"]
        # (e + 2p - k) // s + 1, written inline: the independent derivation
        oh = (h + 2 * ph - kh) // sh + 1
        ow = (w + 2 * pw - kw) // sw + 1
        return (n, oh, ow, c)
    if op.kind == ir.OpKind.EW_BINARY and not op.params and len(ins) == 2:
        return _broadcast_shapes(ins[0], ins[1])
    if op.kind in _SHAPE_PASSTHROUGH or op.kind == ir.OpKind.EW_BINARY:
        return ins[0]
    return None                     # opaque/backbone kinds: no claim here


def check_program(program: ir.StackProgram,
                  shapes: Mapping[str, tuple[int, ...]] | None = None,
                  dtypes: Mapping[str, Any] | None = None) -> list[Finding]:
    """Well-formedness of one StackProgram: SSA structure, dead values,
    fn-table membership, and shape/dtype inference held against
    :func:`ir.infer_shapes` and the recorded shapes."""
    fs: list[Finding] = []
    name = program.name

    defined: set[str] = set(program.inputs)
    ssa_ok = True
    for op in program.ops:
        for v in op.inputs:
            if v not in defined:
                ssa_ok = False
                fs.append(Finding(
                    "program.def-before-use", "error", f"{name}/{op.name}",
                    f"op reads {v!r} before it is defined"))
        if op.output in defined:
            ssa_ok = False
            fs.append(Finding(
                "program.redefinition", "error", f"{name}/{op.name}",
                f"value {op.output!r} is redefined"))
        defined.add(op.output)
        if op.kind == ir.OpKind.EW_UNARY and op.fn not in ir.UNARY_FNS:
            fs.append(Finding(
                "program.unknown-fn", "error", f"{name}/{op.name}",
                f"unary fn {op.fn!r} has no semantics rule"))
        if op.kind == ir.OpKind.EW_BINARY and op.fn not in ir.BINARY_FNS:
            fs.append(Finding(
                "program.unknown-fn", "error", f"{name}/{op.name}",
                f"binary fn {op.fn!r} has no semantics rule"))
        if op.kind == ir.OpKind.POOL2D:
            missing = [k for k in ("window", "stride", "padding")
                       if k not in op.attrs]
            if op.fn not in ("max", "avg") or missing:
                fs.append(Finding(
                    "program.unknown-fn", "error", f"{name}/{op.name}",
                    f"pool2d fn {op.fn!r} / missing attrs {missing}"))
    for v in program.outputs:
        if v not in defined:
            fs.append(Finding(
                "program.output-undefined", "error", name,
                f"output {v!r} is never defined"))

    consumed = {v for op in program.ops for v in op.inputs}
    consumed.update(program.outputs)
    for op in program.ops:
        if op.output not in consumed:
            fs.append(Finding(
                "program.dead-value", "warning", f"{name}/{op.name}",
                f"value {op.output!r} is produced but never consumed"))

    if ssa_ok and not any(f.invariant == "program.unknown-fn" for f in fs):
        fs.extend(_check_program_avals(program, shapes, dtypes))
    return fs


def _check_program_avals(program: ir.StackProgram,
                         shapes: Mapping[str, tuple[int, ...]] | None,
                         dtypes: Mapping[str, Any] | None) -> list[Finding]:
    fs: list[Finding] = []
    name = program.name
    in_shapes = {v: tuple(shapes[v]) for v in program.inputs
                 if shapes and v in shapes}
    if len(in_shapes) != len(program.inputs):
        return fs                   # not enough recorded shapes to check

    # Local inference (the independent derivation).
    local: dict[str, tuple[int, ...] | None] = dict(in_shapes)
    for op in program.ops:
        local[op.output] = _derive_op_shape(op, {
            k: v for k, v in local.items() if v is not None})

    # Production inference (the engine under test).
    try:
        prod: Mapping[str, tuple[int, ...]] | None = ir.infer_shapes(
            program, in_shapes)
    except Exception as e:          # the inference engine itself failed
        prod = None
        fs.append(Finding(
            "program.shape-mismatch", "error", name,
            f"ir.infer_shapes failed: {type(e).__name__}: {e}"))

    for op in program.ops:
        want = local.get(op.output)
        if want is None:
            if op.kind == ir.OpKind.EW_BINARY and not op.params:
                fs.append(Finding(
                    "program.shape-mismatch", "error", f"{name}/{op.name}",
                    "binary operand shapes are not broadcast-compatible"))
            continue
        if prod is not None and tuple(prod[op.output]) != want:
            fs.append(Finding(
                "program.shape-mismatch", "error", f"{name}/{op.name}",
                f"ir.infer_shapes says {tuple(prod[op.output])}, "
                f"re-derivation says {want}"))
        if shapes and op.output in shapes \
                and tuple(shapes[op.output]) != want:
            fs.append(Finding(
                "program.shape-mismatch", "error", f"{name}/{op.name}",
                f"recorded shape {tuple(shapes[op.output])} != re-derived "
                f"{want}"))
        fs.extend(_check_op_dtype(op, dtypes, name, "program"))
    return fs


def _dtype(d: Any) -> torch.dtype | None:
    """A recorded dtype as a ``torch.dtype``: a dtype, or its name with or
    without the ``torch.`` prefix; None when it names none."""
    if d is None or isinstance(d, torch.dtype):
        return d
    found = getattr(torch, str(d).removeprefix("torch."), None)
    return found if isinstance(found, torch.dtype) else None


def _check_op_dtype(op: ir.OpNode, dtypes: Mapping[str, Any] | None,
                    owner: str, family: str) -> list[Finding]:
    """Conservative dtype pass-through check: claimed only for kinds whose
    semantics preserve a floating input dtype."""
    if not dtypes or op.kind not in _DTYPE_PASSTHROUGH or not op.inputs:
        return []
    din = _dtype(dtypes.get(op.inputs[0]))
    dout = _dtype(dtypes.get(op.output))
    if din is None or dout is None or not din.is_floating_point:
        return []
    if din != dout:
        return [Finding(
            f"{family}.dtype-mismatch", "error", f"{owner}/{op.name}",
            f"recorded output dtype {dout} != input dtype {din} for "
            f"dtype-preserving kind {op.kind.value}")]
    return []


def check_graph(graph: ir.NetGraph,
                shapes: Mapping[str, tuple[int, ...]] | None = None,
                dtypes: Mapping[str, Any] | None = None,
                keep: frozenset[str] | set[str] = frozenset()
                ) -> list[Finding]:
    """Well-formedness of a NetGraph: SSA, dead values (ops whose output
    neither a later op, the graph output, nor a traced output in ``keep``
    consumes), plus shape/dtype consistency of the recorded avals where
    the op semantics determine them."""
    fs: list[Finding] = []
    name = graph.name
    defined: set[str] = {graph.input}
    ssa_ok = True
    for op in graph.ops:
        for v in op.inputs:
            if v not in defined:
                ssa_ok = False
                fs.append(Finding(
                    "graph.def-before-use", "error", f"{name}/{op.name}",
                    f"op reads {v!r} before it is defined"))
        if op.output in defined:
            ssa_ok = False
            fs.append(Finding(
                "graph.redefinition", "error", f"{name}/{op.name}",
                f"value {op.output!r} is redefined"))
        defined.add(op.output)
    if graph.output not in defined:
        fs.append(Finding(
            "graph.output-undefined", "error", name,
            f"graph output {graph.output!r} is never defined"))

    consumed = {v for op in graph.ops for v in op.inputs}
    consumed.add(graph.output)
    consumed.update(keep)
    for op in graph.ops:
        if op.output not in consumed:
            fs.append(Finding(
                "graph.dead-value", "warning", f"{name}/{op.name}",
                f"value {op.output!r} is produced but never consumed "
                f"(trace() should have pruned it)"))

    if ssa_ok and shapes:
        for op in graph.ops:
            want = _derive_op_shape(op, shapes)
            if want is None and op.kind in (ir.OpKind.OPAQUE,
                                            ir.OpKind.KERNEL):
                rec = op.attrs.get("out_shape")
                want = tuple(rec) if rec is not None else None
            if want is None and op.kind == ir.OpKind.MATMUL \
                    and op.inputs[0] in shapes:
                want = tuple(shapes[op.inputs[0]])[:-1] + (
                    op.attrs["features_out"],)
            if want is not None and op.output in shapes \
                    and tuple(shapes[op.output]) != tuple(want):
                fs.append(Finding(
                    "graph.shape-mismatch", "error", f"{name}/{op.name}",
                    f"recorded shape {tuple(shapes[op.output])} != "
                    f"re-derived {tuple(want)}"))
            fs.extend(_check_op_dtype(op, dtypes, name, "graph"))
    return fs


# ---------------------------------------------------------------------------
# (2) CollapsePlan legality: partition, tile/halo arithmetic, budgets.
# ---------------------------------------------------------------------------

def check_plan(plan: Any, *, itemsize: int,
               differentiable: bool = False) -> list[Finding]:
    """Legality of one CollapsePlan: the sequence split must partition the
    program exactly; tiles must cover the output extent; every sequence's
    working set, recomputed through :mod:`repro_torch.core.resource` (the
    joint fwd+bwd one when ``differentiable``), must fit the plan's device;
    nhwc sequences are held at the tiles and shared memory of the kernels
    that will run them."""
    fs: list[Finding] = []
    name = plan.program.name
    fs.extend(_check_partition(plan))
    if errors(fs):
        return fs                   # tile/budget math needs a sane split

    in_shapes = {k: tuple(v) for k, v in plan.input_shapes}
    if any(v not in in_shapes for v in plan.program.inputs):
        return fs
    try:
        shapes = ir.infer_shapes(plan.program, in_shapes)
    except Exception:
        return fs                   # program-level checks already flag this

    try:
        needs = resource.plan_vmem_bytes(plan, itemsize=itemsize,
                                         differentiable=differentiable)
    except Exception as e:
        fs.append(Finding(
            "plan.budget-exceeded", "error", name,
            f"working-set recomputation failed: {type(e).__name__}: {e}"))
        return fs
    for i, need in enumerate(needs):
        limit = plan.device.resource_limit
        if plan.program.layout == "rows":
            limit = resource.rows_tile_limit(
                plan.device, plan.sequences[i].tile_rows or 256)
        if need > limit:
            kind = "joint fwd+bwd" if differentiable else "forward"
            fs.append(Finding(
                "plan.budget-exceeded", "error", f"{name}/seq{i}",
                f"{kind} working set {need}B exceeds device budget "
                f"{limit}B on {plan.device.name}"))

    if plan.program.layout == "nhwc":
        fs.extend(_check_nhwc_plan(plan, shapes, differentiable))
    else:
        fs.extend(_check_rows_plan(plan, shapes))
    return fs


def _check_partition(plan: Any) -> list[Finding]:
    fs: list[Finding] = []
    name = plan.program.name
    seq_ops = [op for s in plan.sequences for op in s.ops]
    prog_ops = list(plan.program.ops)
    if seq_ops == prog_ops:
        return fs
    seq_ids = [id(op) for op in seq_ops]
    prog_ids = [id(op) for op in prog_ops]
    dup = [op.name for op in seq_ops if seq_ids.count(id(op)) > 1]
    if dup:
        fs.append(Finding(
            "plan.partition-overlap", "error", name,
            f"ops assigned to more than one sequence: {sorted(set(dup))}"))
    missing = [op.name for op in prog_ops if id(op) not in seq_ids]
    extra = [op.name for op in seq_ops if id(op) not in prog_ids]
    if missing or extra or (not dup and seq_ops != prog_ops):
        detail = []
        if missing:
            detail.append(f"missing ops {missing}")
        if extra:
            detail.append(f"foreign ops {extra}")
        if not detail:
            detail.append("ops reordered across sequences")
        fs.append(Finding(
            "plan.partition-gap", "error", name,
            "sequence split does not partition the program: "
            + "; ".join(detail)))
    return fs


def _check_rows_plan(plan: Any, shapes: Mapping[str, tuple[int, ...]]
                     ) -> list[Finding]:
    fs: list[Finding] = []
    name = plan.program.name
    sublane = plan.device.sublane
    for i, seq in enumerate(plan.sequences):
        tile = seq.tile_rows or 256          # codegen's default geometry
        if tile < 1:
            fs.append(Finding(
                "plan.tile-coverage", "error", f"{name}/seq{i}",
                f"tile_rows={seq.tile_rows} is not positive"))
        elif tile % sublane:
            fs.append(Finding(
                "plan.tile-coverage", "warning", f"{name}/seq{i}",
                f"tile_rows={tile} is not a sublane ({sublane}) multiple"))
    return fs


def _receptive_field(ops: Sequence[ir.OpNode], axis: int,
                     start: int, length: int) -> tuple[int, int]:
    """Input interval needed to produce output ``[start, start+length)``
    after ``ops``: the independent halo derivation, composing the interval
    map of each pooling op backwards.  ``axis`` 0 = H, 1 = W."""
    lo, n = start, length
    for op in reversed(ops):
        if op.kind != ir.OpKind.POOL2D:
            continue
        k = op.attrs["window"][axis]
        s = op.attrs["stride"][axis]
        p = op.attrs["padding"][axis]
        # output position o consumes inputs [o*s - p, o*s - p + k)
        lo = lo * s - p
        n = (n - 1) * s + k
    return lo, n


def _image_hw(sub: ir.StackProgram, in_shape: tuple[int, ...],
              shapes: Mapping[str, tuple[int, ...]]
              ) -> list[tuple[int, int]] | None:
    image_hw = [(in_shape[1], in_shape[2])]
    for op in sub.ops:
        s = shapes.get(op.output)
        if s is None or len(s) != 4:
            return None
        image_hw.append((s[1], s[2]))
    return image_hw


def _check_nhwc_plan(plan: Any, shapes: Mapping[str, tuple[int, ...]],
                     differentiable: bool = False) -> list[Finding]:
    """Tile coverage plus halo arithmetic: re-derive the kernel planner's
    per-level extents/origins by receptive-field interval composition and
    require exact agreement, at the plan's tile and at the kernels'."""
    fs: list[Finding] = []
    name = plan.program.name
    for i, seq in enumerate(plan.sequences):
        sub = plan.subprogram(i)
        if sub.inputs[0] not in shapes or sub.outputs[0] not in shapes:
            continue
        in_shape = shapes[sub.inputs[0]]
        out_shape = shapes[sub.outputs[0]]
        if len(in_shape) != 4 or len(out_shape) != 4:
            continue
        _, oh, ow, _ = out_shape
        th = min(seq.tile_out_h or 8, oh)
        tw = min(seq.tile_out_w or 8, ow)
        subj = f"{name}/seq{i}"
        fs.extend(_check_tile_cover(subj, oh, th, "h"))
        fs.extend(_check_tile_cover(subj, ow, tw, "w"))

        # The kernel planner's levels (the artifact under test).
        image_hw = _image_hw(sub, in_shape, shapes)
        if image_hw is None:
            continue
        levels = nhwc._plan_levels(sub.ops, th, tw, image_hw)
        fs.extend(check_nhwc_levels(sub, levels, th, tw, image_hw,
                                    subject=subj))
        if not errors(fs):
            fs.extend(_check_nhwc_kernels(sub, shapes, th, tw, image_hw,
                                          differentiable, subj))
    return fs


def _extra_shapes(sub: ir.StackProgram, shapes: Mapping[str, tuple[int, ...]]
                  ) -> tuple[tuple[str, tuple[int, ...]], ...]:
    """The broadcast side operands' shapes, as the wrappers key them."""
    return tuple(sorted((v, tuple(shapes[v])) for v in sub.inputs[1:]))


def _vec_strides(sub: ir.StackProgram) -> tuple[int, ...]:
    """Per-channel strides of the descriptor's vector table (their values
    do not move a write or a byte of shared memory)."""
    return (1,) * (len(sub.inputs) - 1 + len(sub.param_names))


def _check_nhwc_kernels(sub: ir.StackProgram,
                        shapes: Mapping[str, tuple[int, ...]], th: int,
                        tw: int, image_hw: Sequence[tuple[int, int]],
                        differentiable: bool, subj: str) -> list[Finding]:
    """The nhwc kernels as they will run this sequence: the descriptor the
    forward wrapper builds (the fused path's own tile, or the plan's with
    ``nhwc.channel_block``'s channels) and, for training, the backward's
    ``nhwc_bwd.launch_plan``.  Their shared memory must fit what a CTA may
    opt in to, and their tiles cover the output with the re-derived halos.
    A chain the descriptor cannot express at all (``compile_chain``'s
    structural limits) is the kernels' coverage, not a plan defect: the
    wrapper raises at its first call."""
    fs: list[Finding] = []
    x_shape = tuple(shapes[sub.inputs[0]])
    extras = _extra_shapes(sub, shapes)
    oh, ow = image_hw[-1]
    limit = nhwc.SMEM_MAX
    kernel_tiles: list[tuple[str, tuple[int, int]]] = []
    try:
        nhwc.compile_chain(sub)
    except nhwc.DescriptorError:
        return fs
    try:
        _, blob = nhwc._template(sub, x_shape, extras, _vec_strides(sub),
                                 th, tw)
    except nhwc.DescriptorError as e:
        fs.append(Finding("plan.budget-exceeded", "error", subj,
                          f"fused_nhwc: {e}"))
    else:
        d = nhwc.NhwcDesc.from_buffer_copy(blob)
        smem = 4 * d.n_slots * d.slot_elems
        if smem > limit:
            fs.append(Finding(
                "plan.budget-exceeded", "error", subj,
                f"fused_nhwc: {smem}B of shared memory a CTA exceeds the "
                f"{limit}B one may opt in to"))
        kernel_tiles.append(("fused_nhwc", (d.th, d.tw)))
    if differentiable and len(sub.outputs) == 1:
        try:
            nhwc_bwd.compile_bwd_chain(sub)
        except nhwc.DescriptorError:
            return fs
        try:
            b = nhwc_bwd.NhwcBwdDesc.from_buffer_copy(nhwc_bwd.bwd_template(
                sub, x_shape, extras, _vec_strides(sub), th, tw))
        except nhwc.DescriptorError as e:
            fs.append(Finding("plan.budget-exceeded", "error", subj,
                              f"fused_nhwc_bwd: {e}"))
        else:
            smem = nhwc_bwd.desc_smem(b)
            if smem > limit:
                fs.append(Finding(
                    "plan.budget-exceeded", "error", subj,
                    f"fused_nhwc_bwd: {smem}B of shared memory a CTA "
                    f"exceeds the {limit}B one may opt in to"))
            kernel_tiles.append(("fused_nhwc_bwd", (b.f.th, b.f.tw)))
    for kernel, (kth, ktw) in kernel_tiles:
        ksubj = f"{subj}:{kernel}"
        fs.extend(_check_tile_cover(ksubj, oh, kth, "h"))
        fs.extend(_check_tile_cover(ksubj, ow, ktw, "w"))
        geo = nhwc.plan_geometry(sub, x_shape, dict(extras), kth, ktw)
        fs.extend(check_nhwc_levels(sub, geo.levels, kth, ktw, image_hw,
                                    subject=ksubj))
    return fs


def _check_tile_cover(subject: str, extent: int, tile: int, ax: str
                      ) -> list[Finding]:
    fs: list[Finding] = []
    if tile < 1:
        return [Finding("plan.tile-coverage", "error", subject,
                        f"tile_out_{ax}={tile} is not positive")]
    pad = (-extent) % tile
    n_tiles = (extent + pad) // tile
    if n_tiles * tile < extent:
        fs.append(Finding(
            "plan.tile-coverage", "error", subject,
            f"{n_tiles} tiles of {tile} cover only {n_tiles * tile} of "
            f"{extent} output positions on axis {ax}"))
    if n_tiles > 1 and (n_tiles - 1) * tile >= extent:
        fs.append(Finding(
            "plan.tile-coverage", "error", subject,
            f"tile {n_tiles - 1} on axis {ax} starts at "
            f"{(n_tiles - 1) * tile}, beyond output extent {extent} "
            f"(dead tile)"))
    return fs


def check_nhwc_levels(program: ir.StackProgram, levels: Sequence[Any],
                      th: int, tw: int,
                      image_hw: Sequence[tuple[int, int]],
                      subject: str = "") -> list[Finding]:
    """Hold the kernel planner's levels against the independently derived
    receptive-field intervals.  ``levels[i]`` describes the input of
    ``program.ops[i]`` (plus one output level at the end); the kernels load
    ``[t*tile*mul - off, ... + extent)`` at each level, which must equal
    the receptive field of output tile ``t``."""
    fs: list[Finding] = []
    subject = subject or program.name
    ops = program.ops
    if len(levels) != len(ops) + 1:
        return [Finding(
            "plan.halo-mismatch", "error", subject,
            f"planner produced {len(levels)} levels for {len(ops)} ops")]
    for i, lv in enumerate(levels):
        tail = ops[i:]
        for axis, tile, ext, mul, off, img in (
                (0, th, lv.extent_h, lv.mul_h, lv.off_h, lv.image_h),
                (1, tw, lv.extent_w, lv.mul_w, lv.off_w, lv.image_w)):
            ax = "hw"[axis]
            lo0, n0 = _receptive_field(tail, axis, 0, tile)
            lo1, _ = _receptive_field(tail, axis, tile, tile)
            if -off != lo0:
                fs.append(Finding(
                    "plan.halo-mismatch", "error", f"{subject}/level{i}",
                    f"axis {ax}: tile 0 loads from {-off}, receptive "
                    f"field starts at {lo0} (halo origin off by "
                    f"{lo0 + off})"))
            if tile * mul != lo1 - lo0:
                fs.append(Finding(
                    "plan.halo-mismatch", "error", f"{subject}/level{i}",
                    f"axis {ax}: tile stride {tile * mul} != receptive-"
                    f"field stride {lo1 - lo0}"))
            if ext < n0:
                fs.append(Finding(
                    "plan.halo-mismatch", "error", f"{subject}/level{i}",
                    f"axis {ax}: level extent {ext} < receptive field "
                    f"{n0}: the tile under-covers its halo"))
            want_img = image_hw[i][axis]
            if img != want_img:
                fs.append(Finding(
                    "plan.halo-mismatch", "error", f"{subject}/level{i}",
                    f"axis {ax}: level image extent {img} != inferred "
                    f"image extent {want_img} (mis-masked borders)"))
    return fs


def check_differentiable(program: ir.StackProgram,
                         subject: str = "") -> list[Finding]:
    """Every op of a differentiable plan must have a VJP rule now, not a
    ``NotImplementedError`` at the first backward."""
    fs: list[Finding] = []
    subject = subject or program.name
    for op in program.ops:
        why = None
        if op.kind not in autodiff.DIFFERENTIABLE_KINDS:
            why = f"kind {op.kind.value} has no VJP rule"
        elif op.kind == ir.OpKind.EW_UNARY \
                and op.fn not in autodiff._UNARY_DERIVS:
            why = f"unary fn {op.fn!r} has no entry in the derivative table"
        elif op.kind == ir.OpKind.EW_BINARY \
                and op.fn not in autodiff.BINARY_VJP_FNS:
            why = f"binary fn {op.fn!r} has no VJP rule"
        if why is not None:
            fs.append(Finding(
                "plan.missing-vjp", "error", f"{subject}/{op.name}", why))
    return fs


# ---------------------------------------------------------------------------
# (3) Grid write races on a concurrent grid.
# ---------------------------------------------------------------------------

#: Accumulation idioms a write model may claim.
ACCUMULATE = (None, "overlap-slot", "partials", "grid-sum")


@dataclasses.dataclass(frozen=True)
class WriteSpec:
    """The write model of one kernel output: the grid, the block each grid
    point writes (``block_shape``; block ``i`` covers elements ``[i *
    stride + offset, ... + block)`` of each dimension, clipped to
    ``array_shape``), which points are live and which idiom it claims.

    ``index_map(*coords)`` and ``live(*coords)`` take one integer array a
    grid axis (every point at once) and return block indices (arrays or
    ints that broadcast) and a bool array.  A point ``live`` masks (a
    persistent program's iteration past the last item) writes nothing.
    ``stride`` defaults to the block, ``offset`` to 0.  ``covers`` claims
    that the live blocks write every element of the array.

    ``accumulate``: ``None``, every point writes a distinct block;
    ``"overlap-slot"``, each point writes a private halo patch slot
    (distinct), which a second kernel sums; ``"partials"``, program ``p``
    (grid axis 0) writes row ``p`` of a ``(programs, ...)`` buffer, which a
    second kernel sums in a fixed order.  ``"grid-sum"`` (every point adds
    into one shared block) is the Pallas package's sequential-grid idiom:
    on a CUDA grid its programs run concurrently, so it is a race."""

    name: str
    grid: tuple[int, ...]
    block_shape: tuple[int, ...]
    index_map: Callable[..., tuple]
    array_shape: tuple[int, ...]
    accumulate: str | None = None
    live: Callable[..., Any] | None = None
    stride: tuple[int, ...] | None = None
    offset: tuple[int, ...] | None = None
    covers: bool = False

    @classmethod
    def from_model(cls, prefix: str, m: Mapping[str, Any]) -> "WriteSpec":
        """A spec from one entry of a kernel module's ``write_model``."""
        return cls(name=f"{prefix}:{m['name']}", grid=tuple(m["grid"]),
                   block_shape=tuple(m["block_shape"]),
                   index_map=m["index_map"],
                   array_shape=tuple(m["array_shape"]),
                   accumulate=m.get("accumulate"), live=m.get("live"),
                   stride=m.get("stride"), offset=m.get("offset"),
                   covers=bool(m.get("covers", False)))


def _grid_points(grid: tuple[int, ...]
                 ) -> tuple[tuple[np.ndarray, ...] | None, int, bool]:
    """Every grid point as one int64 array an axis (row-major), the count,
    and whether the enumeration cap truncated it."""
    total = math.prod(max(g, 0) for g in grid)
    if total <= 0:
        return None, 0, False
    n = min(total, _GRID_ENUM_CAP)
    if not grid:
        return (), 1, False
    coords = np.unravel_index(np.arange(n, dtype=np.int64), grid)
    return tuple(np.asarray(c, dtype=np.int64) for c in coords), n, \
        total > _GRID_ENUM_CAP


def _index_range(spec: WriteSpec) -> tuple[list[int], list[int]]:
    """Per dimension, the first and last block index whose clipped extent
    holds an element of the array."""
    rank = len(spec.block_shape)
    stride = spec.stride or spec.block_shape
    offset = spec.offset or (0,) * rank
    lo = [(-o - b) // s + 1 for b, s, o in
          zip(spec.block_shape, stride, offset)]
    hi = [-(-(a - o) // s) - 1 for a, s, o in
          zip(spec.array_shape, stride, offset)]
    return lo, hi


def _live_blocks(spec: WriteSpec
                 ) -> tuple[np.ndarray | None, np.ndarray | None, bool, str]:
    """``(points, indices, truncated, error)``: the live grid points (one
    row a point) and their block indices, or an error message."""
    coords, n, truncated = _grid_points(spec.grid)
    rank = len(spec.block_shape)
    if coords is None:
        return (np.zeros((0, len(spec.grid)), np.int64),
                np.zeros((0, rank), np.int64), False, "")
    try:
        if spec.live is not None:
            keep = np.broadcast_to(np.asarray(spec.live(*coords), bool),
                                   (n,))
            coords = tuple(c[keep] for c in coords)
            n = int(keep.sum())
        raw = spec.index_map(*coords)
        idx = [np.broadcast_to(np.asarray(c, dtype=np.int64), (n,))
               for c in raw]
    except Exception as e:
        return None, None, truncated, (f"index map failed: "
                                       f"{type(e).__name__}: {e}")
    if len(idx) != rank:
        return None, None, truncated, (
            f"index map returned rank {len(idx)} for block rank {rank}")
    points = (np.stack(coords, axis=1) if coords
              else np.zeros((n, 0), np.int64))
    return points, (np.stack(idx, axis=1) if idx
                    else np.zeros((n, 0), np.int64)), truncated, ""


def check_write_spec(spec: WriteSpec) -> list[Finding]:
    """Evaluate ``spec.index_map`` over every live grid point and prove the
    write pattern sound on a concurrent grid for its declared idiom."""
    fs: list[Finding] = []
    points, idx, truncated, err = _live_blocks(spec)
    if truncated:
        fs.append(Finding(
            "grid.write-race", "warning", spec.name,
            f"grid {spec.grid} exceeds the enumeration cap "
            f"{_GRID_ENUM_CAP}; only a prefix was verified"))
    if err:
        fs.append(Finding("grid.write-race", "error", spec.name, err))
        return fs
    if spec.accumulate not in ACCUMULATE:
        fs.append(Finding(
            "grid.accumulator", "error", spec.name,
            f"unknown accumulation idiom {spec.accumulate!r}; sanctioned: "
            f"{ACCUMULATE[:3]}"))
        return fs
    lo, hi = _index_range(spec)
    if len(idx):
        bad = np.nonzero(((idx < np.asarray(lo)) |
                          (idx > np.asarray(hi))).any(axis=1))[0]
        if bad.size:
            k = int(bad[0])
            n_blocks = tuple(h - l + 1 for l, h in zip(lo, hi))
            fs.append(Finding(
                "grid.out-of-bounds", "error", spec.name,
                f"grid point {tuple(int(c) for c in points[k])} writes "
                f"block {tuple(int(c) for c in idx[k])}, outside the "
                f"{n_blocks} block grid of array {spec.array_shape}"))
            return fs
    if spec.accumulate == "grid-sum":
        fs.append(Finding(
            "grid.accumulator", "error", spec.name,
            f"grid-sum accumulator over {len(idx)} grid points: a CUDA "
            f"grid runs its programs concurrently, so a shared block "
            f"summed in place races; write per-program partials and sum "
            f"them in a second kernel"))
        return fs
    stride = spec.stride or spec.block_shape
    span = [h - l + 1 for l, h in zip(lo, hi)]
    keys = (np.ravel_multi_index(tuple((idx - np.asarray(lo)).T), span)
            if len(idx) and span else np.zeros(len(idx), np.int64))
    order = np.argsort(keys, kind="stable")
    same = np.nonzero(keys[order][1:] == keys[order][:-1])[0]
    if same.size:
        a, b = int(order[same[0]]), int(order[same[0] + 1])
        fs.append(Finding(
            "grid.write-race", "error", spec.name,
            f"grid points {tuple(int(c) for c in points[a])} and "
            f"{tuple(int(c) for c in points[b])} both write block "
            f"{tuple(int(c) for c in idx[a])}"))
        return fs
    for d, (bk, s) in enumerate(zip(spec.block_shape, stride)):
        if bk > s and len(np.unique(idx[:, d])) > 1:
            fs.append(Finding(
                "grid.write-race", "error", spec.name,
                f"blocks of {bk} on a stride of {s} overlap their "
                f"neighbours along dimension {d}"))
            return fs
    if spec.accumulate == "partials":
        rows_ok = (len(spec.block_shape) > 0 and spec.block_shape[0] == 1
                   and len(spec.grid) > 0
                   and spec.array_shape[0] == spec.grid[0]
                   and bool((idx[:, 0] == points[:, 0]).all()))
        if not rows_ok:
            fs.append(Finding(
                "grid.accumulator", "error", spec.name,
                f"partials: program p must write row p of a "
                f"({spec.grid[0] if spec.grid else 0}, ...) buffer, got "
                f"blocks {spec.block_shape} of {spec.array_shape}"))
    if spec.covers and not truncated:
        offset = spec.offset or (0,) * len(span)
        want = math.prod(span)
        gaps = [d for d, (bk, s) in enumerate(zip(spec.block_shape, stride))
                if bk < s and span[d] > 1]
        starts_late = [d for d, (l, s, o) in enumerate(zip(lo, stride,
                                                           offset))
                       if l * s + o > 0]
        if len(keys) < want or gaps or starts_late:
            missing = ""
            if len(keys) < want:
                hit = np.zeros(want, bool)
                hit[keys] = True
                first = np.unravel_index(int(np.argmin(hit)), span)
                missing = (f"; {want - len(keys)} of {want} blocks "
                           f"unwritten, first "
                           f"{tuple(int(c) + l for c, l in zip(first, lo))}")
            fs.append(Finding(
                "grid.coverage", "error", spec.name,
                f"the live blocks do not write every element of "
                f"{spec.array_shape}{missing}"
                + (f"; gaps between blocks along {gaps}" if gaps else "")
                + (f"; the first block starts past 0 along {starts_late}"
                   if starts_late else "")))
    return fs


def write_mask(spec: WriteSpec) -> np.ndarray:
    """The elements of ``spec.array_shape`` its live grid points write (a
    bool array): what a kernel launch must change and nothing else."""
    _, idx, _, err = _live_blocks(spec)
    if err:
        raise ValueError(f"{spec.name}: {err}")
    mask = np.zeros(spec.array_shape, bool)
    if not len(idx) or not mask.size:
        return mask
    stride = spec.stride or spec.block_shape
    offset = spec.offset or (0,) * len(stride)
    if any(b > s for b, s in zip(spec.block_shape, stride)):
        for i in np.unique(idx, axis=0):             # overlapping blocks
            mask[tuple(slice(max(int(c) * s + o, 0), max(int(c) * s + o + b,
                                                         0))
                       for c, s, o, b in zip(i, stride, offset,
                                             spec.block_shape))] = True
        return mask
    lo, hi = _index_range(spec)
    span = [max(h - l + 1, 1) for l, h in zip(lo, hi)]
    inside = ((idx >= np.asarray(lo)) & (idx <= np.asarray(hi))).all(axis=1)
    hit = np.zeros(span, bool)
    hit[tuple((idx[inside] - np.asarray(lo)).T)] = True
    picks, covered = [], []
    for a, b, s, o, l, n in zip(spec.array_shape, spec.block_shape, stride,
                                offset, lo, span):
        rel = np.arange(a) - o
        blk = rel // s
        picks.append(np.clip(blk - l, 0, n - 1))
        covered.append((rel - blk * s < b) & (blk >= l) & (blk < l + n))
    mask = hit[np.ix_(*picks)]
    for d, c in enumerate(covered):
        shape = [1] * len(covered)
        shape[d] = len(c)
        mask = mask & c.reshape(shape)
    return mask


def plan_write_specs(plan: Any, *, differentiable: bool = False,
                     sm_count: int = MODEL_SM_COUNT,
                     param_shapes: Mapping[str, tuple[int, ...]] | None = None
                     ) -> list[WriteSpec]:
    """The write model of every kernel launch the plan compiles to, forward
    and (when ``differentiable``) backward, from the launch plans the
    kernel wrappers take on ``sm_count`` SMs (each module's
    ``write_model``).  ``param_shapes`` gives a rows chain's parameter
    widths (default: the chain's width)."""
    specs: list[WriteSpec] = []
    in_shapes = {k: tuple(v) for k, v in plan.input_shapes}
    if any(v not in in_shapes for v in plan.program.inputs):
        return specs
    try:
        shapes = ir.infer_shapes(plan.program, in_shapes)
    except Exception:
        return specs
    for i, seq in enumerate(plan.sequences):
        try:
            sub = plan.subprogram(i)
        except Exception:
            continue
        if plan.program.layout == "rows":
            models = _rows_models(sub, shapes, plan.device, differentiable,
                                  sm_count, param_shapes)
        else:
            models = _nhwc_models(sub, seq, shapes, differentiable,
                                  sm_count)
        specs.extend(WriteSpec.from_model(f"{sub.name}:{kind}", m)
                     for kind, m in models)
    return specs


def _rows_models(sub: ir.StackProgram, shapes: Mapping[str, tuple[int, ...]],
                 device: resource.DeviceSpec, differentiable: bool,
                 sm_count: int,
                 param_shapes: Mapping[str, tuple[int, ...]] | None
                 ) -> list[tuple[str, dict]]:
    if any(v not in shapes for v in sub.inputs):
        return []
    in_widths = {v: shapes[v][-1] for v in sub.inputs}
    features = max(in_widths.values())
    param_widths = {p: (math.prod(param_shapes[p]) if param_shapes
                        and p in param_shapes else features)
                    for p in sub.param_names}
    features = max([features, *param_widths.values()])
    n_rows = math.prod(shapes[sub.inputs[0]][:-1])
    widths = rows.value_widths(sub, in_widths, param_widths)
    out = [("fwd", m) for m in rows.write_model(
        sub, widths, n_rows, rows.forward_plan(n_rows, features, sm_count))]
    if differentiable:
        f_block = resource.feature_block(sub, features, device.f_chunk)
        plan = rows_bwd.launch_plan(n_rows, features, f_block, sm_count)
        out += [("bwd", m) for m in rows_bwd.write_model(
            sub, in_widths, param_widths, n_rows, plan)]
    return out


def _nhwc_models(sub: ir.StackProgram, seq: Any,
                 shapes: Mapping[str, tuple[int, ...]], differentiable: bool,
                 sm_count: int) -> list[tuple[str, dict]]:
    in_shape = shapes.get(sub.inputs[0])
    out_shape = shapes.get(sub.outputs[0])
    if in_shape is None or out_shape is None or len(in_shape) != 4 \
            or len(out_shape) != 4 or any(v not in shapes
                                          for v in sub.inputs):
        return []
    _, oh, ow, _ = out_shape
    th = min(seq.tile_out_h or 8, oh)
    tw = min(seq.tile_out_w or 8, ow)
    if th < 1 or tw < 1:
        return []
    extras = _extra_shapes(sub, shapes)
    out: list[tuple[str, dict]] = []
    try:        # a chain the descriptor cannot take has no launch to model
        out += [("fwd", m) for m in nhwc.write_model(
            sub, tuple(in_shape), extras, th, tw, sm_count)]
        if differentiable and len(sub.outputs) == 1:
            out += [("bwd", m) for m in nhwc_bwd.write_model(
                sub, tuple(in_shape), extras, th, tw, sm_count)]
    except nhwc.DescriptorError:
        pass
    return out


# ---------------------------------------------------------------------------
# (4) Registry rewrite soundness.
# ---------------------------------------------------------------------------

def check_kernel_op(op: ir.OpNode,
                    shapes: Mapping[str, tuple[int, ...]] | None = None,
                    dtypes: Mapping[str, Any] | None = None,
                    param_shapes: Mapping[str, tuple[int, ...]] | None = None,
                    differentiable: bool = False) -> list[Finding]:
    """Soundness of one registry-dispatched KERNEL op: the kernel id must
    resolve, slot bookkeeping must be consistent, and the recorded arg/out
    avals must equal the traced avals of the consumed cluster and the
    kernel's output contract."""
    fs: list[Finding] = []
    subject = op.name
    kernel = op.attrs.get("kernel")
    if kernel not in registry_mod.REGISTRY:
        fs.append(Finding(
            "kernel.unknown", "error", subject,
            f"kernel id {kernel!r} has no registry entry (known: "
            f"{sorted(registry_mod.REGISTRY)})"))
        return fs
    entry = registry_mod.REGISTRY[kernel]

    slots = tuple(op.attrs.get("slots", ()))
    in_names = tuple(s[1] for s in slots if s[0] == "in")
    p_names = tuple(s[1] for s in slots if s[0] == "p")
    if in_names != tuple(op.inputs) or p_names != tuple(op.params):
        fs.append(Finding(
            "kernel.slots-mismatch", "error", subject,
            f"slots {slots} disagree with op inputs {op.inputs} / params "
            f"{op.params}"))
    arg_shapes = tuple(op.attrs.get("arg_shapes", ()))
    arg_dtypes = tuple(op.attrs.get("arg_dtypes", ()))
    if len(arg_shapes) != len(slots) or len(arg_dtypes) != len(slots):
        fs.append(Finding(
            "kernel.slots-mismatch", "error", subject,
            f"{len(slots)} slots but {len(arg_shapes)} arg_shapes / "
            f"{len(arg_dtypes)} arg_dtypes recorded"))
        return fs

    for slot, rec_shape, rec_dtype in zip(slots, arg_shapes, arg_dtypes):
        want_shape: tuple[int, ...] | None = None
        want_dtype: Any = None
        if slot[0] == "in":
            if shapes and slot[1] in shapes:
                want_shape = tuple(shapes[slot[1]])
            if dtypes and slot[1] in dtypes:
                want_dtype = dtypes[slot[1]]
        elif len(slot) > 2 and slot[2] is not None:
            want_shape, want_dtype = tuple(slot[2][0]), slot[2][1]
        elif param_shapes and slot[1] in param_shapes:
            want_shape = tuple(param_shapes[slot[1]])
        if want_shape is not None and tuple(rec_shape) != want_shape:
            fs.append(Finding(
                "kernel.aval-mismatch", "error", subject,
                f"slot {slot[:2]} recorded shape {tuple(rec_shape)} != "
                f"traced shape {want_shape}"))
        if want_dtype is not None and _dtype(want_dtype) is not None \
                and _dtype(rec_dtype) != _dtype(want_dtype):
            fs.append(Finding(
                "kernel.aval-mismatch", "error", subject,
                f"slot {slot[:2]} recorded dtype {rec_dtype} != traced "
                f"dtype {_dtype(want_dtype)}"))

    out_shape = op.attrs.get("out_shape")
    if out_shape is not None:
        if shapes and op.output in shapes \
                and tuple(shapes[op.output]) != tuple(out_shape):
            fs.append(Finding(
                "kernel.aval-mismatch", "error", subject,
                f"recorded out_shape {tuple(out_shape)} != traced shape "
                f"{tuple(shapes[op.output])}"))
        want_out = registry_mod.expected_out_shape(kernel, arg_shapes)
        if want_out is not None and tuple(out_shape) != want_out:
            fs.append(Finding(
                "kernel.aval-mismatch", "error", subject,
                f"recorded out_shape {tuple(out_shape)} != kernel "
                f"{kernel!r} contract {want_out}"))
        if kernel == "vocab_ce" and len(arg_shapes) == 3 \
                and math.prod(out_shape) != math.prod(arg_shapes[2]):
            fs.append(Finding(
                "kernel.aval-mismatch", "error", subject,
                f"vocab_ce emits one loss per gathered index: out_shape "
                f"{tuple(out_shape)} has {math.prod(out_shape)} elements, "
                f"index slot {tuple(arg_shapes[2])} has "
                f"{math.prod(arg_shapes[2])}"))
    out_dtype = _dtype(op.attrs.get("out_dtype"))
    traced = _dtype(dtypes.get(op.output)) if dtypes else None
    if out_dtype is not None and traced is not None and out_dtype != traced:
        fs.append(Finding(
            "kernel.aval-mismatch", "error", subject,
            f"recorded out_dtype {out_dtype} != traced dtype {traced}"))

    if differentiable and entry.vjp not in ("custom", "ref"):
        fs.append(Finding(
            "kernel.no-vjp", "error", subject,
            f"kernel {kernel!r} declares vjp={entry.vjp!r}; a "
            f"differentiable net needs 'custom' or 'ref'"))
    return fs


# ---------------------------------------------------------------------------
# Pipeline entry points.
# ---------------------------------------------------------------------------

def model_sm_count(config: Any) -> int:
    """The SM count the write models take: the card's when the config runs
    on one, else :data:`MODEL_SM_COUNT` (an H100 SXM)."""
    device = torch.device(getattr(config, "torch_device", "cpu"))
    if device.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_properties(device).multi_processor_count
    return MODEL_SM_COUNT


@_timed
def verify_segments(segments: Sequence[Any], plans: Mapping[int, Any],
                    shapes: Mapping[str, tuple[int, ...]], config: Any,
                    *, dtypes: Mapping[str, Any] | None = None,
                    param_shapes: Mapping[str, tuple[int, ...]] | None = None,
                    partitions: Any = None) -> list[Finding]:
    """The between-stages pass: verify every stack segment's program, plan
    and kernel write models, every KERNEL segment's registry soundness and,
    under a mesh, the partition plan (:func:`check_partitions`).  Called
    by ``compile_stacks`` after planning and before codegen."""
    fs: list[Finding] = []
    differentiable = bool(getattr(config, "differentiable", False))
    sm_count = model_sm_count(config)
    for idx, seg in enumerate(segments):
        if getattr(seg, "is_stack", False):
            fs.extend(check_program(seg.stack, shapes=shapes, dtypes=dtypes))
            plan = plans.get(idx)
            if plan is None:
                continue
            fs.extend(check_plan(plan, itemsize=config.itemsize,
                                 differentiable=differentiable))
            if differentiable:
                fs.extend(check_differentiable(seg.stack))
            for spec in plan_write_specs(plan, differentiable=differentiable,
                                         sm_count=sm_count,
                                         param_shapes=param_shapes):
                fs.extend(check_write_spec(spec))
        elif getattr(seg, "op", None) is not None \
                and seg.op.kind == ir.OpKind.KERNEL:
            fs.extend(check_kernel_op(seg.op, shapes=shapes, dtypes=dtypes,
                                      param_shapes=param_shapes,
                                      differentiable=differentiable))
    if partitions is not None:
        fs.extend(check_partitions(segments, plans, partitions, shapes,
                                   config))
    return fs


# ---------------------------------------------------------------------------
# (6) Mesh partition soundness (``dist.*``).
# ---------------------------------------------------------------------------

#: Stack op kinds that reduce over the trailing (feature) axis: a
#: trailing-dim shard across one would need an in-kernel collective.
_DIST_FEATURE_REDUCING = frozenset({ir.OpKind.ROW_NORM,
                                    ir.OpKind.ROW_SOFTMAX})


def _check_one_spec(name: str, spec: Any, shape: tuple[int, ...] | None,
                    axes: Any, subject: str) -> list[Finding]:
    """spec-rank and mesh-axis consistency of one operand's spec."""
    fs: list[Finding] = []
    entries = tuple(spec)
    if shape is not None and len(entries) > len(shape):
        fs.append(Finding(
            "dist.spec-rank", "error", subject,
            f"{name}: spec {spec} has rank {len(entries)} > operand "
            f"rank {len(shape)} (shape {shape})"))
        return fs
    for dim, entry in enumerate(entries):
        for axis in partition_mod.spec_axes(entry):
            if axis not in axes.names:
                fs.append(Finding(
                    "dist.mesh-axis", "error", subject,
                    f"{name}: spec {spec} names mesh axis {axis!r}; "
                    f"mesh has {axes.names}"))
                continue
            if shape is not None and shape[dim] % axes.extent(axis):
                fs.append(Finding(
                    "dist.spec-rank", "error", subject,
                    f"{name}: dim {dim} extent {shape[dim]} is not "
                    f"divisible by mesh axis {axis!r}={axes.extent(axis)}"))
    return fs


def _sharded_dims(spec: Any) -> set[int]:
    return {i for i, e in enumerate(tuple(spec)) if e is not None}


def _kernel_fences(op: ir.OpNode) -> list[tuple[str, int, str]]:
    """(slot, dim, why) of every KERNEL operand dim its kernel reduces
    over."""
    kernel = op.attrs["kernel"]
    arg_shapes = op.attrs["arg_shapes"]
    if kernel == "rmsnorm":
        return [("arg0", len(arg_shapes[0]) - 1, "the rms reduction")]
    if kernel == "vocab_ce" and len(arg_shapes) > 1:
        # w: (D, V) feeds the log-sum-exp
        return [("arg1", d, "the vocab log-sum-exp")
                for d in range(len(arg_shapes[1]))]
    if kernel == "attention":
        return [(f"arg{i}", len(arg_shapes[i]) - 2, "the softmax over keys")
                for i in range(min(3, len(arg_shapes)))]
    return []


def check_partitions(segments: Sequence[Any], plans: Mapping[int, Any],
                     partitions: Any,
                     shapes: Mapping[str, tuple[int, ...]],
                     config: Any) -> list[Finding]:
    """The ``dist.*`` family: re-derive every committed partition's
    soundness independently of the planner that produced it.

    * ``dist.spec-rank`` / ``dist.mesh-axis``: every boundary spec against
      the operand shapes and the mesh.
    * ``dist.collective-placement``: no spec shards a dim its region
      reduces over.
    * ``dist.vmem-refit``: rebuild the per-shard view from the *global*
      shapes and committed specs (:func:`repro_torch.core.resource.
      shard_view`) and require that the plan was collapsed against exactly
      that view and that its working set fits the haircut budget."""
    axes = partitions.axes
    fs: list[Finding] = []
    differentiable = bool(getattr(config, "differentiable", False))
    for idx, part in sorted(partitions.segments.items()):
        seg = segments[idx]
        is_stack = bool(getattr(seg, "is_stack", False))
        subject = seg.stack.name if is_stack else seg.op.name
        # -- structural: every boundary spec, against global shapes ------
        if is_stack:
            known = {k: tuple(shapes[k]) for k in seg.stack.inputs
                     if k in shapes}
            op_shapes = dict(known)
            op_shapes.update({v: tuple(s) for v, s in
                              ir.infer_shapes(seg.stack, known).items()})
        else:
            op_shapes = {f"arg{i}": tuple(s) for i, s in
                         enumerate(seg.op.attrs["arg_shapes"])}
            op_shapes[seg.op.output] = tuple(seg.op.attrs["out_shape"])
        for group in (part.in_specs, part.out_specs, part.param_specs):
            for name, spec in group.items():
                fs.extend(_check_one_spec(name, spec, op_shapes.get(name),
                                          axes, subject))
        # -- collective placement ---------------------------------------
        if is_stack:
            if any(op.kind in _DIST_FEATURE_REDUCING
                   for op in seg.stack.ops):
                for name, spec in (*part.in_specs.items(),
                                   *part.out_specs.items()):
                    shape = op_shapes.get(name)
                    if shape and len(shape) - 1 in _sharded_dims(spec):
                        fs.append(Finding(
                            "dist.collective-placement", "error", subject,
                            f"{name}: spec {spec} shards the trailing "
                            "feature dim of a stack containing a "
                            "trailing-axis reduction"))
        else:
            for name, dim, why in _kernel_fences(seg.op):
                spec = part.in_specs.get(name)
                if spec is not None and dim in _sharded_dims(spec):
                    fs.append(Finding(
                        "dist.collective-placement", "error", subject,
                        f"{name}: spec {spec} shards dim {dim}, which "
                        f"feeds {why}"))
        # -- per-shard refit (active stacks with a plan) -----------------
        plan = plans.get(idx) if is_stack else None
        if plan is None or not part.active:
            continue
        global_in = {v: tuple(shapes[v]) for v in seg.stack.inputs
                     if v in shapes}
        if len(global_in) != len(seg.stack.inputs):
            continue                     # shapes unknown: nothing to refit
        expect = partition_mod.shard_shapes(global_in, part.in_specs, axes)
        got = {k: tuple(v) for k, v in plan.input_shapes}
        if expect != got:
            fs.append(Finding(
                "dist.vmem-refit", "error", subject,
                f"plan was collapsed against {sorted(got.items())}, but "
                f"the committed specs imply the shard view "
                f"{sorted(expect.items())}"))
            continue
        duck = _GlobalPlanView(plan, config.device,
                               tuple(sorted(global_in.items())))
        sv = resource.shard_view(duck, axes, part.in_specs,
                                 itemsize=config.itemsize,
                                 differentiable=differentiable)
        if not sv.fits:
            fs.append(Finding(
                "dist.vmem-refit", "error", subject,
                f"per-shard working set {max(sv.seq_bytes)}B exceeds the "
                f"haircut per-rank budget {sv.budget}B ({sv.device.name})"))
    return fs


@dataclasses.dataclass(frozen=True)
class _GlobalPlanView:
    """Duck plan handing :func:`repro_torch.core.resource.shard_view` the
    *global* shapes and the unsharded device, so the refit is independent
    of the per-shard sizing the collapser committed."""

    _plan: Any
    device: Any
    input_shapes: tuple

    @property
    def program(self):
        return self._plan.program

    @property
    def sequences(self):
        return self._plan.sequences

    def subprogram(self, i: int):
        return self._plan.subprogram(i)


@_timed
def verify_trace(tr: Any) -> list[Finding]:
    """Graph-level checks over a TraceResult (before segmentation)."""
    keep = {ref for kind, ref in tr.out_refs if kind == "env"}
    return check_graph(tr.graph, shapes=tr.shapes, dtypes=tr.dtypes,
                       keep=keep)


@_timed
def verify_graph(graph: ir.NetGraph, shapes: Mapping[str, tuple[int, ...]]
                 ) -> list[Finding]:
    """Graph-level checks over a NetGraph handed to ``optimize_graph``
    (before segmentation), its output kept."""
    return check_graph(graph, shapes=shapes, keep=frozenset({graph.output}))


# ---------------------------------------------------------------------------
# (5) Serving block-table soundness (``kv.*``).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockTableState:
    """Snapshot of the serve engine's paged-KV bookkeeping at one scheduler
    tick, in plain tuples so the checker re-derives soundness independently
    of the allocator that produced it.

    ``tables``/``lengths`` are per live slot (one row each); ``cached`` is
    the set of blocks the prefix cache holds a reference to; ``writers`` is
    the set of physical blocks the imminent dispatch will write into."""

    num_blocks: int
    block_size: int
    refcounts: tuple[int, ...]          # per physical block
    free: tuple[int, ...]               # allocator free list
    tables: tuple[tuple[int, ...], ...]  # live slots' mapped blocks
    lengths: tuple[int, ...]            # live slots' logical KV lengths
    cached: tuple[int, ...] = ()
    writers: tuple[int, ...] = ()


def check_block_tables(state: BlockTableState) -> list[Finding]:
    """Block-table soundness for the paged serving cache: in-bounds ids,
    length coverage, refcounts re-derived from the mapping tables and the
    prefix cache, copy-on-write discipline for the blocks about to be
    written, and free-list unreachability."""
    fs: list[Finding] = []
    n, bs = state.num_blocks, state.block_size

    def in_bounds(b: int) -> bool:
        return 0 <= b < n

    for where, ids in (("free list", state.free),
                       ("prefix cache", state.cached),
                       ("write set", state.writers)):
        for b in ids:
            if not in_bounds(b):
                fs.append(Finding(
                    "kv.block-out-of-bounds", "error", where,
                    f"block id {b} outside the {n}-block pool"))

    derived = [0] * n
    cached = set(state.cached)
    for b in cached:
        if in_bounds(b):
            derived[b] += 1
    for s_i, (row, length) in enumerate(zip(state.tables, state.lengths)):
        subj = f"slot[{s_i}]"
        for b in row:
            if not in_bounds(b):
                fs.append(Finding(
                    "kv.block-out-of-bounds", "error", subj,
                    f"mapped block id {b} outside the {n}-block pool"))
            else:
                derived[b] += 1
        if len(row) * bs < length:
            fs.append(Finding(
                "kv.length-uncovered", "error", subj,
                f"{len(row)} mapped blocks of {bs} tokens cover "
                f"{len(row) * bs} positions < logical length {length}"))

    if len(state.refcounts) != n:
        fs.append(Finding(
            "kv.refcount-mismatch", "error", "allocator",
            f"{len(state.refcounts)} refcounts recorded for a {n}-block "
            f"pool"))
        return fs
    free = set(state.free)
    for b in range(n):
        want = derived[b]
        got = state.refcounts[b]
        if b in free:
            if want:
                continue            # reported as kv.freed-reachable below
            if got != 0:
                fs.append(Finding(
                    "kv.refcount-mismatch", "error", f"block[{b}]",
                    f"free block carries refcount {got}"))
        elif got != want:
            fs.append(Finding(
                "kv.refcount-mismatch", "error", f"block[{b}]",
                f"recorded refcount {got} != {want} derived from "
                f"{derived[b]} table/cache reference(s)"))

    for b in state.writers:
        if in_bounds(b) and derived[b] > 1:
            fs.append(Finding(
                "kv.shared-writable", "error", f"block[{b}]",
                f"dispatch writes a block held by {derived[b]} owners; "
                f"copy-on-write must fork before the write"))

    for b in free:
        if in_bounds(b) and derived[b] > 0:
            fs.append(Finding(
                "kv.freed-reachable", "error", f"block[{b}]",
                f"freed block still reachable from {derived[b]} "
                f"table/cache reference(s)"))
    return fs


# ---------------------------------------------------------------------------
# (7) Serving decode-cache partition soundness (``dist.serve-*``).
# ---------------------------------------------------------------------------

def check_decode_plan(plan: Any) -> list[Finding]:
    """Re-derive the soundness of a serving
    :class:`~repro_torch.core.partition.DecodeCachePlan` apart from the
    planner that committed it.

    * ``dist.spec-rank`` / ``dist.mesh-axis``: every leaf's spec against
      its recorded shape and the mesh (the checks of the training-side
      partitions).
    * ``dist.serve-pool-write``: a pool leaf never shards over the data
      axis; every slot writes into the pool, so slot-partitioned ranks
      each holding a pool would diverge after the first tick.
    * ``dist.serve-slot-axis``: every slot-bearing leaf shards its slot
      dim over the same axes; splitting part of the per-slot state while
      replicating the rest desynchronizes the ranks.
    """
    data = partition_mod.DATA_AXIS
    fs: list[Finding] = []
    slot_axes: dict[str, tuple] = {}
    for leaf in plan.leaves:
        fs.extend(_check_one_spec(leaf.path, leaf.spec, leaf.shape,
                                  plan.axes, "decode-cache"))
        entries = tuple(leaf.spec)

        def axes_at(dim: int | None) -> tuple:
            if dim is None or dim >= len(entries):
                return ()
            return partition_mod.spec_axes(entries[dim])

        if leaf.kind == "pool" and any(
                data in axes_at(i) for i in range(len(entries))):
            fs.append(Finding(
                "dist.serve-pool-write", "error", leaf.path,
                f"spec {leaf.spec} shards a shared physical pool over the "
                f"batch axis {data!r}; per-shard scatter writes would "
                f"diverge between the pool replicas"))
        if leaf.slot_dim is not None:
            slot_axes[leaf.path] = axes_at(leaf.slot_dim)
    if slot_axes:
        counts: dict[tuple, int] = {}
        for got in slot_axes.values():
            counts[got] = counts.get(got, 0) + 1
        majority = max(counts, key=lambda k: counts[k])
        for path, got in sorted(slot_axes.items()):
            if got != majority:
                fs.append(Finding(
                    "dist.serve-slot-axis", "error", path,
                    f"slot dim shards over {got or '(replicated)'} while "
                    f"the rest of the per-slot state uses "
                    f"{majority or '(replicated)'}"))
    return fs
