"""Public BrainSlug API on PyTorch — the paper's ``brainslug.optimize(model)``.

Two entry points:

* :func:`optimize_graph` — the whole-network path (CNN family): takes a
  :class:`~repro_torch.core.ir.NetGraph`, finds optimizable runs, collapses
  them against the device budget, and returns an :class:`OptimizedNet`
  whose ``__call__`` executes opaque ops breadth-first and collapsed stacks
  depth-first.
* :func:`optimize_stack` — the composable path of the LM layers: takes one
  :class:`~repro_torch.core.ir.StackProgram` and returns a fused executor.

The traced path, :func:`repro_torch.api.optimize` on a plain PyTorch
function, shares :func:`compile_stacks`, :func:`run_segments` and
:func:`coverage_report` with them; its graphs also hold registry ``KERNEL``
ops (:mod:`repro_torch.core.registry`).

Modes: ``brainslug`` runs the hand-written Hopper kernels, ``xla`` each
stack's plain function under ``torch.compile`` (the compiler-fusion
comparison point, as XLA's fusion is in the JAX package), ``barrier`` the
eager plain function op by op.  ``OptimizeConfig(autotune=True)`` times
each stack's candidates (``brainslug`` and its tile and split variants,
``xla``, ``barrier``) and each registry kernel's (``hopper``, ``ref``) on
the traced shapes and commits the fastest that is no slower than the
baseline (:mod:`repro_torch.core.autotune`).

All run on ``cuda`` unless the config asks for ``cpu``
(``OptimizeConfig(torch_device="cpu")``); asking for ``cuda`` without a GPU
raises ``RuntimeError``.

Mesh execution: ``OptimizeConfig(mesh=..., partition=...)`` with a
:class:`repro_torch.launch.mesh.Mesh` (every rank calls ``optimize`` with
the same global inputs) partitions each stack and registry kernel
(:mod:`repro_torch.core.partition`), collapses each sharded stack against
its per-shard shapes on a haircut budget
(:func:`repro_torch.core.resource.shard_device`) and runs it inside a
sharded call (:func:`repro_torch.core.codegen.sharded_call`).  A
:class:`~repro_torch.core.partition.MeshAxes` skeleton drives the same
planning and verification without ranks (the lint).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core import (analyzer, autotune, codegen, collapse, ir,
                              registry, resource)
from repro_torch.core import partition as partition_mod
from repro_torch.core import verify as verify_mod

#: Execution modes an OptimizeConfig accepts.
MODES = ("brainslug", "xla", "barrier")

#: Layouts the graph entry points accept (``auto`` classifies per stack).
LAYOUTS = analyzer.LAYOUTS


@dataclasses.dataclass(frozen=True)
class OptimizeConfig:
    mode: str = "xla"            # 'brainslug' | 'xla' | 'barrier'
    device: resource.DeviceSpec = resource.H100
    itemsize: int = 4
    max_steps_per_sequence: int | None = None
    # LRU bound for the compiled-executor caches.
    code_cache_size: int = 256
    # Where the tensors live: "cuda" (the default) or an explicit "cpu".
    torch_device: str = "cuda"
    # Size collapse plans for training: the generated backward holds the
    # recomputed forward and live cotangents in shared memory, so
    # differentiable plans get smaller tiles and earlier sequence splits.
    differentiable: bool = False
    # The traced path: rewrite attention / rmsnorm / swiglu / vocab-CE
    # clusters onto the dedicated kernels (repro_torch.core.registry).
    kernel_registry: bool = True
    # Measured autotuning (repro_torch.core.autotune): time the candidate
    # execution variants per segment on the traced shapes and commit the
    # winner, hard-floored at the barrier / ref baseline so a losing
    # variant degrades gracefully.  Off by default: the static planner
    # stays deterministic and compile stays cheap unless the never-slower
    # contract is asked for.
    autotune: bool = False
    # Decision-cache directory (None -> $REPRO_TORCH_AUTOTUNE_CACHE, else
    # ~/.cache/repro_torch/autotune).  Entries are checksummed and
    # version-keyed; corrupt or stale files are quarantined, never fatal.
    autotune_cache_dir: str | None = None
    autotune_repeats: int = 3        # median-of-k timing
    autotune_warmup: int = 1         # untimed calls before the k
    # Per-candidate budget: a non-baseline candidate whose first timed call
    # (after its untimed build and compile) exceeds this is disqualified
    # with a recorded reason.  The baseline is exempt: the floor must
    # always exist.
    autotune_timeout_ms: float | None = 2000.0
    # Mesh execution (repro_torch.core.partition): a live
    # repro_torch.launch.mesh.Mesh (or a partition.MeshAxes skeleton for
    # static lint) and a partition mode.  With a mesh, stacks and registry
    # kernels run inside sharded calls with derived partition specs, and
    # collapse sizes tiles against the per-shard shapes on a haircut
    # budget (resource.shard_device).  'data' shards batch/rows, 'tensor'
    # heads/features, 'both' both, 'none' ignores the mesh.  Autotuning is
    # off under a mesh: the static planner decides.
    mesh: object | None = None
    partition: str = "none"
    # Static plan verification (repro_torch.core.verify): re-derive every
    # compile artifact's invariants between planning and codegen.
    # 'strict' raises VerifyError on any violation before anything
    # compiles; 'warn' (the default) records the findings on the optimized
    # net and emits one UserWarning; 'off' skips the pass.
    verify: str = "warn"

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; allowed modes: {MODES}")
        if self.verify not in verify_mod.VERIFY_MODES:
            raise ValueError(
                f"unknown verify mode {self.verify!r}; allowed: "
                f"{verify_mod.VERIFY_MODES}")
        if not isinstance(self.itemsize, int) or self.itemsize <= 0:
            raise ValueError(
                f"itemsize must be a positive int, got {self.itemsize!r}")
        if not isinstance(self.code_cache_size, int) \
                or self.code_cache_size < 1:
            raise ValueError(
                f"code_cache_size must be a positive int, got "
                f"{self.code_cache_size!r}")
        if not isinstance(self.autotune_repeats, int) \
                or self.autotune_repeats < 1:
            raise ValueError(
                f"autotune_repeats must be a positive int, got "
                f"{self.autotune_repeats!r}")
        if not isinstance(self.autotune_warmup, int) \
                or self.autotune_warmup < 0:
            raise ValueError(
                f"autotune_warmup must be a non-negative int, got "
                f"{self.autotune_warmup!r}")
        for flag in ("differentiable", "kernel_registry", "autotune"):
            if not isinstance(getattr(self, flag), bool):
                raise ValueError(f"{flag} must be a bool, got "
                                 f"{getattr(self, flag)!r}")
        if torch.device(self.torch_device).type not in ("cuda", "cpu"):
            raise ValueError(f"torch_device must be cuda or cpu, got "
                             f"{self.torch_device!r}")
        if self.partition not in partition_mod.PARTITIONS:
            raise ValueError(
                f"unknown partition {self.partition!r}; allowed: "
                f"{partition_mod.PARTITIONS}")
        if self.partition != "none" and self.mesh is None:
            raise ValueError(
                f"partition={self.partition!r} needs a mesh "
                "(OptimizeConfig(mesh=..., partition=...))")


def resolve_device(config: OptimizeConfig) -> torch.device:
    """The config's torch device; ``cuda`` without a GPU is an error, never
    a quiet move to the CPU."""
    device = torch.device(config.torch_device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"torch_device={config.torch_device!r} but no CUDA device is "
            f"available; pass OptimizeConfig(torch_device='cpu') to run the "
            f"plain versions on the CPU")
    return device


def _check_device(device: torch.device, tensors: Mapping[str, torch.Tensor]
                  ) -> None:
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name!r} is on {t.device}, but the net was "
                             f"optimized for {device}")


@dataclasses.dataclass(frozen=True)
class StackCoverage:
    """Per-stack slice of a :class:`CoverageReport`."""

    name: str
    n_ops: int
    kinds: tuple[str, ...]
    n_sequences: int
    hbm_breadth_bytes: int      # breadth-first traffic of this stack
    hbm_depth_bytes: int        # planned depth-first traffic
    tiles: tuple[str, ...] = ()     # per sequence: "rows 4" or "8x8"
    differentiable: bool = False    # tiles sized for forward + backward


@dataclasses.dataclass(frozen=True)
class KernelCoverage:
    """One registry-dispatched KERNEL op of the rewritten network."""

    op_name: str
    kernel: str                 # registry id: attention / rmsnorm / ...
    backend: str                # 'hopper' | 'ref'
    fallback_reason: str | None = None   # why ref runs (None for hopper)


@dataclasses.dataclass(frozen=True)
class AutotuneCoverage:
    """One committed autotune decision in the ``report()`` payload."""

    name: str                 # stack / kernel / function label
    kind: str                 # 'stack' | 'kernel' | 'function' | 'callable'
    requested: str            # statically configured variant
    baseline: str             # never-slower floor
    chosen: str               # what actually runs
    guardrail_tripped: bool   # the floor overrode the requested variant
    source: str               # 'measured' | 'cache-mem' | 'cache-disk'
    measured_ms: tuple = ()   # ((variant, phase, ms), ...)
    events: tuple = ()        # cache hit/miss/quarantine notes
    failures: tuple = ()      # ((variant, reason), ...)


@dataclasses.dataclass(frozen=True)
class DistCoverage:
    """One mesh-partitioned segment in the ``report()`` payload: the
    committed boundary specs and the per-shard shared-memory budget the
    tiles were sized against."""

    name: str                   # stack name / kernel op name
    kind: str                   # 'stack' | 'kernel'
    in_specs: tuple[tuple[str, str], ...]    # (operand, spec) as strings
    out_specs: tuple[tuple[str, str], ...]
    active: bool                # False: every operand ended up replicated
    shard_budget_bytes: int     # haircut per-rank budget (0: no plan)
    notes: tuple[str, ...] = ()  # why a split was fenced / replicated


@dataclasses.dataclass(frozen=True)
class CoverageReport:
    """What the optimizer captured — the ``report()``/``explain()`` payload.

    ``capture_ratio`` is computed over the ops that could have been
    captured: everything except the backbone kinds (matmul / conv /
    attention / ssd / embed), which the paper's optimizer leaves untouched
    by design, and KERNEL ops, which the registry routed to a dedicated
    kernel.  ``n_opaque`` counts ops that stayed OPAQUE; ``n_synthetic``
    the tracer's plumbing (parameter binds, projections of an op's several
    results), which is neither.  ``kernels`` lists every registry dispatch
    with the backend that runs, and ``vetoes`` every region a kernel
    matched but whose probe disagreed (it runs as traced), so a fallback
    to the plain version shows."""

    n_ops: int
    n_captured: int
    n_opaque: int
    n_backbone: int
    n_stacks: int
    capture_ratio: float
    stacks: tuple[StackCoverage, ...]
    n_synthetic: int = 0
    n_kernel: int = 0
    kernels: tuple[KernelCoverage, ...] = ()
    vetoes: tuple[registry.KernelVeto, ...] = ()
    autotune: tuple[AutotuneCoverage, ...] = ()
    #: The static verifier's compile-time findings: under verify='warn'
    #: the waived violations, readable long after the warning scrolled
    #: away; and the host seconds its passes took.
    verify: tuple = ()
    verify_seconds: float = 0.0
    #: Mesh partitioning: (("data", 2), ("model", 1))-style axis extents
    #: (empty without a mesh) and one DistCoverage per partitioned segment.
    mesh_axes: tuple = ()
    dist: tuple[DistCoverage, ...] = ()

    @property
    def verify_errors(self) -> int:
        """Error-severity findings the verify='warn' run waived."""
        return sum(1 for f in self.verify if f.severity == "error")

    @property
    def verify_warnings(self) -> int:
        return sum(1 for f in self.verify if f.severity != "error")

    @property
    def guardrail_trips(self) -> int:
        """Decisions where the never-slower floor overrode the requested
        variant."""
        return sum(1 for a in self.autotune if a.guardrail_tripped)

    @property
    def autotune_cache_hits(self) -> int:
        return sum(1 for a in self.autotune
                   if a.source in ("cache-mem", "cache-disk"))

    @property
    def kernel_hits(self) -> dict[str, int]:
        """Registry dispatches per kernel."""
        hits: dict[str, int] = {}
        for k in self.kernels:
            hits[k.kernel] = hits.get(k.kernel, 0) + 1
        return hits

    @property
    def kernel_fallbacks(self) -> dict[str, int]:
        """Regions per kernel that run the plain version: registry
        dispatches to it and vetoed matches."""
        falls: dict[str, int] = {}
        for kernel in [k.kernel for k in self.kernels
                       if k.backend != registry.KernelType.HOPPER.value] \
                + [v.kernel for v in self.vetoes]:
            falls[kernel] = falls.get(kernel, 0) + 1
        return falls

    def __str__(self) -> str:
        lines = [
            f"ops total={self.n_ops}  captured={self.n_captured}  "
            f"opaque-fallback={self.n_opaque}  backbone={self.n_backbone}  "
            f"kernels={self.n_kernel}  stacks={self.n_stacks}  "
            f"capture_ratio={100.0 * self.capture_ratio:.1f}%",
        ]
        for s in self.stacks:
            ratio = s.hbm_breadth_bytes / max(s.hbm_depth_bytes, 1)
            lines.append(
                f"  stack {s.name:28s} ops={s.n_ops:3d} "
                f"seqs={s.n_sequences}  HBM "
                f"{s.hbm_breadth_bytes / 2**20:8.2f} MiB -> "
                f"{s.hbm_depth_bytes / 2**20:8.2f} MiB  ({ratio:.2f}x)  "
                f"tiles [{', '.join(s.tiles)}]"
                f"{' fwd+bwd' if s.differentiable else ''}")
        for k in self.kernels:
            note = (f"  (fallback: {k.fallback_reason})"
                    if k.fallback_reason else "")
            lines.append(f"  kernel {k.kernel:12s} {k.op_name:28s} "
                         f"backend={k.backend}{note}")
        for v in self.vetoes:
            lines.append(f"  kernel {v.kernel:12s} {v.op_name:28s} "
                         f"vetoed, runs as traced ({v.reason})")
        for a in self.autotune:
            trip = "  GUARDRAIL" if a.guardrail_tripped else ""
            times = "  ".join(f"{v}/{p}={ms:.3f}ms"
                              for v, p, ms in a.measured_ms)
            lines.append(
                f"  autotune {a.kind:8s} {a.name:24s} "
                f"{a.requested} -> {a.chosen} [{a.source}]{trip}"
                + (f"  {times}" if times else ""))
            for ev in a.events:
                lines.append(f"    note: {ev}")
            for variant, why in a.failures:
                lines.append(f"    candidate {variant} failed: {why}")
        if self.mesh_axes:
            lines.append("  mesh " + " x ".join(
                f"{n}={e}" for n, e in self.mesh_axes))
        for d in self.dist:
            state = "sharded" if d.active else "replicated"
            specs = "  ".join(f"{k}={s}" for k, s in d.in_specs)
            budget = (f"  per-shard shared-memory budget="
                      f"{d.shard_budget_bytes} B = "
                      f"{d.shard_budget_bytes / 2**20:.2f} MiB"
                      if d.shard_budget_bytes else "")
            lines.append(f"  dist {d.kind:6s} {d.name:28s} "
                         f"{state}  {specs}{budget}")
            for note in d.notes:
                lines.append(f"    note: {note}")
        for f in self.verify:
            lines.append(f"  verify [{f.severity}] {f.invariant} "
                         f"@ {f.subject}: {f.detail}")
        return "\n".join(lines)


#: OpKinds the paper leaves untouched by design.
BACKBONE_KINDS = frozenset({
    ir.OpKind.MATMUL, ir.OpKind.CONV2D, ir.OpKind.ATTENTION,
    ir.OpKind.SSD, ir.OpKind.EMBED,
})


def coverage_report(segments, plans: Mapping[int, collapse.CollapsePlan],
                    shapes: Mapping[str, tuple[int, ...]],
                    itemsize: int,
                    kernel_dispatch: Mapping[int, registry.KernelDispatch]
                    | None = None,
                    vetoes: tuple[registry.KernelVeto, ...] = (),
                    autotune_decisions: Mapping[int, autotune.Decision]
                    | None = None,
                    verify: tuple = (), verify_seconds: float = 0.0,
                    partitions: partition_mod.PartitionPlan | None = None
                    ) -> CoverageReport:
    """Per-stack coverage + planned HBM traffic (analytic bytes from shapes,
    not measured) of a rewritten network, its registry dispatches, the
    registry's vetoed matches, the committed autotune decisions (keyed
    by segment index, -1 for the function-level floor), the static
    verifier's findings and the mesh partition plan (None on one
    device)."""
    kernel_dispatch = kernel_dispatch or {}
    mesh_axes: tuple = ()
    dist: list[DistCoverage] = []
    if partitions is not None and partitions.segments:
        mesh_axes = tuple(zip(partitions.axes.names, partitions.axes.shape))
        for idx, part in sorted(partitions.segments.items()):
            seg = segments[idx]
            plan = plans.get(idx) if seg.is_stack else None
            dist.append(DistCoverage(
                name=seg.stack.name if seg.is_stack else seg.op.name,
                kind="stack" if seg.is_stack else "kernel",
                in_specs=tuple((k, str(s))
                               for k, s in part.in_specs.items()),
                out_specs=tuple((k, str(s))
                                for k, s in part.out_specs.items()),
                active=part.active,
                shard_budget_bytes=(plan.device.resource_limit
                                    if plan is not None else 0),
                notes=part.notes))
    tuned = tuple(
        AutotuneCoverage(
            name=d.name, kind=d.kind, requested=d.requested,
            baseline=d.baseline, chosen=d.variant,
            guardrail_tripped=d.guardrail_tripped, source=d.source,
            measured_ms=d.measured_ms, events=d.events,
            failures=d.failures)
        for _, d in sorted((autotune_decisions or {}).items()))
    n_captured = n_opaque = n_backbone = n_synthetic = 0
    stacks: list[StackCoverage] = []
    kernels: list[KernelCoverage] = []
    for idx, seg in enumerate(segments):
        if seg.is_stack:
            n_captured += len(seg.stack.ops)
            plan = plans[idx]
            in_shapes = {v: tuple(shapes[v]) for v in seg.stack.inputs}
            bf = resource.breadth_first_traffic(seg.stack, in_shapes,
                                                itemsize)
            df = resource.depth_first_traffic(plan, in_shapes, itemsize)
            stacks.append(StackCoverage(
                name=seg.stack.name, n_ops=len(seg.stack.ops),
                kinds=tuple(op.kind.value for op in seg.stack.ops),
                n_sequences=len(plan.sequences),
                hbm_breadth_bytes=bf, hbm_depth_bytes=df,
                tiles=tuple(f"rows {q.tile_rows}" if q.tile_rows else
                            f"{q.tile_out_h}x{q.tile_out_w}"
                            for q in plan.sequences),
                differentiable=plan.differentiable))
        elif seg.op.kind == ir.OpKind.KERNEL:
            d = kernel_dispatch.get(idx)
            kernels.append(KernelCoverage(
                op_name=seg.op.name, kernel=seg.op.attrs["kernel"],
                backend=d.backend.value if d else "unknown",
                fallback_reason=d.reason if d else None))
        elif seg.op.attrs.get("synthetic"):
            n_synthetic += 1
        elif seg.op.kind in BACKBONE_KINDS:
            n_backbone += 1
        else:
            n_opaque += 1
    total = n_captured + n_opaque + n_backbone + len(kernels)
    eligible = n_captured + n_opaque
    return CoverageReport(
        n_ops=total, n_captured=n_captured, n_opaque=n_opaque,
        n_backbone=n_backbone, n_stacks=len(stacks),
        capture_ratio=n_captured / eligible if eligible else 1.0,
        stacks=tuple(stacks), n_synthetic=n_synthetic,
        n_kernel=len(kernels), kernels=tuple(kernels), vetoes=tuple(vetoes),
        autotune=tuned, verify=tuple(verify), verify_seconds=verify_seconds,
        mesh_axes=mesh_axes, dist=tuple(dist))


def run_segments(segments, executors: Mapping[int, codegen.Executor],
                 env: dict, params: Mapping[str, torch.Tensor]) -> dict:
    """Execute a rewritten network: stacks and registry KERNEL ops through
    their compiled executors, opaque ops breadth-first through the
    interpreter.  Mutates and returns ``env``."""
    for idx, seg in enumerate(segments):
        if seg.is_stack:
            env.update(executors[idx]({k: env[k] for k in seg.stack.inputs},
                                      params))
        elif seg.op.kind == ir.OpKind.KERNEL:
            env.update(executors[idx]({k: env[k] for k in seg.op.inputs},
                                      params))
        else:
            env[seg.op.output] = ir.apply_op(seg.op, env, params)
    return env


@dataclasses.dataclass
class OptimizedNet:
    """A rewritten network: opaque segments + compiled stacks (the paper's
    BrainSlug layers standing in for the collapsed originals)."""

    graph: ir.NetGraph
    segments: list
    executors: dict[int, codegen.Executor]
    plans: dict[int, collapse.CollapsePlan]
    config: OptimizeConfig
    device: torch.device
    shapes: dict[str, tuple[int, ...]] = dataclasses.field(
        default_factory=dict)   # value name -> inferred shape
    kernel_dispatches: dict[int, registry.KernelDispatch] = \
        dataclasses.field(default_factory=dict)
    autotune_decisions: dict[int, autotune.Decision] = dataclasses.field(
        default_factory=dict)
    #: The static verifier's findings at compile time (verify='warn' waives
    #: error findings but keeps them here and in report()), and its host
    #: seconds.
    verify_findings: tuple = ()
    verify_seconds: float = 0.0
    #: Mesh partition plan (None for single-device compiles).
    partitions: partition_mod.PartitionPlan | None = None

    def __call__(self, x: torch.Tensor,
                 params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        _check_device(self.device, {self.graph.input: x, **params})
        env = run_segments(self.segments, self.executors,
                           {self.graph.input: x}, params)
        return env[self.graph.output]

    @property
    def n_stacks(self) -> int:
        return len(self.executors)

    @property
    def n_sequences(self) -> int:
        return sum(len(p.sequences) for p in self.plans.values())

    def report(self) -> CoverageReport:
        """Per-stack coverage + planned HBM traffic of this rewrite."""
        return coverage_report(self.segments, self.plans, self.shapes,
                               self.config.itemsize,
                               kernel_dispatch=self.kernel_dispatches,
                               autotune_decisions=self.autotune_decisions,
                               verify=self.verify_findings,
                               verify_seconds=self.verify_seconds,
                               partitions=self.partitions)

    def explain(self) -> str:
        """Human-readable :meth:`report`."""
        return str(self.report())


def compile_stacks(segments, shapes: Mapping[str, tuple[int, ...]],
                   config: OptimizeConfig, *,
                   param_shapes: Mapping[str, tuple[int, ...]] | None = None,
                   dtypes: Mapping[str, torch.dtype] | None = None,
                   tuner: autotune.Autotuner | None = None
                   ) -> tuple[dict[int, codegen.Executor],
                              dict[int, collapse.CollapsePlan],
                              dict[int, registry.KernelDispatch],
                              dict[int, autotune.Decision], tuple,
                              partition_mod.PartitionPlan | None]:
    """Collapse + compile every stack segment, and compile every registry
    KERNEL segment, against ``config``.  With ``config.autotune`` (or an
    explicit ``tuner``) each segment's variant is measured and hard-floored
    at its baseline (:mod:`repro_torch.core.autotune`); ``param_shapes``
    and ``dtypes`` (the trace's, where there is one) shape the measured
    operands.

    Three stages: every stack is planned (collapsed, or measured and
    committed); then, unless ``config.verify == 'off'``,
    :func:`repro_torch.core.verify.verify_segments` re-derives each plan's
    invariants, and under ``'strict'`` a violation raises
    :class:`~repro_torch.core.verify.VerifyError` before anything
    compiles; then codegen.  Returns (executors, plans, kernel dispatch
    records, autotune decisions), each keyed by segment index, the
    verifier's findings and the partition plan (None without a mesh).

    With ``config.mesh`` and ``config.partition != 'none'`` every stack and
    registry-kernel segment gets derived boundary specs
    (:func:`repro_torch.core.partition.plan_segments`); active stacks
    collapse against their per-shard input shapes on the haircut device
    (:func:`repro_torch.core.resource.shard_device`), and codegen wraps
    their executors in sharded calls.  Autotuning is off under a mesh."""
    partitions: partition_mod.PartitionPlan | None = None
    shard_dev = config.device
    if config.mesh is not None and config.partition != "none":
        partitions = partition_mod.plan_segments(
            segments, shapes, param_shapes, config.partition, config.mesh,
            sublane=config.device.sublane)
        shard_dev = resource.shard_device(config.device,
                                          partitions.axes.n_devices)
        tuner = None
    elif tuner is None and config.autotune:
        tuner = autotune.Autotuner.from_config(config)
    # a sharded call needs ranks; a MeshAxes skeleton (the lint) drives
    # per-shard sizing and verification only
    exec_mesh = (config.mesh if partitions is not None
                 and hasattr(config.mesh, "groups") else None)
    executors: dict[int, codegen.Executor] = {}
    plans: dict[int, collapse.CollapsePlan] = {}
    modes: dict[int, str] = {}
    dispatches: dict[int, registry.KernelDispatch] = {}
    decisions: dict[int, autotune.Decision] = {}

    # Stage 1: plan every stack (collapse, or measure and commit).
    for idx, seg in enumerate(segments):
        if not seg.is_stack:
            continue
        in_shapes = {v: tuple(shapes[v]) for v in seg.stack.inputs}
        modes[idx] = config.mode
        part = partitions.get(idx) if partitions is not None else None
        if part is not None and part.active:
            # per-shard sizing: collapse what one rank's sharded call runs
            plans[idx] = collapse.collapse(
                seg.stack, partition_mod.shard_shapes(
                    in_shapes, part.in_specs, partitions.axes),
                shard_dev, itemsize=config.itemsize,
                max_steps_per_sequence=config.max_steps_per_sequence,
                differentiable=config.differentiable)
        elif tuner is not None and config.mode != "barrier":
            # barrier IS the floor: nothing to measure against
            decisions[idx], modes[idx], plans[idx] = autotune.tune_stack(
                tuner, seg.stack, in_shapes, config,
                param_shapes=param_shapes, dtypes=dtypes)
        else:
            plans[idx] = collapse.collapse(
                seg.stack, in_shapes, config.device,
                itemsize=config.itemsize,
                max_steps_per_sequence=config.max_steps_per_sequence,
                differentiable=config.differentiable)

    # Stage 2: the static verifier, between planning and codegen.
    findings: tuple = ()
    if config.verify != "off":
        findings = tuple(verify_mod.verify_segments(
            segments, plans, shapes, config, dtypes=dtypes,
            param_shapes=param_shapes, partitions=partitions))
        verify_mod.enforce(findings, config.verify)

    # Stage 3: codegen (reached when verification passed or was waived).
    for idx, seg in enumerate(segments):
        part = partitions.get(idx) if partitions is not None else None
        if seg.is_stack:
            executors[idx] = codegen.compile_plan(
                plans[idx], mode=modes[idx],
                cache_size=config.code_cache_size, mesh=exec_mesh,
                part=part)
        elif seg.op.kind == ir.OpKind.KERNEL:
            backend = reason = None
            if tuner is not None:
                tuned = autotune.tune_kernel(tuner, seg.op, config)
                if tuned is not None:
                    decisions[idx], backend, reason = tuned
            executors[idx], dispatches[idx] = codegen.compile_kernel_op(
                seg.op, mode=config.mode,
                cache_size=config.code_cache_size, backend=backend,
                reason=reason, mesh=exec_mesh, part=part)
    return executors, plans, dispatches, decisions, findings, partitions


def optimize_graph(graph: ir.NetGraph,
                   input_shape: tuple[int, ...],
                   config: OptimizeConfig = OptimizeConfig(),
                   layout: str = "nhwc",
                   param_shapes: Mapping[str, tuple[int, ...]] | None = None
                   ) -> OptimizedNet:
    """``graph`` compiled for inputs of ``input_shape``.  ``param_shapes``
    (the shapes of the parameters the net will be called with) lets a mesh
    partition the stacks that read parameters; without it such a stack is
    replicated, as in the JAX package, whose ``optimize_graph`` takes
    none."""
    device = resolve_device(config)
    segments = analyzer.analyze(graph, layout=layout,  # validates layout
                                keep=frozenset({graph.output}))
    shapes: dict[str, tuple[int, ...]] = {graph.input: tuple(input_shape)}
    for seg in segments:
        if seg.is_stack:
            in_shapes = {v: shapes[v] for v in seg.stack.inputs}
            shapes.update(ir.infer_shapes(seg.stack, in_shapes))
        else:
            _infer_opaque_shape(seg.op, shapes)
    spent = verify_mod.STATS.seconds
    graph_findings: tuple = ()
    if config.verify != "off":
        graph_findings = tuple(verify_mod.verify_graph(graph, shapes))
        verify_mod.enforce(graph_findings, config.verify,
                           subject=graph.name)
    executors, plans, dispatches, decisions, findings, parts = \
        compile_stacks(segments, shapes, config, param_shapes=param_shapes)
    return OptimizedNet(graph=graph, segments=segments, executors=executors,
                        plans=plans, config=config, device=device,
                        shapes=shapes, kernel_dispatches=dispatches,
                        autotune_decisions=decisions,
                        verify_findings=graph_findings + findings,
                        verify_seconds=verify_mod.STATS.seconds - spent,
                        partitions=parts)


def optimize_stack(program: ir.StackProgram,
                   input_shapes: Mapping[str, tuple[int, ...]],
                   config: OptimizeConfig = OptimizeConfig(),
                   param_shapes: Mapping[str, tuple[int, ...]] | None = None
                   ) -> codegen.Executor:
    """One stack's executor.  Under a mesh the stack is partitioned
    (``param_shapes`` gives its parameters' shapes; without them a stack
    with parameters stays replicated), collapsed per shard and run in a
    sharded call, as :func:`compile_stacks` does for a whole net."""
    resolve_device(config)
    if config.mesh is None or config.partition == "none":
        plan = collapse.collapse(
            program, input_shapes, config.device, itemsize=config.itemsize,
            max_steps_per_sequence=config.max_steps_per_sequence,
            differentiable=config.differentiable)
        return codegen.compile_plan(plan, mode=config.mode,
                                    cache_size=config.code_cache_size)
    seg = analyzer.Segment(stack=program)
    shapes = dict(ir.infer_shapes(program, input_shapes))
    executors, *_ = compile_stacks([seg], shapes, config,
                                   param_shapes=param_shapes)
    return executors[0]


def _infer_opaque_shape(op: ir.OpNode, shapes: dict) -> None:
    """Shape propagation for the opaque kinds appearing in NetGraphs."""
    if op.kind == ir.OpKind.CONV2D:
        n, h, w, _ = shapes[op.inputs[0]]
        kh, kw, _, co = op.attrs["kernel_shape"]
        sh, sw = op.attrs.get("stride", (1, 1))
        ph, pw = op.attrs.get("padding", (0, 0))
        shapes[op.output] = (n, ir.pool_out_extent(h, kh, sh, ph),
                             ir.pool_out_extent(w, kw, sw, pw), co)
    elif op.kind == ir.OpKind.MATMUL:
        shp = shapes[op.inputs[0]]
        shapes[op.output] = shp[:-1] + (op.attrs["features_out"],)
    elif (op.kind in (ir.OpKind.OPAQUE, ir.OpKind.KERNEL)
          and "out_shape" in op.attrs):
        shapes[op.output] = tuple(op.attrs["out_shape"])
    else:
        shapes[op.output] = shapes[op.inputs[0]]
