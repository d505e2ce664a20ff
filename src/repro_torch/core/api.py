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
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core import (analyzer, autotune, codegen, collapse, ir,
                              registry, resource)

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

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; allowed modes: {MODES}")
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
                    | None = None
                    ) -> CoverageReport:
    """Per-stack coverage + planned HBM traffic (analytic bytes from shapes,
    not measured) of a rewritten network, its registry dispatches, the
    registry's vetoed matches and the committed autotune decisions (keyed
    by segment index, -1 for the function-level floor)."""
    kernel_dispatch = kernel_dispatch or {}
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
        autotune=tuned)


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
                               autotune_decisions=self.autotune_decisions)

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
                              dict[int, autotune.Decision]]:
    """Collapse + compile every stack segment, and compile every registry
    KERNEL segment, against ``config``.  With ``config.autotune`` (or an
    explicit ``tuner``) each segment's variant is measured and hard-floored
    at its baseline (:mod:`repro_torch.core.autotune`); ``param_shapes``
    and ``dtypes`` (the trace's, where there is one) shape the measured
    operands.  Returns (executors, plans, kernel dispatch records, autotune
    decisions), each keyed by segment index."""
    if tuner is None and config.autotune:
        tuner = autotune.Autotuner.from_config(config)
    executors: dict[int, codegen.Executor] = {}
    plans: dict[int, collapse.CollapsePlan] = {}
    dispatches: dict[int, registry.KernelDispatch] = {}
    decisions: dict[int, autotune.Decision] = {}
    for idx, seg in enumerate(segments):
        if not seg.is_stack:
            if seg.op.kind == ir.OpKind.KERNEL:
                backend = reason = None
                if tuner is not None:
                    tuned = autotune.tune_kernel(tuner, seg.op, config)
                    if tuned is not None:
                        decisions[idx], backend, reason = tuned
                executors[idx], dispatches[idx] = codegen.compile_kernel_op(
                    seg.op, mode=config.mode,
                    cache_size=config.code_cache_size, backend=backend,
                    reason=reason)
            continue
        in_shapes = {v: tuple(shapes[v]) for v in seg.stack.inputs}
        mode = config.mode
        if tuner is not None and config.mode != "barrier":
            # barrier IS the floor: nothing to measure against
            decisions[idx], mode, plans[idx] = autotune.tune_stack(
                tuner, seg.stack, in_shapes, config,
                param_shapes=param_shapes, dtypes=dtypes)
        else:
            plans[idx] = collapse.collapse(
                seg.stack, in_shapes, config.device,
                itemsize=config.itemsize,
                max_steps_per_sequence=config.max_steps_per_sequence,
                differentiable=config.differentiable)
        executors[idx] = codegen.compile_plan(
            plans[idx], mode=mode, cache_size=config.code_cache_size)
    return executors, plans, dispatches, decisions


def optimize_graph(graph: ir.NetGraph,
                   input_shape: tuple[int, ...],
                   config: OptimizeConfig = OptimizeConfig(),
                   layout: str = "nhwc") -> OptimizedNet:
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
    executors, plans, dispatches, decisions = compile_stacks(
        segments, shapes, config)
    return OptimizedNet(graph=graph, segments=segments, executors=executors,
                        plans=plans, config=config, device=device,
                        shapes=shapes, kernel_dispatches=dispatches,
                        autotune_decisions=decisions)


def optimize_stack(program: ir.StackProgram,
                   input_shapes: Mapping[str, tuple[int, ...]],
                   config: OptimizeConfig = OptimizeConfig()
                   ) -> codegen.Executor:
    resolve_device(config)
    plan = collapse.collapse(
        program, input_shapes, config.device, itemsize=config.itemsize,
        max_steps_per_sequence=config.max_steps_per_sequence,
        differentiable=config.differentiable)
    return codegen.compile_plan(plan, mode=config.mode,
                                cache_size=config.code_cache_size)


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
