"""Public BrainSlug API on PyTorch — the paper's ``brainslug.optimize(model)``.

Two entry points:

* :func:`optimize_graph` — the whole-network path (CNN family): takes a
  :class:`~repro_torch.core.ir.NetGraph`, finds optimizable runs, collapses
  them against the device budget, and returns an :class:`OptimizedNet`
  whose ``__call__`` executes opaque ops breadth-first and collapsed stacks
  depth-first.
* :func:`optimize_stack` — the composable path of the LM layers: takes one
  :class:`~repro_torch.core.ir.StackProgram` and returns a fused executor.

Both run on ``cuda`` unless the config asks for ``cpu``
(``OptimizeConfig(torch_device="cpu")``); asking for ``cuda`` without a GPU
raises ``RuntimeError``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core import analyzer, codegen, collapse, ir, resource

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
        if not isinstance(self.differentiable, bool):
            raise ValueError(f"differentiable must be a bool, got "
                             f"{self.differentiable!r}")
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
class CoverageReport:
    """What the optimizer captured — the ``report()``/``explain()`` payload.

    ``capture_ratio`` is computed over the ops that could have been
    captured: everything except the backbone kinds (matmul / conv /
    attention / ssd / embed), which the paper's optimizer leaves untouched
    by design.  ``n_opaque`` counts ops that stayed OPAQUE."""

    n_ops: int
    n_captured: int
    n_opaque: int
    n_backbone: int
    n_stacks: int
    capture_ratio: float
    stacks: tuple[StackCoverage, ...]

    def __str__(self) -> str:
        lines = [
            f"ops total={self.n_ops}  captured={self.n_captured}  "
            f"opaque-fallback={self.n_opaque}  backbone={self.n_backbone}  "
            f"stacks={self.n_stacks}  "
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
        return "\n".join(lines)


#: OpKinds the paper leaves untouched by design.
BACKBONE_KINDS = frozenset({
    ir.OpKind.MATMUL, ir.OpKind.CONV2D, ir.OpKind.ATTENTION,
    ir.OpKind.SSD, ir.OpKind.EMBED,
})


def coverage_report(segments, plans: Mapping[int, collapse.CollapsePlan],
                    shapes: Mapping[str, tuple[int, ...]],
                    itemsize: int) -> CoverageReport:
    """Per-stack coverage + planned HBM traffic (analytic bytes from shapes,
    not measured) of a rewritten network."""
    n_captured = n_opaque = n_backbone = 0
    stacks: list[StackCoverage] = []
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
        elif seg.op.kind in BACKBONE_KINDS:
            n_backbone += 1
        else:
            n_opaque += 1
    total = n_captured + n_opaque + n_backbone
    eligible = n_captured + n_opaque
    return CoverageReport(
        n_ops=total, n_captured=n_captured, n_opaque=n_opaque,
        n_backbone=n_backbone, n_stacks=len(stacks),
        capture_ratio=n_captured / eligible if eligible else 1.0,
        stacks=tuple(stacks))


def run_segments(segments, executors: Mapping[int, codegen.Executor],
                 env: dict, params: Mapping[str, torch.Tensor]) -> dict:
    """Execute a rewritten network: stacks through their compiled
    executors, opaque ops breadth-first through the interpreter.  Mutates
    and returns ``env``."""
    for idx, seg in enumerate(segments):
        if seg.is_stack:
            env.update(executors[idx]({k: env[k] for k in seg.stack.inputs},
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
                               self.config.itemsize)

    def explain(self) -> str:
        """Human-readable :meth:`report`."""
        return str(self.report())


def compile_stacks(segments, shapes: Mapping[str, tuple[int, ...]],
                   config: OptimizeConfig
                   ) -> tuple[dict[int, codegen.Executor],
                              dict[int, collapse.CollapsePlan]]:
    """Collapse + compile every stack segment against ``config``.
    Returns (executors, plans), both keyed by segment index."""
    executors: dict[int, codegen.Executor] = {}
    plans: dict[int, collapse.CollapsePlan] = {}
    for idx, seg in enumerate(segments):
        if not seg.is_stack:
            continue
        in_shapes = {v: tuple(shapes[v]) for v in seg.stack.inputs}
        plans[idx] = collapse.collapse(
            seg.stack, in_shapes, config.device, itemsize=config.itemsize,
            max_steps_per_sequence=config.max_steps_per_sequence,
            differentiable=config.differentiable)
        executors[idx] = codegen.compile_plan(
            plans[idx], mode=config.mode, cache_size=config.code_cache_size)
    return executors, plans


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
    executors, plans = compile_stacks(segments, shapes, config)
    return OptimizedNet(graph=graph, segments=segments, executors=executors,
                        plans=plans, config=config, device=device,
                        shapes=shapes)


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
