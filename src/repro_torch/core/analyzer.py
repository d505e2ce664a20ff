"""Network Analyzer — paper compile-phase steps 1-2.

Walks a :class:`~repro_torch.core.ir.NetGraph` and gathers maximal runs of
optimizable ops into :class:`~repro_torch.core.ir.StackProgram`s, leaving
non-optimizable ops (conv / matmul / attention / ssd) untouched ("Convolution
and linear layers cannot be optimized and are left untouched", Fig. 9).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import ir


@dataclasses.dataclass(frozen=True)
class Segment:
    """One element of the rewritten network: either an opaque op or a stack."""

    op: ir.OpNode | None = None
    stack: ir.StackProgram | None = None

    @property
    def is_stack(self) -> bool:
        return self.stack is not None


#: Layouts ``analyze`` accepts.  ``auto`` classifies per run: pooling forces
#: the spatial nhwc model, everything else is row-local.
LAYOUTS = ("rows", "nhwc", "auto")


def _run_to_stack(name: str, run: list[ir.OpNode], layout: str,
                  available: set[str]) -> ir.StackProgram:
    """Package a maximal optimizable run as a StackProgram.  External inputs
    are every value the run reads but does not define (this captures residual
    edges as saved-value inputs)."""
    if layout == "auto":
        layout = ("nhwc" if any(op.kind == ir.OpKind.POOL2D for op in run)
                  else "rows")
    defined = {op.output for op in run}
    inputs: list[str] = []
    for op in run:
        for v in op.inputs:
            if v not in defined and v not in inputs:
                if v not in available:
                    raise ValueError(f"run reads unknown value {v!r}")
                inputs.append(v)
    outputs = [run[-1].output]
    return ir.StackProgram(name=name, inputs=tuple(inputs),
                           outputs=tuple(outputs), ops=tuple(run),
                           layout=layout)


def analyze(graph: ir.NetGraph, layout: str = "nhwc",
            keep: frozenset[str] = frozenset()) -> list[Segment]:
    """Partition ``graph`` into opaque segments and optimizable stacks.

    A run is broken when (a) the op is not optimizable, or (b) a value
    produced inside the current run is consumed by a later op outside it
    other than through the run tail — (b) keeps the rewrite
    semantics-preserving for residual fan-out.  ``keep`` names values that
    must stay visible after the rewrite though no later op consumes them.
    """
    if layout not in LAYOUTS:
        raise ValueError(
            f"unknown layout {layout!r}; allowed layouts: {LAYOUTS}")
    consumers: dict[str, list[int]] = {}
    for i, op in enumerate(graph.ops):
        for v in op.inputs:
            consumers.setdefault(v, []).append(i)

    segments: list[Segment] = []
    run: list[ir.OpNode] = []
    available: set[str] = {graph.input}
    n_stacks = 0

    def flush(upto: int) -> None:
        nonlocal run, n_stacks
        if not run:
            return
        internal = {op.output for op in run[:-1]}
        escapes = [v for v in internal
                   if v in keep
                   or any(j >= upto for j in consumers.get(v, []))]
        if escapes:
            # split at the last escaping definition: everything up to and
            # including it runs op by op, the rest forms the stack.
            last = max(i for i, op in enumerate(run) if op.output in escapes)
            for op in run[: last + 1]:
                segments.append(Segment(op=op))
            run = run[last + 1:]
            if not run:
                return
        stack = _run_to_stack(f"{graph.name}_stack{n_stacks}", run, layout,
                              available | {op.output for op in run})
        n_stacks += 1
        segments.append(Segment(stack=stack))
        run = []

    for i, op in enumerate(graph.ops):
        if op.is_optimizable:
            run.append(op)
        else:
            flush(i)
            segments.append(Segment(op=op))
        available.add(op.output)
    flush(len(graph.ops))
    return segments


def count_optimizable(graph: ir.NetGraph) -> tuple[int, int, int]:
    """(total ops, optimizable ops, stacks) — the paper's Table 2 columns."""
    segs = analyze(graph)
    total = len(graph.ops)
    opt = sum(len(s.stack.ops) for s in segs if s.is_stack)
    stacks = sum(1 for s in segs if s.is_stack)
    return total, opt, stacks
