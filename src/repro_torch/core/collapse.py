"""The Collapser — paper compile-phase steps 3-4 (Listing 1).

Maps a stack's operations onto **Steps** (at most one non-element-wise op
per step) and packs steps into **Sequences** subject to the device resource
model.  Each sequence becomes one fused depth-first kernel launch; sequences
within a stack execute serially through a materialised intermediate.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core import ir, resource


@dataclasses.dataclass(frozen=True)
class Step:
    ops: tuple[ir.OpNode, ...]


@dataclasses.dataclass(frozen=True)
class SequencePlan:
    """One fused kernel: consecutive steps whose double-buffered working set
    fits the device budget."""

    steps: tuple[Step, ...]
    # rows layout: chosen row-tile extent.  nhwc: output patch extents.
    tile_rows: int = 0
    tile_out_h: int = 0
    tile_out_w: int = 0

    @property
    def ops(self) -> tuple[ir.OpNode, ...]:
        return tuple(op for s in self.steps for op in s.ops)


@dataclasses.dataclass(frozen=True)
class CollapsePlan:
    """Result of collapsing one StackProgram."""

    program: ir.StackProgram
    sequences: tuple[SequencePlan, ...]
    device: resource.DeviceSpec
    # Sorted (name, shape) pairs the plan was sized against; part of the
    # code-cache key.
    input_shapes: tuple = ()
    itemsize: int = 4
    # Sized for training: the joint forward + backward working set.
    differentiable: bool = False

    def subprogram(self, i: int) -> ir.StackProgram:
        """Sequence ``i`` as a standalone StackProgram (its inputs are the
        stack inputs still live plus the previous sequence's boundary
        value)."""
        seq_ops = self.sequences[i].ops
        defined_in = {op.output for op in seq_ops}
        ins: list[str] = []
        for op in seq_ops:
            for v in op.inputs:
                if v not in defined_in and v not in ins:
                    ins.append(v)
        needed_later: set[str] = set(self.program.outputs)
        for s in self.sequences[i + 1:]:
            for op in s.ops:
                needed_later.update(op.inputs)
        outs = [op.output for op in seq_ops if op.output in needed_later]
        if not outs:
            outs = [seq_ops[-1].output]
        return ir.StackProgram(
            name=f"{self.program.name}_seq{i}", inputs=tuple(ins),
            outputs=tuple(outs), ops=seq_ops, layout=self.program.layout)


def build_steps(program: ir.StackProgram) -> list[Step]:
    """Group ops into steps (Listing 1 part 3): element-wise ops always join
    the current step; a non-element-wise op joins only if the step has none
    yet, otherwise it opens a new step."""
    steps: list[list[ir.OpNode]] = []
    cur: list[ir.OpNode] = []
    cur_has_nonew = False
    for op in program.ops:
        if op.is_elementwise:
            cur.append(op)
        elif not cur_has_nonew:
            cur.append(op)
            cur_has_nonew = True
        else:
            steps.append(cur)
            cur = [op]
            cur_has_nonew = True
    if cur:
        steps.append(cur)
    return [Step(ops=tuple(s)) for s in steps]


def collapse(program: ir.StackProgram,
             input_shapes: Mapping[str, tuple[int, ...]],
             device: resource.DeviceSpec = resource.H100,
             *,
             itemsize: int = 4,
             max_steps_per_sequence: int | None = None,
             differentiable: bool = False) -> CollapsePlan:
    """Collapse ``program`` into sequences sized for ``device``.
    ``max_steps_per_sequence`` is the paper's Fig. 10 strategy knob
    (1 step / 5 steps / unrestricted).

    ``differentiable=True`` sizes sequences against the joint forward +
    backward working set (the backward recomputes the chain on the resident
    tile with cotangents live beside it): smaller ``tile_rows`` or
    ``tile_out_h/w`` and earlier splits, one geometry for both kernels."""
    steps = build_steps(program)
    if program.layout == "rows":
        seqs = _pack_rows(program, steps, input_shapes, device, itemsize,
                          max_steps_per_sequence, differentiable)
    else:
        seqs = _pack_nhwc(program, steps, input_shapes, device, itemsize,
                          max_steps_per_sequence, differentiable)
    return CollapsePlan(
        program=program, sequences=tuple(seqs), device=device,
        input_shapes=tuple(sorted((k, tuple(v))
                                  for k, v in input_shapes.items())),
        itemsize=itemsize, differentiable=differentiable)


def _pack_rows(program: ir.StackProgram, steps: list[Step],
               input_shapes: Mapping[str, tuple[int, ...]],
               device: resource.DeviceSpec, itemsize: int,
               max_steps: int | None,
               differentiable: bool = False) -> list[SequencePlan]:
    """rows layout: norms are row-local, so the working set never grows with
    stacking — one sequence almost always suffices; the row-tile extent is
    chosen to fill the budget (the joint one when ``differentiable``)."""
    features = max((input_shapes[v][-1] if v in input_shapes else 0)
                   for v in program.inputs)

    def one_row_bytes(sub: ir.StackProgram) -> int:
        n_live = (resource.max_live_values_bwd(sub) if differentiable
                  else resource.max_live_values(sub))
        f = resource.planned_features(sub, features, device, differentiable)
        return resource.rows_tile_bytes(n_live, device.sublane, f, itemsize,
                                        device)

    def needed_after(si: int) -> set[str]:
        """Values consumed by steps from index ``si`` on, or escaping the
        stack: a flushed sequence must hold these live to its end."""
        need = set(program.outputs)
        for s in steps[si:]:
            for op in s.ops:
                need.update(op.inputs)
        return need

    seqs: list[SequencePlan] = []
    pending: list[Step] = []

    def flush(later: set[str]) -> None:
        nonlocal pending
        if not pending:
            return
        sub = _resource_view(program, tuple(op for s in pending
                                            for op in s.ops), later)
        rows = resource.pick_row_tile(sub, features, itemsize, device,
                                      differentiable=differentiable)
        seqs.append(SequencePlan(steps=tuple(pending), tile_rows=rows))
        pending = []

    for si, step in enumerate(steps):
        pending.append(step)
        sub = _resource_view(program, tuple(op for s in pending
                                            for op in s.ops),
                             needed_after(si + 1))
        too_big = one_row_bytes(sub) > device.resource_limit
        over_steps = max_steps is not None and len(pending) > max_steps
        if too_big or over_steps:
            pending.pop()
            flush(needed_after(si))        # popped step consumes its inputs
            pending = [step]
    flush(set(program.outputs))
    return seqs


def _resource_view(program: ir.StackProgram,
                   sub_ops: tuple[ir.OpNode, ...],
                   needed_later: set[str] = frozenset()
                   ) -> ir.StackProgram:
    """A valid StackProgram over a candidate run of ops, for resource
    accounting only: inputs are whatever the run reads but does not define;
    outputs are the run tail plus every run-defined value consumed after
    the run."""
    defined = {op.output for op in sub_ops}
    ins: list[str] = []
    for op in sub_ops:
        for v in op.inputs:
            if v not in defined and v not in ins:
                ins.append(v)
    outs = [op.output for op in sub_ops if op.output in needed_later]
    if sub_ops[-1].output not in outs:
        outs.append(sub_ops[-1].output)
    return ir.StackProgram(name=program.name, inputs=tuple(ins),
                           outputs=tuple(outs), ops=sub_ops,
                           layout=program.layout)


def _pack_nhwc(program: ir.StackProgram, steps: list[Step],
               input_shapes: Mapping[str, tuple[int, ...]],
               device: resource.DeviceSpec, itemsize: int,
               max_steps: int | None,
               differentiable: bool = False) -> list[SequencePlan]:
    """nhwc layout (Listing 1 part 4): keep a candidate sequence, and when
    its receptive-field-grown working set exceeds the limit, close it and
    start a new one.  The output patch shrinks if even a single step
    overflows the budget.  ``differentiable`` plans against the joint
    working set (every halo level live through the reverse sweep)."""

    def fits(run: list[tuple[ir.OpNode, ...]], h: int, w: int) -> bool:
        return resource.fits(run, h, w, channels, itemsize, device,
                             differentiable=differentiable)

    shape = next(iter(input_shapes.values()))
    channels = shape[-1]
    out_h = out_w = 8          # output patch per tile
    while out_h > 1 and not all(fits([s.ops], out_h, out_w) for s in steps):
        out_h //= 2
        out_w //= 2
    if not all(fits([s.ops], out_h, out_w) for s in steps):
        raise resource.ResourceError(
            f"{program.name}: single step exceeds device budget at 1x1 tile")

    seqs: list[SequencePlan] = []
    pending: list[Step] = []
    for step in steps:
        pending.append(step)
        over_steps = max_steps is not None and len(pending) > max_steps
        if over_steps or not fits([s.ops for s in pending], out_h, out_w):
            pending.pop()                      # sequence.remove(step)
            if not pending:
                raise resource.ResourceError(
                    f"{program.name}: single step exceeds device budget")
            seqs.append(SequencePlan(steps=tuple(pending),
                                     tile_out_h=out_h, tile_out_w=out_w))
            pending = [step]
    if pending:
        seqs.append(SequencePlan(steps=tuple(pending),
                                 tile_out_h=out_h, tile_out_w=out_w))
    return seqs
