"""BrainSlug resource model, sized for a GPU's shared memory.

The paper sizes depth-first tiles against the fastest memory a block owns
(16 kB of GPU shared memory in the paper).  On Hopper that level is the
per-CTA shared memory: 227 KiB (232,448 bytes) that one block may opt in
to.  The structure of the model is the one ``repro.core.resource`` uses:

    resource consumption of a sequence of steps
        = the data each step needs, for the tile geometry,
          double-buffered between steps,
        and it must fit the device budget.

``TINY_DEVICE`` is kept from the JAX package so the two packages can be held
to identical plans; :data:`H100` is the port's own device.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core import ir


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Back-end hardware description (paper: back-ends report device specs
    to the optimizer).

    ``fast_bytes`` is the fast memory one depth-first tile may live in, and
    ``budget_fraction`` the slice of it the collapser plans against.
    ``lane`` is the trailing-dimension granule tiles are rounded up to and
    ``sublane`` the row granule.  The rates (bytes/s, float32 FLOP/s) give
    kernel bounds; 0 means "not a real device".

    ``f_chunk`` (port only; 0 = none) is the feature chunk the generated
    rows backward walks an *F-separable* chain in (see
    :func:`planned_features`).  Specs without it plan exactly as the JAX
    package does."""

    name: str
    fast_bytes: int
    budget_fraction: float
    lane: int
    sublane: int
    hbm_bandwidth: float = 0.0
    peak_flops_f32: float = 0.0
    f_chunk: int = 0

    @property
    def resource_limit(self) -> int:
        return int(self.fast_bytes * self.budget_fraction)


#: A deliberately tiny device used by tests to force multi-sequence splits.
#: Same numbers as ``repro.core.resource.TINY_DEVICE`` (64 KiB, whole budget,
#: (8, 128) granules) so plans can be compared one for one.
TINY_DEVICE = DeviceSpec(name="tiny", fast_bytes=64 * 1024,
                         budget_fraction=1.0, lane=128, sublane=8)

#: NVIDIA H100 SXM5 80 GB.  Capacity: the 227 KiB of shared memory a CTA may
#: opt in to.  Budget: 5/8 of it (145,280 B).  The binding program of this
#: slice is ``glu_program("silu")`` at d_ff = 11008 in float32: 3 live
#: values x 11008 x 4 B = 132,096 B for a single row, which needs a fraction
#: of at least 0.569; 5/8 is the next eighth above it.  ``sublane=1``: a
#: CUDA thread block has no row granule; ``lane=32``: one warp.  Rates are
#: datasheet figures for the SXM5 part at its 700 W limit (HBM3 3.35 TB/s,
#: 67 TFLOP/s float32 without tensor cores), not measurements.
#:
#: Training (``differentiable=True``) sizes against the joint forward +
#: backward working set, 6 live buffers for the glu: 6 x 11008 x 4 B =
#: 264,192 B for one row, above the 145,280 B budget and above the
#: 232,448 B a CTA can have at all.  The glu has no op that reduces over F,
#: so its backward walks F in chunks of ``f_chunk`` = 2048 features (the
#: rows analogue of the nhwc kernel's channel blocks) and the planner
#: counts the chunk: 6 x 2048 x 4 B = 49,152 B a row, 2 rows a tile.
H100 = DeviceSpec(name="h100_sxm", fast_bytes=232_448, budget_fraction=0.625,
                  lane=32, sublane=1, hbm_bandwidth=3.35e12,
                  peak_flops_f32=67e12, f_chunk=2048)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Working-set accounting (rows layout).
# ---------------------------------------------------------------------------

def rows_tile_bytes(n_values: int, rows: int, features: int,
                    itemsize: int, spec: DeviceSpec) -> int:
    """Bytes of fast memory needed to hold ``n_values`` live tile buffers."""
    f = round_up(max(features, 1), spec.lane)
    r = round_up(max(rows, 1), spec.sublane)
    return n_values * r * f * itemsize


def max_live_values(program: ir.StackProgram) -> int:
    """Peak number of simultaneously-live values when executing ``program``
    sequentially (inputs + intermediates with a consumer still pending)."""
    last_use: dict[str, int] = {}
    for i, op in enumerate(program.ops):
        for v in op.inputs:
            last_use[v] = i
    for v in program.outputs:
        last_use[v] = len(program.ops)
    live = set(program.inputs)
    peak = len(live)
    for i, op in enumerate(program.ops):
        live.add(op.output)
        peak = max(peak, len(live))
        live = {v for v in live if last_use.get(v, -1) > i}
    return max(peak, 1)


def max_live_values_bwd(program: ir.StackProgram) -> int:
    """Peak live tile buffers of the generated depth-first backward: every
    forward value (inputs and op outputs) stays live for the recompute, and
    on top of it the reverse sweep's cotangents, each born when its last
    consumer is transposed and dead once its producer is."""
    n_fwd = len(program.inputs) + len(program.ops)
    live: set[str] = set(program.outputs)
    peak = len(live)
    for op in reversed(program.ops):
        live.discard(op.output)
        live.update(op.inputs)
        peak = max(peak, len(live))
    return n_fwd + max(peak, 1)


def f_separable(program: ir.StackProgram) -> bool:
    """True when no op reduces over the trailing axis (no ``ROW_NORM`` /
    ``ROW_SOFTMAX``): every feature column is computed on its own, so the
    chain can run in feature chunks."""
    return not any(op.kind in (ir.OpKind.ROW_NORM, ir.OpKind.ROW_SOFTMAX)
                   for op in program.ops)


def feature_block(program: ir.StackProgram, features: int,
                  f_chunk: int) -> int:
    """Features of a row the rows backward kernel holds at a time: one
    ``f_chunk`` of an F-separable chain, else all of ``features``.  The
    planner (:func:`planned_features`) and the kernel both ask this."""
    if f_chunk and f_separable(program):
        return min(features, f_chunk)
    return features


def planned_features(program: ir.StackProgram, features: int,
                     spec: DeviceSpec, differentiable: bool) -> int:
    """The feature width a row tile is sized for: what the backward holds
    (:func:`feature_block` at ``spec.f_chunk``) when ``differentiable``,
    else the forward's whole row."""
    if differentiable:
        return feature_block(program, features, spec.f_chunk)
    return features


class ResourceError(RuntimeError):
    pass


def pick_row_tile(program: ir.StackProgram, features: int, itemsize: int,
                  spec: DeviceSpec, *, differentiable: bool = False) -> int:
    """The largest ``sublane * 2**k`` row tile (at most 4096 rows) whose
    live buffers fit the budget (paper: "if the cache size limit is not
    reached, we increase the size").  ``differentiable`` sizes against the
    joint forward + backward working set, so one geometry serves both
    kernels."""
    n_live = (max_live_values_bwd(program) if differentiable
              else max_live_values(program))
    features = planned_features(program, features, spec, differentiable)
    budget = spec.resource_limit
    rows = spec.sublane
    while True:
        nxt = rows * 2
        if rows_tile_bytes(n_live, nxt, features, itemsize, spec) > budget:
            break
        if nxt > 4096:                      # diminishing returns past this
            break
        rows = nxt
    if rows_tile_bytes(n_live, rows, features, itemsize, spec) > budget:
        raise ResourceError(
            f"{program.name}: even a {spec.sublane}-row tile "
            f"({rows_tile_bytes(n_live, spec.sublane, features, itemsize, spec)}B "
            f"for {n_live} buffers) exceeds budget {budget}B on {spec.name}")
    return rows


# ---------------------------------------------------------------------------
# nhwc (pooling) working set: receptive-field growth through stacked steps.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepFootprint:
    in_h: int
    in_w: int
    out_h: int
    out_w: int
    channels: int
    bytes_in: int
    bytes_out: int


def sequence_footprint(steps: list[tuple[ir.OpNode, ...]],
                       out_h: int, out_w: int, channels: int,
                       itemsize: int, spec: DeviceSpec) -> list[StepFootprint]:
    """Walk a candidate sequence of steps backwards from the output patch,
    growing the required input extent through every pooling op ("each
    block adds new padding, the value increases with each additional
    block")."""
    fps: list[StepFootprint] = []
    h, w = out_h, out_w
    c = round_up(channels, spec.lane)
    for step in reversed(steps):
        sh, sw = h, w
        for op in reversed(step):
            if op.kind == ir.OpKind.POOL2D:
                kh, kw = op.attrs["window"]
                st_h, st_w = op.attrs["stride"]
                sh = ir.pool_in_extent(sh, kh, st_h)
                sw = ir.pool_in_extent(sw, kw, st_w)
        fps.append(StepFootprint(
            in_h=sh, in_w=sw, out_h=h, out_w=w, channels=channels,
            bytes_in=sh * sw * c * itemsize,
            bytes_out=h * w * c * itemsize))
        h, w = sh, sw
    fps.reverse()
    return fps


def sequence_bytes(fps: list[StepFootprint]) -> int:
    """Peak fast memory of the double-buffered step chain: at any step
    boundary both the step's input and output buffer are resident."""
    return max(fp.bytes_in + fp.bytes_out for fp in fps)


def sequence_bwd_bytes(fps: list[StepFootprint]) -> int:
    """Joint forward + backward working set of the generated nhwc backward:
    the recompute keeps every level's buffer live through the reverse sweep,
    and the sweep holds the cotangent pair of the step it transposes."""
    recompute = sum(fp.bytes_in for fp in fps) + fps[-1].bytes_out
    cot_live = max(fp.bytes_in + fp.bytes_out for fp in fps)
    return recompute + cot_live


def fits(steps: list[tuple[ir.OpNode, ...]], out_h: int, out_w: int,
         channels: int, itemsize: int, spec: DeviceSpec,
         *, differentiable: bool = False) -> bool:
    fps = sequence_footprint(steps, out_h, out_w, channels, itemsize, spec)
    need = sequence_bwd_bytes(fps) if differentiable else sequence_bytes(fps)
    return need <= spec.resource_limit


def plan_vmem_bytes(plan, *, itemsize: int,
                    differentiable: bool = False) -> list[int]:
    """Every sequence's fast-memory working set, recomputed from a finished
    plan's committed tile geometry (the independent budget check).  ``plan``
    is duck-typed (``program``, ``sequences``, ``device``, ``input_shapes``,
    ``subprogram``): this module must not import the collapser."""
    program = plan.program
    device = plan.device
    in_shapes = {k: tuple(v) for k, v in plan.input_shapes}
    needs: list[int] = []
    if program.layout == "rows":
        features = max((in_shapes[v][-1] if v in in_shapes else 0)
                       for v in program.inputs)
        for i, seq in enumerate(plan.sequences):
            sub = plan.subprogram(i)
            n_live = (max_live_values_bwd(sub) if differentiable
                      else max_live_values(sub))
            tile = seq.tile_rows or 256
            f = planned_features(sub, features, device, differentiable)
            needs.append(rows_tile_bytes(n_live, tile, f, itemsize, device))
    else:
        shapes = ir.infer_shapes(program, in_shapes)
        for i, seq in enumerate(plan.sequences):
            sub = plan.subprogram(i)
            _, oh, ow, c = shapes[sub.outputs[0]]
            th = min(seq.tile_out_h or 8, oh)
            tw = min(seq.tile_out_w or 8, ow)
            fps = sequence_footprint([s.ops for s in seq.steps], th, tw, c,
                                     itemsize, device)
            needs.append(sequence_bwd_bytes(fps) if differentiable
                         else sequence_bytes(fps))
    return needs


# ---------------------------------------------------------------------------
# Schedule-level HBM-traffic model (the quantity depth-first execution
# reduces): main-memory reads/writes implied by each schedule.
# ---------------------------------------------------------------------------

def _nbytes(shape: tuple[int, ...], itemsize: int) -> int:
    n = itemsize
    for d in shape:
        n *= d
    return n


def breadth_first_traffic(program: ir.StackProgram,
                          input_shapes: Mapping[str, tuple[int, ...]],
                          itemsize: int) -> int:
    """Layer-by-layer execution: every op reads its inputs from and writes
    its output to main memory (the paper's framework baseline)."""
    shapes = ir.infer_shapes(program, input_shapes)
    total = 0
    for op in program.ops:
        for v in op.inputs:
            total += _nbytes(shapes[v], itemsize)
        total += _nbytes(shapes[op.output], itemsize)
    return total


def depth_first_traffic(plan, input_shapes: Mapping[str, tuple[int, ...]],
                        itemsize: int) -> int:
    """Collapsed execution: each sequence reads its external inputs once and
    writes its boundary outputs once.  For nhwc sequences the per-tile halo
    overlap of stacked pooling is charged as redundant reads."""
    program = plan.program
    shapes = ir.infer_shapes(program, input_shapes)
    total = 0
    for i, seq in enumerate(plan.sequences):
        sub = plan.subprogram(i)
        if seq.tile_out_h > 0:                       # nhwc: tiled with halo
            n, oh, ow, c = shapes[sub.outputs[0]]
            th = min(seq.tile_out_h, oh)
            tw = min(seq.tile_out_w, ow)
            nt = -(-oh // th) * (-(-ow // tw))
            fps = sequence_footprint([s.ops for s in seq.steps], th, tw, c,
                                     itemsize, plan.device)
            total += n * nt * fps[0].in_h * fps[0].in_w * c * itemsize
            total += _nbytes(shapes[sub.outputs[0]], itemsize)
        else:                                        # rows: exact one-pass
            for v in sub.inputs:
                total += _nbytes(shapes[v], itemsize)
            for v in sub.outputs:
                total += _nbytes(shapes[v], itemsize)
    return total
