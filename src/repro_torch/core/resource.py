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
    kernel bounds; 0 means "not a real device"."""

    name: str
    fast_bytes: int
    budget_fraction: float
    lane: int
    sublane: int
    hbm_bandwidth: float = 0.0
    peak_flops_f32: float = 0.0

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
H100 = DeviceSpec(name="h100_sxm", fast_bytes=232_448, budget_fraction=0.625,
                  lane=32, sublane=1, hbm_bandwidth=3.35e12,
                  peak_flops_f32=67e12)


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


class ResourceError(RuntimeError):
    pass


def pick_row_tile(program: ir.StackProgram, features: int, itemsize: int,
                  spec: DeviceSpec) -> int:
    """The largest ``sublane * 2**k`` row tile (at most 4096 rows) whose
    live buffers fit the budget (paper: "if the cache size limit is not
    reached, we increase the size")."""
    n_live = max_live_values(program)
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


def fits(steps: list[tuple[ir.OpNode, ...]], out_h: int, out_w: int,
         channels: int, itemsize: int, spec: DeviceSpec) -> bool:
    fps = sequence_footprint(steps, out_h, out_w, channels, itemsize, spec)
    return sequence_bytes(fps) <= spec.resource_limit


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
