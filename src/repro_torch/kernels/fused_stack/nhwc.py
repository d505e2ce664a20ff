"""Depth-first kernel for nhwc-layout stacks (pooling chains), in CUDA.

Replaces ``repro/kernels/fused_stack/nhwc.py:fused_nhwc_call`` (the Pallas
kernel).  It is the paper's own GPU kernel shape (Listing 2): one CTA stages
a halo-grown input patch in shared memory and pushes it through the whole
POOL2D / AFFINE / EW / ROW_NORM / ROW_SOFTMAX chain, writing one output
patch.  The source is ``csrc/fused_nhwc.cu``.

One build serves every stack: the chain is passed to the kernel as data (a
:class:`NhwcDesc` by value, ``__grid_constant__``): one descriptor per op
and the per-level geometry of :func:`_plan_levels`.  A sequence longer than
:data:`MAX_OPS` ops or :data:`MAX_LEVELS` levels raises
:class:`DescriptorError`.

Two kernels, one per kind of chain:

* **The fused path** (:func:`fused_chain`: AFFINE of the input, an
  element-wise unary op, then a POOL2D whose windows do not overlap, as in
  VGG's stages): ``fused_nhwc_kernel_fused``, persistent, with the work
  items of :func:`fused_plan` (8 x 8 output tiles of a block of up to
  :data:`CB_MIN` channels in float4s), the plan the backward's fused path
  takes too, and the grid of :func:`launch_programs` from the card.  Each
  thread holds four channels and a run of output positions; per position it
  loads its window straight from ``x`` (each input element read once),
  applies the affine, the unary op and the pool in registers and stores
  one float4.  No slots, no barriers.
* **Any other chain**: ``fused_nhwc_kernel``, one CTA per ``(tile_i *
  tile_j * channel block, n)`` of the planner's tile.  The chain is
  channel-independent unless it holds ``ROW_NORM``/``ROW_SOFTMAX`` (which,
  in nhwc, reduce over C): then the channel block is all of C.  The halo
  comes in through predicated loads from the unpadded input, with no padded
  copy; the output writes are guarded, with no grid-padded output array.

Bound: device-memory bytes.  Each input element is read once per tile that
covers it (more only by the halo overlap), each output element written
once; the chain itself runs out of shared memory or registers.

Semantics kept from the Pallas kernel (``run_tile``): each POOL2D masks its
own input level by that level's image extent, with a select (never a
multiply) to the pool's neutral element (``finfo(float32).min`` for max, 0
for avg); avg divides by ``kh*kw``; level origins are ``tile * th * mul -
off``, which equals the ``(o + p) // s`` propagation.
"""
from __future__ import annotations

import ctypes
import dataclasses
from collections import OrderedDict
from pathlib import Path
from typing import Mapping

import torch

from repro_torch.core import ir
from repro_torch.kernels import _build
from repro_torch.kernels.fused_stack import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_nhwc.cu"

#: Limits compiled into ``csrc/fused_nhwc.cu`` (keep in step with it).
MAX_OPS = 32
MAX_LEVELS = 16
MAX_VECS = 24
MAX_SLOTS = 8
#: Threads a CTA (``THREADS`` of ``csrc/fused_nhwc.cuh``).
THREADS = 256
#: Channels an item of the persistent kernels carries on a chain that does
#: not reduce over C: this many (256 contiguous bytes a position), or all
#: of C below it, rounded up to a float4.
CB_MIN = 64
#: Window positions the fused paths hold in registers (``FUSED_WIN`` of
#: ``csrc/fused_nhwc.cuh``), and the output positions they aim at an item
#: (8 x 8).
FUSED_WIN = 4
FUSED_SIDE = 8
#: Shared memory a CTA of a channel-independent chain aims to stay under
#: (several CTAs per SM); a chain that reduces over C may use up to
#: SMEM_MAX, the per-CTA opt-in limit of sm_90.
SMEM_TARGET = 48 * 1024
SMEM_MAX = 232_448

# op kinds and operand sources, as numbered in csrc/fused_nhwc.cu
K_UNARY, K_BINARY, K_AFFINE, K_POOL, K_NORM, K_SOFTMAX = range(6)
SRC_SLOT, SRC_VEC = 0, 1
UNARY_IDS = {name: i for i, name in enumerate((
    "relu", "relu6", "squared_relu", "gelu", "gelu_exact", "silu", "sigmoid",
    "tanh", "exp", "abs", "square", "identity", "neg", "softplus"))}
BINARY_IDS = {name: i for i, name in enumerate((
    "add", "sub", "mul", "div", "max", "min"))}
POOL_IDS = {"max": 0, "avg": 1}
NORM_IDS = {"rms": 0, "layer": 1}


class DescriptorError(ValueError):
    """The sequence does not fit the kernel's descriptor."""


# ---------------------------------------------------------------------------
# Geometry (ported from repro/kernels/fused_stack/nhwc.py).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Level:
    """Static spatial geometry of one value level inside the sequence."""
    extent_h: int            # tile extent at this level
    extent_w: int
    image_h: int             # full (unpadded) image extent at this level
    image_w: int
    # origin of the tile at this level = out_patch_origin * prod(strides) - off
    mul_h: int
    off_h: int
    mul_w: int
    off_w: int


def _plan_levels(ops: tuple[ir.OpNode, ...], out_h: int, out_w: int,
                 image_hw: list[tuple[int, int]]) -> list[_Level]:
    """Walk backwards from the output patch to compute, per op, the tile
    extent and origin transform of its *input* level.  Per-level image
    extents come from forward shape inference (``image_hw``, one entry per
    value level): reconstructing them backwards would under-count whenever a
    stride does not tile the image, which mis-masks real border columns."""
    levels: list[_Level] = []
    eh, ew = out_h, out_w
    mul_h = mul_w = 1
    off_h = off_w = 0
    ih, iw = image_hw[len(ops)]
    levels.append(_Level(eh, ew, ih, iw, mul_h, off_h, mul_w, off_w))
    for i, op in enumerate(reversed(ops)):
        if op.kind == ir.OpKind.POOL2D:
            kh, kw = op.attrs["window"]
            sh, sw = op.attrs["stride"]
            ph, pw = op.attrs["padding"]
            eh = ir.pool_in_extent(eh, kh, sh)
            ew = ir.pool_in_extent(ew, kw, sw)
            off_h = off_h * sh + ph
            off_w = off_w * sw + pw
            mul_h *= sh
            mul_w *= sw
        ih, iw = image_hw[len(ops) - 1 - i]
        levels.append(_Level(eh, ew, ih, iw, mul_h, off_h, mul_w, off_w))
    levels.reverse()           # levels[i] = input level of ops[i]
    return levels


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Tile geometry of one nhwc sequence on one input shape."""
    levels: tuple[_Level, ...]      # levels[i] = input level of ops[i]
    grid: tuple[int, int, int]      # (n, tiles_h, tiles_w)
    out_hw: tuple[int, int]         # (oh, ow)
    grid_pad: tuple[int, int]       # rows/cols the last tile reaches past out
    tile: tuple[int, int]           # (th, tw), clamped to the output


def plan_geometry(program: ir.StackProgram, x_shape: tuple[int, ...],
                  extra_shapes: Mapping[str, tuple[int, ...]],
                  tile_out_h: int, tile_out_w: int) -> Geometry:
    """Levels, grid and clamped tile extents of ``program`` on an input of
    ``x_shape`` (the JAX kernel's ``plan_geometry`` without the pre-padded
    copy: this kernel loads its halo with predicated reads)."""
    n, h, w, _ = x_shape
    in_shapes = {program.inputs[0]: tuple(x_shape)}
    in_shapes.update({k: tuple(v) for k, v in extra_shapes.items()})
    shapes = ir.infer_shapes(program, in_shapes)
    _, oh, ow, _ = shapes[program.outputs[0]]
    th = min(tile_out_h, oh)
    tw = min(tile_out_w, ow)
    pad_oh = (-oh) % th
    pad_ow = (-ow) % tw
    grid = (n, (oh + pad_oh) // th, (ow + pad_ow) // tw)
    image_hw = [(h, w)]
    for op in program.ops:
        s_ = shapes[op.output]
        image_hw.append((s_[1], s_[2]))
    levels = _plan_levels(program.ops, th, tw, image_hw)
    return Geometry(levels=tuple(levels), grid=grid, out_hw=(oh, ow),
                    grid_pad=(pad_oh, pad_ow), tile=(th, tw))


def tile_valid(shape_hw: tuple[int, int], origin: tuple[int, int],
               level: _Level) -> torch.Tensor:
    """``(h, w, 1)`` bool mask: which positions of a tile with global
    ``origin`` lie inside the true (unpadded) image at ``level``.  The CUDA
    kernel evaluates the same predicate per element in its pool pass."""
    rh = origin[0] + torch.arange(shape_hw[0]).view(-1, 1)
    rw = origin[1] + torch.arange(shape_hw[1]).view(1, -1)
    return ((rh >= 0) & (rh < level.image_h)
            & (rw >= 0) & (rw < level.image_w))[..., None]


def pool_neutral(dtype: torch.dtype, fn: str) -> float:
    """The pool's padding value (``repro/core/autodiff.py:pool_neutral``):
    what an out-of-image position holds so the windowed reduction
    reproduces the layer's own padding."""
    if fn == "max":
        return (torch.finfo(dtype).min if dtype.is_floating_point
                else torch.iinfo(dtype).min)
    return 0.0


# ---------------------------------------------------------------------------
# The descriptor: the chain as data (mirrors the structs in the .cu file).
# ---------------------------------------------------------------------------

class OpDesc(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in (
        "kind", "fn", "out", "a_src", "a_idx", "b_src", "b_idx", "c_idx",
        "kh", "kw", "sh", "sw", "norm")] + [("eps", ctypes.c_float)]


class LevelDesc(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in (
        "eh", "ew", "ih", "iw", "mul_h", "off_h", "mul_w", "off_w")]


class NhwcDesc(ctypes.Structure):
    _fields_ = ([("vecs", ctypes.c_void_p * MAX_VECS),
                 ("vec_stride", ctypes.c_int * MAX_VECS)]
                + [(f, ctypes.c_int) for f in (
                    "n_ops", "n_levels", "n_slots", "in_slot", "out_slot",
                    "N", "H", "W", "C", "OH", "OW", "th", "tw", "tiles_h",
                    "tiles_w", "cb", "n_cb", "slot_elems", "rowred")]
                + [("levels", LevelDesc * MAX_LEVELS),
                   ("ops", OpDesc * MAX_OPS)])


@dataclasses.dataclass(frozen=True)
class Chain:
    """The chain compiled to descriptor rows: shape-free, one per program.

    ``ops`` are ``OpDesc`` field dicts; ``vec_names`` the extras then the
    params, in the order of the descriptor's vector table."""
    ops: tuple[dict, ...]
    vec_names: tuple[str, ...]
    n_slots: int
    in_slot: int
    out_slot: int
    n_pools: int
    rowred: bool


def compile_chain(program: ir.StackProgram, *, keep_values: bool = False,
                  max_slots: int = MAX_SLOTS) -> Chain:
    """Assign every value a shared-memory slot and every operand a source.

    Values are planned on the linear level model of the Pallas kernel: the
    chain is at level ``l`` after ``l`` pools, every spatial operand of an
    op must live at the current level, and the output at the last one.
    A slot is freed after its value's last read; element-wise and row ops
    may write over an operand that dies with them, a pool never does.
    ``keep_values`` (the backward's recompute) gives every value a slot of
    its own for the whole chain, with up to ``max_slots`` slots."""
    if len(program.outputs) != 1:
        raise DescriptorError(f"{program.name}: the nhwc kernel writes one "
                              f"output, got {program.outputs}")
    if len(program.ops) > MAX_OPS:
        raise DescriptorError(f"{program.name}: {len(program.ops)} ops exceed "
                              f"MAX_OPS={MAX_OPS}")
    extras = program.inputs[1:]
    vec_names = list(extras) + list(program.param_names)
    if len(vec_names) > MAX_VECS:
        raise DescriptorError(f"{program.name}: {len(vec_names)} vectors "
                              f"exceed MAX_VECS={MAX_VECS}")
    vec_of = {name: i for i, name in enumerate(vec_names)}
    last_use: dict[str, int] = {}
    for i, op in enumerate(program.ops):
        for v in op.inputs:
            last_use[v] = i
    out_name = program.outputs[0]
    last_use[out_name] = len(program.ops)

    slot_of: dict[str, int] = {program.inputs[0]: 0}
    level_of: dict[str, int] = {program.inputs[0]: 0}
    busy = {0}
    n_slots = 1
    level = 0
    rows: list[dict] = []

    def operand(v: str) -> tuple[int, int]:
        if v in vec_of and v not in slot_of:
            return SRC_VEC, vec_of[v]
        if level_of[v] != level:
            raise DescriptorError(
                f"{program.name}: value {v!r} from level {level_of[v]} read "
                f"at level {level}; the kernel runs a linear pooling chain")
        return SRC_SLOT, slot_of[v]

    def release(i: int, op: ir.OpNode) -> None:
        if keep_values:
            return
        for v in set(op.inputs):
            if v in slot_of and last_use.get(v, -1) <= i:
                busy.discard(slot_of[v])

    def allocate() -> int:
        nonlocal n_slots
        s = next(k for k in range(max_slots + 1) if k not in busy)
        if s >= max_slots:
            raise DescriptorError(f"{program.name}: more than "
                                  f"{max_slots} live values")
        busy.add(s)
        n_slots = max(n_slots, s + 1)
        return s

    for i, op in enumerate(program.ops):
        row = dict(kind=0, fn=0, out=0, a_src=0, a_idx=0, b_src=0, b_idx=-1,
                   c_idx=-1, kh=0, kw=0, sh=0, sw=0, norm=0, eps=0.0)
        # an op may read broadcast operands only (``t = e * e``): its slot
        # then holds the broadcast value at every position of the level
        srcs = [operand(v) for v in op.inputs]
        row["a_src"], row["a_idx"] = srcs[0]
        pvecs = [vec_of[p] for p in op.params]
        if op.kind == ir.OpKind.EW_UNARY:
            row.update(kind=K_UNARY, fn=UNARY_IDS[op.fn])
        elif op.kind == ir.OpKind.EW_BINARY:
            b_src, b_idx = (SRC_VEC, pvecs[0]) if pvecs else srcs[1]
            row.update(kind=K_BINARY, fn=BINARY_IDS[op.fn], b_src=b_src,
                       b_idx=b_idx)
        elif op.kind == ir.OpKind.AFFINE:
            row.update(kind=K_AFFINE, b_src=SRC_VEC, b_idx=pvecs[0],
                       c_idx=pvecs[1])
        elif op.kind in (ir.OpKind.ROW_NORM, ir.OpKind.ROW_SOFTMAX):
            if op.kind == ir.OpKind.ROW_SOFTMAX:
                row.update(kind=K_SOFTMAX)
            else:
                row.update(kind=K_NORM,
                           norm=NORM_IDS[op.attrs.get("norm", "rms")],
                           eps=float(op.attrs.get("eps", 1e-6)))
                row["b_idx"] = pvecs[0] if pvecs else -1
                row["c_idx"] = pvecs[1] if len(pvecs) > 1 else -1
            if row["a_src"] != SRC_SLOT:
                raise DescriptorError(f"{program.name}: op {op.name!r} "
                                      f"reduces a broadcast operand")
        elif op.kind == ir.OpKind.POOL2D:
            if row["a_src"] != SRC_SLOT:
                raise DescriptorError(f"{program.name}: op {op.name!r} pools "
                                      f"a broadcast operand")
            (kh, kw), (sh, sw) = op.attrs["window"], op.attrs["stride"]
            row.update(kind=K_POOL, fn=POOL_IDS[op.fn], kh=kh, kw=kw, sh=sh,
                       sw=sw)
        else:
            raise DescriptorError(f"{program.name}: op kind {op.kind} is not "
                                  f"an nhwc stack op")
        if op.kind == ir.OpKind.POOL2D:
            row["out"] = allocate()       # a pool reads neighbours: no aliasing
            release(i, op)
            level += 1
        else:
            release(i, op)
            row["out"] = allocate()
        slot_of[op.output] = row["out"]
        level_of[op.output] = level
        if last_use.get(op.output, -1) <= i and not keep_values:
            busy.discard(row["out"])      # never read: free at once
        rows.append(row)

    if level_of[out_name] != level:
        raise DescriptorError(f"{program.name}: output {out_name!r} is not at "
                              f"the last level")
    if level + 1 > MAX_LEVELS:
        raise DescriptorError(f"{program.name}: {level} pools exceed "
                              f"MAX_LEVELS={MAX_LEVELS}")
    return Chain(ops=tuple(rows), vec_names=tuple(vec_names), n_slots=n_slots,
                 in_slot=0, out_slot=slot_of[out_name], n_pools=level,
                 rowred=any(r["kind"] in (K_NORM, K_SOFTMAX) for r in rows))


def fused_chain(program: ir.StackProgram) -> bool:
    """Whether ``program`` takes the kernels' fused path, forward and
    backward: AFFINE of the input, then an element-wise unary op, then a
    POOL2D whose windows do not overlap (window == stride) and hold at most
    :data:`FUSED_WIN` positions (batch norm, an activation and VGG's 2x2/s2
    max pool), nothing else."""
    ops = program.ops
    if len(ops) != 3 or len(program.inputs) != 1:
        return False
    aff, un, pool = ops
    if (aff.kind != ir.OpKind.AFFINE or aff.inputs != program.inputs[:1]
            or un.kind != ir.OpKind.EW_UNARY or un.inputs != (aff.output,)
            or pool.kind != ir.OpKind.POOL2D or pool.inputs != (un.output,)
            or program.outputs != (pool.output,)):
        return False
    (kh, kw), (sh, sw) = pool.attrs["window"], pool.attrs["stride"]
    return (kh, kw) == (sh, sw) and kh * kw <= FUSED_WIN


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """The fused path's work items on one call shape: ``tile`` output
    positions (``level0`` input positions) by ``cb`` channels; ``tiles``
    per image, ``spatial`` = N x tiles items a channel block, ``n_cb``
    blocks; ``lanes`` position lanes of ``cb // 4`` channel quads."""
    tile: tuple[int, int]
    level0: tuple[int, int]
    tiles: tuple[int, int]
    spatial: int
    cb: int
    n_cb: int
    lanes: int

    @property
    def items(self) -> int:
        return self.spatial * self.n_cb


def _even(extent: int, side: int) -> int:
    """``side`` evened out over the tiles it takes to cover ``extent``."""
    return -(-extent // -(-extent // side))


def fused_plan(program: ir.StackProgram, x_shape: tuple[int, ...],
               extra_shapes: tuple[tuple[str, tuple[int, ...]], ...] = ()
               ) -> FusedPlan:
    """Items of a :func:`fused_chain` program, forward and backward: 8 x 8
    output tiles (:data:`FUSED_SIDE`, evened out over the output) of a
    channel block of ``min(C, CB_MIN)`` channels rounded up to a float4."""
    shapes = ir.infer_shapes(program, {program.inputs[0]: tuple(x_shape),
                                       **dict(extra_shapes)})
    _, oh, ow, _ = shapes[program.outputs[0]]
    geo = plan_geometry(program, x_shape, dict(extra_shapes),
                        _even(oh, FUSED_SIDE), _even(ow, FUSED_SIDE))
    n_img, c = x_shape[0], x_shape[-1]
    cb = min(-(-c // 4) * 4, CB_MIN)
    L = geo.levels[0]
    return FusedPlan(geo.tile, (L.extent_h, L.extent_w), geo.grid[1:],
                     n_img * geo.grid[1] * geo.grid[2], cb, -(-c // cb),
                     THREADS // (cb // 4))


def launch_programs(plan_spatial: int, n_cb: int, sm_count: int,
                    ctas_per_sm: int) -> int:
    """The persistent grid: a multiple of ``n_cb`` (CTA ``p`` keeps channel
    block ``p % n_cb``), as many as fit the card at once, at most one per
    item."""
    per_block = max(1, min(plan_spatial,
                           max(sm_count, 1) * max(ctas_per_sm, 1) // n_cb))
    return n_cb * per_block


def channel_block(n_slots: int, rowred: bool, level0_elems: int,
                  channels: int) -> int:
    """Channels one CTA carries: all of C when the chain reduces over C,
    else the largest power of two (or C itself) whose slots stay under
    :data:`SMEM_TARGET`, growing past it up to :data:`SMEM_MAX` only when a
    single channel does not fit."""
    per_channel = n_slots * level0_elems * 4
    if rowred or per_channel * channels <= SMEM_TARGET:
        cb = channels
    else:
        cb = 1
        while cb * 2 <= channels and per_channel * cb * 2 <= SMEM_TARGET:
            cb *= 2
    if per_channel * cb > SMEM_MAX:
        raise DescriptorError(
            f"{per_channel * cb} B of shared memory for {n_slots} slots of "
            f"{level0_elems} positions x {cb} channels exceed {SMEM_MAX} B")
    return cb


#: Descriptors by call shape, without their vector pointers (LRU).
_TEMPLATES: "OrderedDict[tuple, tuple[Chain, bytes]]" = OrderedDict()
_TEMPLATE_LIMIT = 256


def _template(program: ir.StackProgram, x_shape: tuple[int, ...],
              extra_shapes: tuple[tuple[str, tuple[int, ...]], ...],
              vec_strides: tuple[int, ...],
              tile_out_h: int, tile_out_w: int) -> tuple[Chain, bytes]:
    """The chain and the descriptor of one call shape, without its vector
    pointers; cached on the program's structural signature."""
    key = (program.signature(), x_shape, extra_shapes, vec_strides,
           tile_out_h, tile_out_w)
    hit = _TEMPLATES.get(key)
    if hit is not None:
        _TEMPLATES.move_to_end(key)
        return hit
    chain = compile_chain(program)
    if fused_chain(program):        # the plan's items; no slots
        plan = fused_plan(program, x_shape, extra_shapes)
        d = build_desc(program, chain, x_shape, extra_shapes, vec_strides,
                       *plan.tile, cb=plan.cb)
        d.n_slots = 0
    else:
        d = build_desc(program, chain, x_shape, extra_shapes, vec_strides,
                       tile_out_h, tile_out_w)
    hit = _TEMPLATES[key] = (chain, bytes(d))
    while len(_TEMPLATES) > _TEMPLATE_LIMIT:
        _TEMPLATES.popitem(last=False)
    return hit


def build_desc(program: ir.StackProgram, chain: Chain,
               x_shape: tuple[int, ...],
               extra_shapes: tuple[tuple[str, tuple[int, ...]], ...],
               vec_strides: tuple[int, ...], tile_out_h: int,
               tile_out_w: int, cb: int | None = None) -> NhwcDesc:
    """The descriptor of ``chain`` on one call shape, without its vector
    pointers.  ``cb``: the channel block (the backward's launch plan sets
    it); by default :func:`channel_block`'s."""
    geo = plan_geometry(program, x_shape, dict(extra_shapes), tile_out_h,
                        tile_out_w)
    # geometry levels are per op; the kernel wants one per pool boundary
    lv = [geo.levels[0]] + [geo.levels[i + 1]
                            for i, op in enumerate(program.ops)
                            if op.kind == ir.OpKind.POOL2D]
    n, h, w, c = x_shape
    (oh, ow), (th, tw) = geo.out_hw, geo.tile
    e0 = lv[0].extent_h * lv[0].extent_w
    if cb is None:
        cb = channel_block(chain.n_slots, chain.rowred, e0, c)
    d = NhwcDesc()
    for i, s in enumerate(vec_strides):
        d.vec_stride[i] = s
    for k, v in dict(n_ops=len(chain.ops), n_levels=len(lv),
                     n_slots=chain.n_slots, in_slot=chain.in_slot,
                     out_slot=chain.out_slot, N=n, H=h, W=w, C=c, OH=oh,
                     OW=ow, th=th, tw=tw, tiles_h=geo.grid[1],
                     tiles_w=geo.grid[2], cb=cb, n_cb=-(-c // cb),
                     slot_elems=e0 * cb, rowred=int(chain.rowred)).items():
        setattr(d, k, v)
    for i, L in enumerate(lv):
        d.levels[i] = LevelDesc(L.extent_h, L.extent_w, L.image_h, L.image_w,
                                L.mul_h, L.off_h, L.mul_w, L.off_w)
    for i, row in enumerate(chain.ops):
        d.ops[i] = OpDesc(**row)
    return d


def _vec_operand(name: str, v: torch.Tensor, channels: int) -> torch.Tensor:
    """A per-channel operand as a flat float32 vector of C or 1 values."""
    flat = v.reshape(-1)
    if flat.numel() not in (1, channels) or (v.dim() and v.shape[-1]
                                             not in (1, channels)):
        raise ValueError(f"operand {name!r} of shape {tuple(v.shape)} is not "
                         f"a broadcast over {channels} channels")
    return flat.contiguous()


def fused_nhwc(program: ir.StackProgram, x: torch.Tensor,
               params: Mapping[str, torch.Tensor], *,
               extras: Mapping[str, torch.Tensor] | None = None,
               tile_out_h: int = 8, tile_out_w: int = 8) -> torch.Tensor:
    """Run an nhwc sequence as one fused CUDA kernel launch.

    ``x`` is the spatial input (``program.inputs[0]``, ``(N, H, W, C)``
    float32); ``extras`` maps the remaining program inputs to broadcast side
    operands (every non-channel dim 1).  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises.  A
    :func:`fused_chain` program takes the fused path with
    :func:`fused_plan`'s items (the planner's tile is not read), any other
    the descriptor walk on ``tile_out_h`` x ``tile_out_w`` tiles."""
    extras = dict(extras or {})
    missing = [v for v in program.inputs[1:] if v not in extras]
    if missing:
        raise ValueError(f"{program.name}: missing extra inputs {missing}")
    if x.device.type == "cpu":
        env = {program.inputs[0]: x, **extras}
        return ref.fused_stack_ref(program, env, params)[program.outputs[0]]
    if not x.is_cuda:
        raise ValueError(f"fused_nhwc takes a cpu or cuda tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 4:
        raise TypeError(f"fused_nhwc takes a 4-d float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    c = x.shape[-1]
    vecs = []
    for name in list(program.inputs[1:]) + list(program.param_names):
        v = extras[name] if name in extras else params[name]
        if v.device != x.device or v.dtype != torch.float32:
            raise TypeError(f"operand {name!r} must be float32 on {x.device}, "
                            f"got {v.dtype} on {v.device}")
        vecs.append(_vec_operand(name, v, c))
    strides = tuple(int(v.numel() != 1) for v in vecs)
    _, blob = _template(program, tuple(x.shape),
                        tuple(sorted((k, tuple(v.shape))
                                     for k, v in extras.items())),
                        strides, tile_out_h, tile_out_w)
    desc = NhwcDesc.from_buffer_copy(blob)
    for i, v in enumerate(vecs):
        desc.vecs[i] = v.data_ptr()
    out = torch.empty((x.shape[0], desc.OH, desc.OW, c), device=x.device,
                      dtype=x.dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if fused_chain(program):
            vec4 = int(c % 4 == 0 and x.data_ptr() % 16 == 0
                       and out.data_ptr() % 16 == 0)
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            programs = launch_programs(desc.N * desc.tiles_h * desc.tiles_w,
                                       desc.n_cb, sms, fused_ctas_per_sm())
            err = lib.fused_nhwc_fused_launch(
                ctypes.byref(desc), programs, x.data_ptr(), out.data_ptr(),
                vec4, stream)
        else:
            err = lib.fused_nhwc_launch(ctypes.byref(desc), x.data_ptr(),
                                        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_nhwc launch failed: CUDA error {err} "
                           f"({lib.fused_nhwc_error(err).decode()})")
    fused_nhwc.launches += 1
    return out


fused_nhwc.launches = 0


def fused_ctas_per_sm() -> int:
    """CTAs of ``fused_nhwc_kernel_fused`` one SM of the current device
    holds at once (the occupancy API's)."""
    key = torch.cuda.current_device()
    hit = _FUSED_CTAS_PER_SM.get(key)
    if hit is None:
        lib = _library()
        hit = lib.fused_nhwc_fused_ctas_per_sm()
        if hit <= 0:
            raise RuntimeError(f"fused_nhwc: no fused CTA fits an SM "
                               f"({lib.fused_nhwc_error(-hit).decode()})")
        _FUSED_CTAS_PER_SM[key] = hit
    return hit


_FUSED_CTAS_PER_SM: dict[int, int] = {}


def _library() -> ctypes.CDLL:
    lib = _build.load_library(SOURCE)
    if not getattr(lib, "_bound", False):
        lib.fused_nhwc_launch.argtypes = [ctypes.POINTER(NhwcDesc),
                                          ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p]
        lib.fused_nhwc_launch.restype = ctypes.c_int
        lib.fused_nhwc_fused_launch.argtypes = [
            ctypes.POINTER(NhwcDesc), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.fused_nhwc_fused_launch.restype = ctypes.c_int
        lib.fused_nhwc_fused_ctas_per_sm.argtypes = []
        lib.fused_nhwc_fused_ctas_per_sm.restype = ctypes.c_int
        lib.fused_nhwc_desc_size.argtypes = []
        lib.fused_nhwc_desc_size.restype = ctypes.c_int
        lib.fused_nhwc_error.argtypes = [ctypes.c_int]
        lib.fused_nhwc_error.restype = ctypes.c_char_p
        size = lib.fused_nhwc_desc_size()
        if size != ctypes.sizeof(NhwcDesc):
            raise RuntimeError(f"NhwcDesc is {ctypes.sizeof(NhwcDesc)} B in "
                               f"Python but {size} B in {SOURCE.name}")
        lib._bound = True
    return lib
