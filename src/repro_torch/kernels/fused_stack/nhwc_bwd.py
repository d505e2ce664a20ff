"""Depth-first backward of nhwc-layout stacks (pooling chains), in CUDA.

Replaces ``repro/kernels/fused_stack/nhwc_bwd.py:fused_nhwc_bwd_call`` (the
Pallas kernel).  The source is ``csrc/fused_nhwc_bwd.cu``; it recomputes
each work item with the forward's op semantics (``csrc/fused_nhwc.cuh``)
and walks the forward's descriptor (:class:`~.nhwc.NhwcDesc`) in reverse.

Host side (:func:`compile_bwd_chain`): the forward chain compiled with every
value in a slot of its own (the reverse sweep reads them back), plus the
cotangent slots of a liveness scan over the reversed chain (a value's
cotangent is born at its last consumer and dies once its producer is
transposed), plus one scratch slot when a norm has a scale.  The limit is
:data:`BWD_MAX_SLOTS`.

The work item comes from :func:`launch_plan` (the chain, the shape and the
card), not from the planner's tile: a channel block of at least
:data:`CB_MIN` channels in float4s (all of C when the chain reduces over
C), and, where tiles' input regions do not overlap (the direct write), the
tile whose items cost least under :data:`SMEM_BWD` (two CTAs an SM); where
they overlap, the planner's tile (smaller where it does not fit).  A chain
that :func:`~.nhwc.fused_chain` accepts (batch norm, an activation, a pool
whose windows do not overlap: VGG's stages) runs the kernel's fused path,
every output position in registers, on the items of
:func:`~.nhwc.fused_plan`, as the forward's fused path does.  The grid is
persistent: each CTA keeps one channel block (so its threads keep their
channels) and walks spatial items; per-CTA parameter and broadcast-extra
partials are summed by a second kernel in a fixed order.  The input
cotangent goes straight to ``dx`` where tiles' halos do not overlap, else
through private halo patches and a gather overlap-add.  No float atomics:
two runs give equal bits.

Bound: device-memory bytes: ``x`` and ``g`` read once, ``dx`` written once.
The patch path moves about twice that for ``dx``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from collections import OrderedDict
from pathlib import Path
from typing import Mapping

import torch

from repro_torch.core import autodiff, ir
from repro_torch.kernels import _build
from repro_torch.kernels.fused_stack import nhwc

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_nhwc_bwd.cu"

#: Shared-memory slots of one backward CTA: values, cotangents, scratch.
BWD_MAX_SLOTS = 32
#: Threads a CTA (``THREADS`` of ``csrc/fused_nhwc.cuh``).
THREADS = nhwc.THREADS
#: Shared memory a backward CTA aims to stay under, so that two fit an SM
#: of the H100 (228 KB an SM, 1 KB of it reserved a CTA).
SMEM_BWD = 113 * 1024
#: Channels an item carries on a chain that does not reduce over C: this
#: many (256 contiguous bytes a position), or all of C below it.
CB_MIN = nhwc.CB_MIN
#: Tile sides the plan weighs on the direct path, besides the output's own.
TILE_SIDES = (1, 2, 4, 8, 16, 32)
#: An item's fixed cost (its barriers, decode, interior test), in
#: level-0 positions' worth of work.
ITEM_COST = 16


class BwdOpDesc(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in (
        "g", "da", "db", "da_acc", "db_acc", "same", "level")]


class NhwcBwdDesc(ctypes.Structure):
    _fields_ = ([("f", nhwc.NhwcDesc), ("bops", BwdOpDesc * nhwc.MAX_OPS)]
                + [(f, ctypes.c_int) for f in (
                    "g_slot", "dx_slot", "scratch", "n_vecs", "work",
                    "patches", "lanes", "spatial", "vec4", "fused")])


#: The CTA's shared-memory copy of the descriptor, 16-byte aligned.
_DESC_BYTES = -(-ctypes.sizeof(NhwcBwdDesc) // 16) * 16


@dataclasses.dataclass(frozen=True)
class BwdChain:
    """The backward's slot plan: ``chain`` is the forward chain with every
    value kept and ``n_slots`` counting the cotangent and scratch slots;
    ``bops`` are ``BwdOpDesc`` field dicts, one per op."""
    chain: nhwc.Chain
    bops: tuple[dict, ...]
    g_slot: int
    dx_slot: int
    scratch: int


#: Backward slot plans by structural signature (LRU): the executable plans
#: its chain when it is built, and every call shape's descriptor reuses it.
_CHAINS: "OrderedDict[tuple, BwdChain]" = OrderedDict()
_CHAIN_LIMIT = 256


def compile_bwd_chain(program: ir.StackProgram) -> BwdChain:
    """Slots of the reverse sweep over ``program`` (see the module doc);
    raises ``nhwc.DescriptorError`` when they exceed :data:`BWD_MAX_SLOTS`."""
    key = program.signature()
    hit = _CHAINS.get(key)
    if hit is None:
        hit = _CHAINS[key] = _plan_bwd_chain(program)
    _CHAINS.move_to_end(key)
    while len(_CHAINS) > _CHAIN_LIMIT:
        _CHAINS.popitem(last=False)
    return hit


def _plan_bwd_chain(program: ir.StackProgram) -> BwdChain:
    fwd = nhwc.compile_chain(program, keep_values=True,
                             max_slots=BWD_MAX_SLOTS)
    top = fwd.n_slots
    free: set[int] = set()

    def alloc() -> int:
        nonlocal top
        if free:
            s = min(free)
            free.discard(s)
            return s
        top += 1
        return top - 1

    levels, lvl = [], 0
    for op in program.ops:
        levels.append(lvl)
        lvl += op.kind == ir.OpKind.POOL2D
    out = program.outputs[0]
    cot = {out: alloc()}
    g_slot = cot[out]
    written = {out}

    def target(v: str, src: int) -> tuple[int, int]:
        if src == nhwc.SRC_VEC:
            return -1, 0
        if v not in cot:
            cot[v] = alloc()
        acc = int(v in written)
        written.add(v)
        return cot[v], acc

    bops: list[dict] = [{}] * len(program.ops)
    for k in reversed(range(len(program.ops))):
        op, row = program.ops[k], fwd.ops[k]
        bo = dict(g=-1, da=-1, db=-1, da_acc=0, db_acc=0, same=0,
                  level=levels[k])
        if op.output in cot:
            bo["g"] = cot[op.output]
            bo["da"], bo["da_acc"] = target(op.inputs[0], row["a_src"])
            if op.kind == ir.OpKind.EW_BINARY and not op.params:
                if op.inputs[1] == op.inputs[0]:
                    bo["same"] = 1
                else:
                    bo["db"], bo["db_acc"] = target(op.inputs[1],
                                                    row["b_src"])
            free.add(cot.pop(op.output))
        bops[k] = bo
    scratch = -1
    if any(r["kind"] == nhwc.K_NORM and r["b_idx"] >= 0 for r in fwd.ops):
        scratch, top = top, top + 1          # a slot no cotangent shares
    if top > BWD_MAX_SLOTS:
        raise nhwc.DescriptorError(f"{program.name}: the backward needs {top}"
                                   f" slots, more than {BWD_MAX_SLOTS}")
    return BwdChain(chain=dataclasses.replace(fwd, n_slots=top),
                    bops=tuple(bops), g_slot=g_slot,
                    dx_slot=cot.get(program.inputs[0], -1), scratch=scratch)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """One call shape's work items: ``tile`` output positions (``level0``
    input positions) by ``cb`` channels; ``tiles`` per image, ``spatial``
    = N x tiles items a channel block; ``lanes`` position lanes of
    ``cb // 4`` channel quads; ``smem`` bytes a CTA."""
    tile: tuple[int, int]
    level0: tuple[int, int]
    tiles: tuple[int, int]
    spatial: int
    cb: int
    n_cb: int
    lanes: int
    smem: int
    patches: bool
    fused: bool = False

    @property
    def items(self) -> int:
        return self.spatial * self.n_cb


def desc_smem(b: NhwcBwdDesc) -> int:
    """Shared-memory bytes of a CTA with descriptor ``b`` (as the kernel's
    ``bwd_smem``)."""
    f = b.f
    return _smem(f.n_slots, b.n_vecs, f.slot_elems // f.cb, f.cb)


def _smem(n_slots: int, n_vecs: int, e0: int, cb: int) -> int:
    """Bytes a CTA: the descriptor's copy, the slots, the per-lane gradient
    partials and the vector operands at the CTA's channel block."""
    return _DESC_BYTES + 4 * (n_slots * e0 * cb
                              + (THREADS // (cb // 4) + 1) * n_vecs * cb)


def launch_plan(program: ir.StackProgram, x_shape: tuple[int, ...],
                extra_shapes: tuple[tuple[str, tuple[int, ...]], ...],
                tile_out_h: int, tile_out_w: int) -> BwdPlan:
    """The work item of one call shape (see the module doc).  The channel
    block is all of C (rounded up to a float4) when the chain reduces over
    C, else ``min(C, CB_MIN)`` so rounded.  Where the planner's tile
    (``tile_out_h``, ``tile_out_w``) has input regions that do not overlap,
    the tile is the one of :data:`TILE_SIDES` (each evened out over its
    tile count, or the output's extent) whose items cost least, ``items x
    (positions + ITEM_COST)``, in :data:`SMEM_BWD` (else in ``SMEM_MAX``),
    the squarer on a tie; where they overlap, the planner's tile, its
    channel block halved (to one float4), then its sides, until it fits.
    Raises ``nhwc.DescriptorError`` when nothing fits."""
    bc = compile_bwd_chain(program)
    n_slots, n_vecs = bc.chain.n_slots, len(bc.chain.vec_names)
    n_img, c = x_shape[0], x_shape[-1]
    c4 = -(-c // 4) * 4
    cb = c4 if bc.chain.rowred else min(c4, CB_MIN)
    if cb > 4 * THREADS:
        raise nhwc.DescriptorError(f"{program.name}: {c} channels reduced "
                                   f"over exceed {4 * THREADS}")
    extras = dict(extra_shapes)

    def geometry(th, tw):
        geo = nhwc.plan_geometry(program, x_shape, extras, th, tw)
        L = geo.levels[0]
        patches = (L.extent_h > geo.tile[0] * L.mul_h
                   or L.extent_w > geo.tile[1] * L.mul_w)
        return geo, (L.extent_h, L.extent_w), patches

    def plan(geo, l0, patches, cb_):
        n_cb = -(-c // cb_)
        spatial = n_img * geo.grid[1] * geo.grid[2]
        return BwdPlan(geo.tile, l0, geo.grid[1:], spatial, cb_, n_cb,
                       THREADS // (cb_ // 4),
                       _smem(n_slots, n_vecs, l0[0] * l0[1], cb_), patches)

    def sides(extent, targets=TILE_SIDES):  # evened out over the tile count
        return sorted({-(-extent // -(-extent // t))
                       for t in targets + (extent,)})

    if nhwc.fused_chain(program):   # the forward's items; no slots
        fp = nhwc.fused_plan(program, x_shape, extra_shapes)
        return BwdPlan(fp.tile, fp.level0, fp.tiles, fp.spatial, fp.cb,
                       fp.n_cb, fp.lanes, _smem(0, n_vecs, 0, fp.cb), False,
                       fused=True)
    geo, l0, patches = geometry(tile_out_h, tile_out_w)
    if patches:
        for budget in (SMEM_BWD, nhwc.SMEM_MAX):
            th, tw = geo.tile
            while True:
                g2, l2, _ = geometry(th, tw)
                cb_ = cb
                while cb_ > 4 and not bc.chain.rowred and _smem(
                        n_slots, n_vecs, l2[0] * l2[1], cb_) > budget:
                    cb_ = max(4, cb_ // 2 // 4 * 4)
                if _smem(n_slots, n_vecs, l2[0] * l2[1], cb_) <= budget:
                    return plan(g2, l2, True, cb_)
                if th == tw == 1:
                    break
                th, tw = max(1, th // 2), max(1, tw // 2)
        raise nhwc.DescriptorError(f"{program.name}: no tile and channel "
                                   f"block fit {nhwc.SMEM_MAX} B")
    oh, ow = geo.out_hw
    sides_h, sides_w = sides(oh), sides(ow)
    for budget in (SMEM_BWD, nhwc.SMEM_MAX):
        best = None
        for th in sides_h:
            for tw in sides_w:
                g2, l2, p2 = geometry(th, tw)
                e0 = l2[0] * l2[1]
                if p2 or _smem(n_slots, n_vecs, e0, cb) > budget:
                    continue
                key = (n_img * g2.grid[1] * g2.grid[2] * (e0 + ITEM_COST),
                       abs(th - tw), -e0)
                if best is None or key < best[0]:
                    best = (key, plan(g2, l2, False, cb))
        if best is not None:
            return best[1]
    raise nhwc.DescriptorError(f"{program.name}: no tile of {cb} channels "
                               f"fits {nhwc.SMEM_MAX} B")


#: The persistent grid, shared with the forward's fused path.
launch_programs = nhwc.launch_programs


#: Descriptors by call shape, without their vector pointers (LRU).
_TEMPLATES: "OrderedDict[tuple, bytes]" = OrderedDict()
_TEMPLATE_LIMIT = 256


def bwd_template(program: ir.StackProgram, x_shape: tuple[int, ...],
                 extra_shapes: tuple[tuple[str, tuple[int, ...]], ...],
                 vec_strides: tuple[int, ...],
                 tile_out_h: int, tile_out_w: int) -> bytes:
    """The backward descriptor of one call shape, its geometry from
    :func:`launch_plan`, without its vector pointers (``vec4`` 0); cached
    on the program's structural signature."""
    key = (program.signature(), x_shape, extra_shapes, vec_strides,
           tile_out_h, tile_out_w)
    hit = _TEMPLATES.get(key)
    if hit is not None:
        _TEMPLATES.move_to_end(key)
        return hit
    bc = compile_bwd_chain(program)
    plan = launch_plan(program, x_shape, extra_shapes, tile_out_h,
                       tile_out_w)
    f = nhwc.build_desc(program, bc.chain, x_shape, extra_shapes, vec_strides,
                        plan.tile[0], plan.tile[1], cb=plan.cb)
    b = NhwcBwdDesc()
    b.f = f
    for i, bo in enumerate(bc.bops):
        b.bops[i] = BwdOpDesc(**bo)
    for k, v in dict(g_slot=bc.g_slot, dx_slot=bc.dx_slot,
                     scratch=bc.scratch, n_vecs=len(bc.chain.vec_names),
                     work=plan.items, patches=int(plan.patches),
                     lanes=plan.lanes, spatial=plan.spatial, vec4=0,
                     fused=int(plan.fused)).items():
        setattr(b, k, v)
    if plan.fused:                  # the fused path keeps no slots
        b.f.n_slots = 0
    hit = _TEMPLATES[key] = bytes(b)
    while len(_TEMPLATES) > _TEMPLATE_LIMIT:
        _TEMPLATES.popitem(last=False)
    return hit


def direct_covers(b: NhwcBwdDesc) -> bool:
    """Whether the direct ``dx`` write reaches every element of ``dx``: the
    tiles' input regions abut (extent equal to stride, as under VGG's 2x2/s2
    pools) and reach the image's far edges.  Else ``dx`` is zeroed first."""
    f = b.f
    L = f.levels[0]
    sh, sw = f.th * L.mul_h, f.tw * L.mul_w
    return (not b.patches and L.eh == sh and L.ew == sw
            and f.tiles_h * sh - L.off_h >= f.H
            and f.tiles_w * sw - L.off_w >= f.W)


def fused_nhwc_bwd_ref(program: ir.StackProgram, x: torch.Tensor,
                       extras: Mapping[str, torch.Tensor],
                       params: Mapping[str, torch.Tensor], g: torch.Tensor
                       ) -> tuple[torch.Tensor, dict[str, torch.Tensor],
                                  dict[str, torch.Tensor]]:
    """The plain version: ``autodiff.program_vjp`` on whole tensors (the
    full-array POOL2D rule), not autograd of the forward."""
    inputs = {program.inputs[0]: x, **extras}
    env = autodiff.forward_env(program, inputs, params)
    dins, dparams = autodiff.program_vjp(program, env, params,
                                         {program.outputs[0]: g})
    return (dins[program.inputs[0]],
            {k: dins[k] for k in program.inputs[1:]}, dparams)


def fused_nhwc_bwd(program: ir.StackProgram, x: torch.Tensor,
                   extras: Mapping[str, torch.Tensor],
                   params: Mapping[str, torch.Tensor], g: torch.Tensor, *,
                   tile_out_h: int = 8, tile_out_w: int = 8
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor],
                              dict[str, torch.Tensor]]:
    """The backward of one nhwc sequence: ``g`` is the cotangent of its one
    output, ``extras`` the broadcast side operands.  Returns ``(dx,
    dextras, dparams)`` shaped as the primals.  CPU tensors run the plain
    version; CUDA tensors launch the kernels or raise."""
    extras = dict(extras or {})
    missing = [v for v in program.inputs[1:] if v not in extras]
    if missing:
        raise ValueError(f"{program.name}: missing extra inputs {missing}")
    if x.device.type == "cpu":
        return fused_nhwc_bwd_ref(program, x, extras, params, g)
    if not x.is_cuda:
        raise ValueError(f"fused_nhwc_bwd takes a cpu or cuda tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 4 or g.dtype != torch.float32 \
            or g.device != x.device:
        raise TypeError(f"fused_nhwc_bwd takes 4-d float32 x and g on one "
                        f"device, got {x.dtype} {tuple(x.shape)} and "
                        f"{g.dtype} on {g.device}")
    x = x.contiguous()
    g = g.contiguous()
    c = x.shape[-1]
    names = list(program.inputs[1:]) + list(program.param_names)
    vecs = []
    for name in names:
        v = extras[name] if name in extras else params[name]
        if v.device != x.device or v.dtype != torch.float32:
            raise TypeError(f"operand {name!r} must be float32 on {x.device}, "
                            f"got {v.dtype} on {v.device}")
        vecs.append(nhwc._vec_operand(name, v, c))
    strides = tuple(int(v.numel() != 1) for v in vecs)
    blob = bwd_template(program, tuple(x.shape),
                        tuple(sorted((k, tuple(v.shape))
                                     for k, v in extras.items())),
                        strides, tile_out_h, tile_out_w)
    b = NhwcBwdDesc.from_buffer_copy(blob)
    f = b.f
    if tuple(g.shape) != (f.N, f.OH, f.OW, c):
        raise ValueError(f"{program.name}: cotangent shape {tuple(g.shape)} "
                         f"!= output shape {(f.N, f.OH, f.OW, c)}")
    for i, v in enumerate(vecs):
        b.f.vecs[i] = v.data_ptr()
    lib = _library()
    n_vec = max(len(vecs) * c, 1)
    with torch.cuda.device(x.device):
        dx = (torch.empty_like(x) if b.patches or direct_covers(b)
              else torch.zeros_like(x))
        b.vec4 = int(c % 4 == 0 and all(t.data_ptr() % 16 == 0
                                        for t in (x, g, dx)))
        dvecs = torch.zeros(n_vec, device=x.device, dtype=torch.float32)
        if b.work:
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            programs = launch_programs(b.spatial, f.n_cb, sms,
                                       _ctas_per_sm(lib, b))
            l0 = f.levels[0]
            patches = torch.empty(
                (f.N * f.tiles_h * f.tiles_w * l0.eh * l0.ew * c
                 if b.patches else 1), device=x.device, dtype=torch.float32)
            partials = torch.empty(programs * max(b.n_vecs, 1) * f.cb,
                                   device=x.device, dtype=torch.float32)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.fused_nhwc_bwd_launch(
                ctypes.byref(b), programs, x.data_ptr(), g.data_ptr(),
                dx.data_ptr(), patches.data_ptr(), partials.data_ptr(),
                dvecs.data_ptr(), stream)
            if err != 0:
                _raise(lib, err)
            fused_nhwc_bwd.launches += 1
        else:
            dx.zero_()
    grads = {}
    for i, name in enumerate(names):
        src = extras[name] if name in extras else params[name]
        d = dvecs[i * c: (i + 1) * c] if strides[i] else dvecs[i * c: i * c + 1]
        grads[name] = d.reshape(src.shape)
    return (dx, {k: grads[k] for k in program.inputs[1:]},
            {k: grads[k] for k in program.param_names})


fused_nhwc_bwd.launches = 0


#: Backward CTAs an SM by (device, shared-memory bytes).
_CTAS_PER_SM: dict[tuple[int, int], int] = {}


def _ctas_per_sm(lib: ctypes.CDLL, b: NhwcBwdDesc) -> int:
    smem = desc_smem(b)
    key = (torch.cuda.current_device(), smem)
    hit = _CTAS_PER_SM.get(key)
    if hit is None:
        hit = lib.fused_nhwc_bwd_ctas_per_sm(ctypes.byref(b))
        if hit < 0:
            _raise(lib, -hit)
        if hit == 0:
            raise RuntimeError(f"fused_nhwc_bwd: no CTA of {smem} B of shared"
                               f" memory fits an SM")
        _CTAS_PER_SM[key] = hit
    return hit


def _raise(lib: ctypes.CDLL, err: int) -> None:
    raise RuntimeError(f"fused_nhwc_bwd launch failed: CUDA error {err} "
                       f"({lib.fused_nhwc_bwd_error(err).decode()})")


def _library() -> ctypes.CDLL:
    lib = _build.load_library(SOURCE)
    if not getattr(lib, "_bound", False):
        p = ctypes.c_void_p
        lib.fused_nhwc_bwd_ctas_per_sm.argtypes = [
            ctypes.POINTER(NhwcBwdDesc)]
        lib.fused_nhwc_bwd_ctas_per_sm.restype = ctypes.c_int
        lib.fused_nhwc_bwd_launch.argtypes = [
            ctypes.POINTER(NhwcBwdDesc), ctypes.c_int, p, p, p, p, p, p, p]
        lib.fused_nhwc_bwd_launch.restype = ctypes.c_int
        lib.fused_nhwc_bwd_desc_size.argtypes = []
        lib.fused_nhwc_bwd_desc_size.restype = ctypes.c_int
        lib.fused_nhwc_bwd_error.argtypes = [ctypes.c_int]
        lib.fused_nhwc_bwd_error.restype = ctypes.c_char_p
        size = lib.fused_nhwc_bwd_desc_size()
        if size != ctypes.sizeof(NhwcBwdDesc):
            raise RuntimeError(f"NhwcBwdDesc is {ctypes.sizeof(NhwcBwdDesc)} B"
                               f" in Python but {size} B in {SOURCE.name}")
        lib._bound = True
    return lib
