"""Depth-first backward of nhwc-layout stacks (pooling chains), in CUDA.

Replaces ``repro/kernels/fused_stack/nhwc_bwd.py:fused_nhwc_bwd_call`` (the
Pallas kernel).  The source is ``csrc/fused_nhwc_bwd.cu``; it recomputes
each tile with the forward's own device code (``csrc/fused_nhwc.cuh``) and
walks the forward's descriptor (:class:`~.nhwc.NhwcDesc`) in reverse.

Host side (:func:`compile_bwd_chain`): the forward chain compiled with every
value in a slot of its own (the reverse sweep reads them back), plus the
cotangent slots of a liveness scan over the reversed chain (a value's
cotangent is born at its last consumer and dies once its producer is
transposed), plus one scratch slot when a norm has a scale.  The limit is
:data:`BWD_MAX_SLOTS`; the channel block keeps the slots and the gradient
accumulators under the forward's shared-memory target.

The grid is persistent (as many CTAs as fit the card at once), so per-CTA
parameter and broadcast-extra partials stay few and a second kernel sums
them in a fixed order; the input cotangent goes straight to ``dx`` where
tiles' halos do not overlap, else through private halo patches and a
gather overlap-add.  No float atomics: two runs give equal bits.

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


class BwdOpDesc(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in (
        "g", "da", "db", "da_acc", "db_acc", "same", "level")]


class NhwcBwdDesc(ctypes.Structure):
    _fields_ = ([("f", nhwc.NhwcDesc), ("bops", BwdOpDesc * nhwc.MAX_OPS)]
                + [(f, ctypes.c_int) for f in (
                    "g_slot", "dx_slot", "scratch", "n_vecs", "work",
                    "patches")])


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


#: Descriptors by call shape, without their vector pointers (LRU).
_TEMPLATES: "OrderedDict[tuple, bytes]" = OrderedDict()
_TEMPLATE_LIMIT = 256


def bwd_template(program: ir.StackProgram, x_shape: tuple[int, ...],
                 extra_shapes: tuple[tuple[str, tuple[int, ...]], ...],
                 vec_strides: tuple[int, ...],
                 tile_out_h: int, tile_out_w: int) -> bytes:
    """The backward descriptor of one call shape, without its vector
    pointers; cached on the program's structural signature."""
    key = (program.signature(), x_shape, extra_shapes, vec_strides,
           tile_out_h, tile_out_w)
    hit = _TEMPLATES.get(key)
    if hit is not None:
        _TEMPLATES.move_to_end(key)
        return hit
    bc = compile_bwd_chain(program)
    n_vecs = len(bc.chain.vec_names)
    f = nhwc.build_desc(program, bc.chain, x_shape, extra_shapes, vec_strides,
                        tile_out_h, tile_out_w,
                        fixed_bytes=n_vecs * x_shape[-1] * 4)
    b = NhwcBwdDesc()
    b.f = f
    for i, bo in enumerate(bc.bops):
        b.bops[i] = BwdOpDesc(**bo)
    l0 = f.levels[0]
    for k, v in dict(g_slot=bc.g_slot, dx_slot=bc.dx_slot,
                     scratch=bc.scratch, n_vecs=n_vecs,
                     work=f.N * f.tiles_h * f.tiles_w * f.n_cb,
                     patches=int(l0.eh > f.th * l0.mul_h
                                 or l0.ew > f.tw * l0.mul_w)).items():
        setattr(b, k, v)
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
        dvecs = torch.zeros(n_vec, device=x.device, dtype=torch.float32)
        if b.work:
            programs = lib.fused_nhwc_bwd_programs(ctypes.byref(b))
            if programs < 0:
                _raise(lib, -programs)
            l0 = f.levels[0]
            patches = torch.empty(
                (f.N * f.tiles_h * f.tiles_w * l0.eh * l0.ew * c
                 if b.patches else 1), device=x.device, dtype=torch.float32)
            partials = torch.empty(programs * n_vec, device=x.device,
                                   dtype=torch.float32)
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


def _raise(lib: ctypes.CDLL, err: int) -> None:
    raise RuntimeError(f"fused_nhwc_bwd launch failed: CUDA error {err} "
                       f"({lib.fused_nhwc_bwd_error(err).decode()})")


def _library() -> ctypes.CDLL:
    lib = _build.load_library(SOURCE)
    if not getattr(lib, "_bound", False):
        p = ctypes.c_void_p
        lib.fused_nhwc_bwd_programs.argtypes = [ctypes.POINTER(NhwcBwdDesc)]
        lib.fused_nhwc_bwd_programs.restype = ctypes.c_int
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
