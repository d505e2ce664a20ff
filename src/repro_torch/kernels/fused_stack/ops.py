"""Dispatch of one collapsed Sequence to its fused kernels.

``fused_stack_apply`` runs one Sequence in one of three modes:

* ``brainslug`` — the hand-written depth-first kernels: CUDA
  (:mod:`.nhwc`, :mod:`.nhwc_bwd`) for pooling chains, Triton (:mod:`.rows`,
  :mod:`.rows_bwd`) for row chains.  Each executable is a
  ``torch.autograd.Function``: the forward runs the forward kernel and saves
  the inputs and parameters (not intermediates), the backward runs the
  backward kernel, which recomputes the chain on the resident tile.  On CPU
  tensors (an explicit CPU request) both run their plain versions and record
  ``*_reference``, so a CPU run never counts as kernel coverage.  Where the
  JAX package itself takes its reference path, so does the port, and counts
  it: nhwc stacks whose extra inputs are spatially extended run the plain
  forward and differentiate it with autograd, and so does the backward of a
  program with an op outside ``autodiff.supports``.
* ``xla``     — the interpreter under ``torch.compile`` (inductor,
  ``fullgraph=True``): the compiler-fusion comparison point, as XLA's
  fusion of the plain path is in the JAX package (:func:`xla_callable`).
* ``barrier`` — the eager interpreter with every op output materialised
  (the paper's breadth-first baseline).

Both non-brainslug modes differentiate through autograd (``xla`` through
AOTAutograd's compiled backward).  Executables are built once per
structural signature + tile geometry and cached (paper: "If there are
multiple equivalent stacks, BRAINSLUG only generates the code once"); one
entry holds the forward and the backward.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import types
from collections import OrderedDict
from typing import Callable, Mapping

import torch

from repro_torch.core import autodiff, ir, resource
from repro_torch.kernels.fused_stack import (nhwc, nhwc_bwd, ref, rows,
                                              rows_bwd)

MODES = ("brainslug", "xla", "barrier")


class DispatchStats:
    """Dispatch counters: which path ran, the generated depth-first kernel
    or the plain version.  PyTorch runs eagerly, so counts are per call (the
    JAX package counts per trace).

    ``STATS`` is a process-wide instance; callers that need isolation take a
    :meth:`snapshot` first and diff against it (``STATS.delta(before)``),
    or :meth:`reset` at phase boundaries."""

    BASE_KEYS = ("fwd_generated", "fwd_reference",
                 "bwd_generated", "bwd_reference", "fwd_xla_compiled")

    def __init__(self, keys: tuple[str, ...] = BASE_KEYS) -> None:
        self._keys = tuple(keys)
        self.reset()

    def reset(self) -> None:
        self.counts: dict[str, int] = {k: 0 for k in self._keys}

    def record(self, key: str, n: int = 1) -> None:
        if key not in self.counts:
            raise KeyError(
                f"unknown dispatch counter {key!r}; declared: {self._keys}")
        self.counts[key] += n

    def snapshot(self) -> dict[str, int]:
        """An immutable copy of the current counts, for later diffing."""
        return dict(self.counts)

    def delta(self, before: Mapping[str, int]) -> dict[str, int]:
        """Counts recorded since ``before`` (a :meth:`snapshot`)."""
        return {k: v - before.get(k, 0) for k, v in self.counts.items()}


STATS = DispatchStats()


def is_broadcast_operand(a: torch.Tensor) -> bool:
    """True when an nhwc side operand can ride along like a parameter: a
    channel vector, or any shape whose every non-channel dim is 1."""
    shape = tuple(a.shape)
    if len(shape) == 0:
        return False                    # scalars: keep the reference path
    return len(shape) == 1 or all(d == 1 for d in shape[:-1])


@dataclasses.dataclass(frozen=True)
class FusedExecutable:
    """The generated forward + backward pair of one Sequence (brainslug
    mode)."""

    program: ir.StackProgram
    tile_rows: int
    tile_out_h: int
    tile_out_w: int
    call: Callable[..., tuple[torch.Tensor, ...]]   # (in_list, p_list) -> outs
    generated_bwd: bool                             # depth-first backward?
    f_chunk: int            # the plan's device's (resource.feature_block)


#: LRU over generated executables, bounded so a long-lived process that
#: keeps producing fresh signatures does not leak one per signature.
_EXEC_CACHE: "OrderedDict[tuple, FusedExecutable]" = OrderedDict()
_CACHE_LIMIT = 256


def set_cache_limit(n: int) -> None:
    global _CACHE_LIMIT
    if n < 1:
        raise ValueError(f"cache limit must be >= 1, got {n}")
    _CACHE_LIMIT = n
    for cache in (_EXEC_CACHE, _XLA_CACHE, _POSITIONAL):
        while len(cache) > _CACHE_LIMIT:
            cache.popitem(last=False)


def get_executable(program: ir.StackProgram, *, tile_rows: int = 256,
                   tile_out_h: int = 8, tile_out_w: int = 8,
                   f_chunk: int = resource.H100.f_chunk,
                   differentiable: bool = False) -> FusedExecutable:
    """Build (or fetch) the cached executable for ``program`` at the given
    tile geometry and feature chunk, keyed on the structural signature so
    equivalent stacks share one.  ``differentiable`` (a plan sized for
    training) also plans the nhwc backward's slots now, so a sequence the
    backward descriptor cannot hold fails here, not mid-backward."""
    key = (program.signature(), tile_rows, tile_out_h, tile_out_w, f_chunk,
           differentiable)
    exe = _EXEC_CACHE.get(key)
    if exe is None:
        exe = _build_executable(program, tile_rows, tile_out_h, tile_out_w,
                                f_chunk, differentiable)
        _EXEC_CACHE[key] = exe
    _EXEC_CACHE.move_to_end(key)
    while len(_EXEC_CACHE) > _CACHE_LIMIT:
        _EXEC_CACHE.popitem(last=False)
    return exe


def clear_executable_cache() -> None:
    _EXEC_CACHE.clear()


def _build_executable(program: ir.StackProgram, tile_rows: int,
                      tile_out_h: int, tile_out_w: int, f_chunk: int,
                      differentiable: bool) -> FusedExecutable:
    names = tuple(program.inputs)
    pnames = tuple(program.param_names)
    n_in = len(names)
    is_nhwc = program.layout == "nhwc"
    generated_bwd = autodiff.supports(program) and (
        not is_nhwc or len(program.outputs) == 1)
    if differentiable and generated_bwd and is_nhwc:
        nhwc_bwd.compile_bwd_chain(program)

    def kernel_path(in_list) -> bool:
        """Can this call run the generated kernels?  For nhwc only when the
        extra inputs are broadcast side operands (else the JAX package's
        reference path).  On CPU tensors the wrappers run their plain
        versions."""
        return not is_nhwc or (len(program.outputs) == 1 and all(
            is_broadcast_operand(a) for a in in_list[1:]))

    def forward(in_list, p_list) -> tuple[torch.Tensor, ...]:
        inputs = dict(zip(names, in_list))
        params = dict(zip(pnames, p_list))
        if not kernel_path(in_list):
            STATS.record("fwd_reference")
            out = ref.fused_stack_ref(program, inputs, params)
            return tuple(out[v] for v in program.outputs)
        STATS.record("fwd_generated" if in_list[0].is_cuda
                     else "fwd_reference")
        if is_nhwc:
            return (nhwc.fused_nhwc(
                program, in_list[0], params,
                extras=dict(zip(names[1:], in_list[1:])),
                tile_out_h=tile_out_h, tile_out_w=tile_out_w),)
        out = rows.fused_rows(program, inputs, params, tile_rows=tile_rows)
        return tuple(out[v] for v in program.outputs)

    def backward(in_list, p_list, gs) -> tuple[torch.Tensor | None, ...]:
        if generated_bwd and kernel_path(in_list):
            STATS.record("bwd_generated" if in_list[0].is_cuda
                         else "bwd_reference")
            params = dict(zip(pnames, p_list))
            if is_nhwc:
                dx, dextras, dparams = nhwc_bwd.fused_nhwc_bwd(
                    program, in_list[0], dict(zip(names[1:], in_list[1:])),
                    params, gs[0], tile_out_h=tile_out_h,
                    tile_out_w=tile_out_w)
                dins = {names[0]: dx, **dextras}
            else:
                dins, dparams = rows_bwd.fused_rows_bwd(
                    program, dict(zip(names, in_list)), params,
                    dict(zip(program.outputs, gs)), tile_rows=tile_rows,
                    f_chunk=f_chunk)
            return (tuple(dins[n] for n in names)
                    + tuple(dparams[p] for p in pnames))
        # the JAX package's reference VJP: autograd of the plain version
        STATS.record("bwd_reference")
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(t.is_floating_point())
                      for t in (*in_list, *p_list)]
            out = ref.fused_stack_ref(program, dict(zip(names, leaves[:n_in])),
                                      dict(zip(pnames, leaves[n_in:])))
            outs = [out[v] for v in program.outputs]
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(outs, wrt, gs,
                                             allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)

    class Fused(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *tensors):
            outs = forward(tensors[:n_in], tensors[n_in:])
            ctx.save_for_backward(*tensors)
            ctx.out_like = [(o.shape, o.dtype, o.device) for o in outs]
            return outs

        @staticmethod
        def backward(ctx, *gs):
            tensors = ctx.saved_tensors
            gs = [torch.zeros(shape, dtype=dtype, device=device) if g is None
                  else g.contiguous()       # None: an output no loss reads
                  for g, (shape, dtype, device) in zip(gs, ctx.out_like)]
            return backward(tensors[:n_in], tensors[n_in:], gs)

    def call(in_list, p_list):
        return Fused.apply(*in_list, *p_list)

    return FusedExecutable(program=program, tile_rows=tile_rows,
                           tile_out_h=tile_out_h, tile_out_w=tile_out_w,
                           call=call, generated_bwd=generated_bwd,
                           f_chunk=f_chunk)


# ---------------------------------------------------------------------------
# xla mode: the plain interpreter under torch.compile.
# ---------------------------------------------------------------------------

#: LRU over compiled xla callables, bounded with the executables.  Kept
#: across clear_executable_cache(): they hold no plan state, and dropping
#: one only makes dynamo and inductor compile it again.
_XLA_CACHE: "OrderedDict[tuple, Callable]" = OrderedDict()
_XLA_IDS = itertools.count()

#: ``id(program)`` -> (program, its positional program, that one's
#: signature): the stacks a process calls again and again are long-lived
#: objects (the LM's are cached, a plan's are held by its executor), so a
#: warm ``xla`` call rebuilds no program and computes no signature.  The
#: entry holds its program, so the id cannot be reused while it lives.
#: Bounded with the caches above.
_POSITIONAL: "OrderedDict[int, tuple]" = OrderedDict()


def _positional(program: ir.StackProgram) -> ir.StackProgram:
    """``program`` with its values and parameters renamed by position
    (inputs ``x{i}``, parameters ``p{j}``, op outputs ``v{k}``): stacks that
    differ only in names (the traced graph's and ``optimize_graph``'s
    VGG stages, one LM stack in several models) compile once."""
    names = {v: f"x{i}" for i, v in enumerate(program.inputs)}
    pnames = {q: f"p{j}" for j, q in enumerate(program.param_names)}
    ops = []
    for k, op in enumerate(program.ops):
        names[op.output] = f"v{k}"
        ops.append(dataclasses.replace(
            op, name=f"op{k}", output=f"v{k}",
            inputs=tuple(names[v] for v in op.inputs),
            params=tuple(pnames[q] for q in op.params)))
    return ir.StackProgram(
        name="xla", inputs=tuple(names[v] for v in program.inputs),
        outputs=tuple(names[v] for v in program.outputs), ops=tuple(ops),
        layout=program.layout)


def _positional_of(program: ir.StackProgram
                   ) -> tuple[ir.StackProgram, tuple]:
    """The memoised :func:`_positional` of ``program`` and its
    signature."""
    held = _POSITIONAL.get(id(program))
    if held is None or held[0] is not program:
        pos = _positional(program)
        held = _POSITIONAL[id(program)] = (program, pos, pos.signature())
        while len(_POSITIONAL) > _CACHE_LIMIT:
            _POSITIONAL.popitem(last=False)
    return held[1], held[2]


def _xla_key(pos_sig: tuple, tensors) -> tuple:
    """One compiled callable per positional signature, operand dtypes,
    device type and whether autograd records it.  Each gets a code object
    of its own, so dynamo's recompile limit (8 entries a code object) is
    spent only on the shapes of one such class: the first shape, the
    dynamic graph after it, and dynamo's 0/1 specialisations.  The limit
    itself stays at its default, and hitting it raises: under
    ``fullgraph=True`` dynamo refuses to run a frame eager."""
    training = torch.is_grad_enabled() and any(t.requires_grad
                                               for t in tensors)
    return (pos_sig, tuple(t.dtype for t in tensors),
            tensors[0].device.type, training)


def xla_callable(program: ir.StackProgram, tensors) -> Callable:
    """The compiled plain function of ``program`` for operands like
    ``tensors`` (inputs in ``program.inputs`` order, then parameters in
    ``program.param_names`` order): ``fn(*tensors) -> outputs tuple`` in
    ``program.outputs`` order.

    The plain interpreter (:func:`ref.fused_stack_ref`) of the program
    renamed by position (:func:`_positional`) runs through
    ``torch.compile(backend="inductor", fullgraph=True)``.  A graph break
    raises; so does the recompile limit.  Row programs mark every dim but
    the feature dim dynamic on their first call, so prefill lengths, the
    engine's mixed step and the MoE expert batch reuse one graph; nhwc
    programs compile static and turn dynamic only if a second shape
    comes (dynamo's automatic dynamic shapes)."""
    return _xla_entry(program, tensors)[0]


def _xla_entry(program: ir.StackProgram, tensors
               ) -> tuple[Callable, bool]:
    """:func:`xla_callable`'s callable, and whether it was made by this
    call (its first call compiles)."""
    program, pos_sig = _positional_of(program)
    key = _xla_key(pos_sig, tensors)
    fn = _XLA_CACHE.get(key)
    fresh = fn is None
    if fresh:
        names, pnames = tuple(program.inputs), tuple(program.param_names)
        n_in = len(names)

        def xla_stack(*ts):
            out = ref.fused_stack_ref(program, dict(zip(names, ts[:n_in])),
                                      dict(zip(pnames, ts[n_in:])))
            return tuple(out[v] for v in program.outputs)

        # a code object of its own (see _xla_key); closures made by one
        # ``def`` share theirs, and dynamo keeps its cache on the code
        name = f"xla_stack_{next(_XLA_IDS)}"
        code = xla_stack.__code__.replace(co_name=name, co_qualname=name)
        fn = torch.compile(
            types.FunctionType(code, xla_stack.__globals__, name, None,
                               xla_stack.__closure__),
            backend="inductor", fullgraph=True)
        _XLA_CACHE[key] = fn
    _XLA_CACHE.move_to_end(key)
    while len(_XLA_CACHE) > _CACHE_LIMIT:
        _XLA_CACHE.popitem(last=False)
    return fn, fresh


def _checkpoint_modes_only() -> bool:
    """True when every active TorchDispatchMode is one of
    ``torch.utils.checkpoint``'s selective-checkpoint modes (the
    ``remat="dots"`` policy of :mod:`repro_torch.models.lm`)."""
    from torch.utils import checkpoint as ckpt
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    sac = tuple(getattr(ckpt, n) for n in ("_CachingTorchDispatchMode",
                                          "_CachedTorchDispatchMode")
                if hasattr(ckpt, n))
    return all(isinstance(m, sac) for m in _get_current_dispatch_mode_stack())


def run_xla(program: ir.StackProgram, inputs: Mapping[str, torch.Tensor],
            params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """One compiled ``xla`` call of ``program``; counts ``fwd_xla_compiled``.

    Under ``remat="dots"`` the forward and its recomputation run inside
    selective checkpointing's dispatch modes.  Every op of a stack is one
    that policy recomputes, so the compiled call runs with those modes
    set aside: the modes would otherwise see the ops the compiled code
    dispatches, and record nothing the policy keeps.  Autograd's saved-
    tensor hooks, which drop and recompute what the call saves, stay on.
    Any other active dispatch mode raises: compiling under it is untried,
    and xla never falls back to eager in silence."""
    tensors = ([inputs[n] for n in program.inputs]
               + [params[p] for p in program.param_names])
    fn, fresh = _xla_entry(program, tensors)
    if fresh and program.layout == "rows":
        # the marks matter to the compile the first call makes; later
        # calls meet the graph's own guards
        from torch._dynamo import maybe_mark_dynamic
        for t in tensors:
            for d in range(t.dim() - 1):
                maybe_mark_dynamic(t, d)
    modes = contextlib.nullcontext()
    if torch._C._len_torch_dispatch_stack():
        from torch.utils._python_dispatch import _disable_current_modes
        if not _checkpoint_modes_only():
            raise NotImplementedError(
                "mode='xla' cannot run its compiled stacks under an active "
                "TorchDispatchMode other than selective checkpointing's; "
                "use mode='barrier' for the eager plain path")
        modes = _disable_current_modes()
    with modes:
        outs = fn(*tensors)
    STATS.record("fwd_xla_compiled")
    return dict(zip(program.outputs, outs))


def fused_stack_apply(program: ir.StackProgram,
                      inputs: Mapping[str, torch.Tensor],
                      params: Mapping[str, torch.Tensor],
                      *,
                      mode: str = "xla",
                      tile_rows: int = 256,
                      tile_out_h: int = 8,
                      tile_out_w: int = 8,
                      f_chunk: int = resource.H100.f_chunk,
                      differentiable: bool = False
                      ) -> dict[str, torch.Tensor]:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "barrier":
        return ref.fused_stack_ref(program, inputs, params, barrier=True)
    if mode == "xla":
        return run_xla(program, inputs, params)
    exe = get_executable(program, tile_rows=tile_rows, tile_out_h=tile_out_h,
                         tile_out_w=tile_out_w, f_chunk=f_chunk,
                         differentiable=differentiable)
    in_list = tuple(inputs[n] for n in program.inputs)
    p_list = tuple(params[p] for p in program.param_names)
    return dict(zip(program.outputs, exe.call(in_list, p_list)))
