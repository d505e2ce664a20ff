"""Dispatch of one collapsed Sequence to its fused kernel.

``fused_stack_apply`` runs one Sequence in one of three modes:

* ``brainslug`` — the hand-written depth-first kernels: CUDA
  (:mod:`.nhwc`) for pooling chains, Triton (:mod:`.rows`) for row chains.
  On CPU tensors (an explicit CPU request) it runs their plain version and
  records ``fwd_reference``, so a CPU run never counts as kernel coverage.
  nhwc stacks whose extra inputs are spatially extended (not broadcast side
  operands) run the plain version on the card too and record
  ``fwd_reference``, as the JAX package does.  The forward only: a
  ``brainslug`` executable refuses inputs that require grad (the generated
  backward kernels are Slice B of the port).
* ``xla``     — the eager interpreter (PyTorch runs one kernel per op).
* ``barrier`` — the interpreter with every op output materialised (the
  paper's breadth-first baseline).

Both non-brainslug modes differentiate natively through autograd.
Executables are built once per structural signature + tile geometry and
cached (paper: "If there are multiple equivalent stacks, BRAINSLUG only
generates the code once").
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Mapping

import torch

from repro_torch.core import ir
from repro_torch.kernels.fused_stack import nhwc, ref, rows

MODES = ("brainslug", "xla", "barrier")


class DispatchStats:
    """Dispatch counters: which path ran, the generated depth-first kernel
    or the plain version.  PyTorch runs eagerly, so counts are per call (the
    JAX package counts per trace).

    ``STATS`` is a process-wide instance; callers that need isolation take a
    :meth:`snapshot` first and diff against it (``STATS.delta(before)``),
    or :meth:`reset` at phase boundaries."""

    BASE_KEYS = ("fwd_generated", "fwd_reference",
                 "bwd_generated", "bwd_reference")

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
    """The generated forward of one Sequence (brainslug mode)."""

    program: ir.StackProgram
    tile_rows: int
    tile_out_h: int
    tile_out_w: int
    call: Callable[..., tuple[torch.Tensor, ...]]   # (in_list, p_list) -> outs


#: LRU over generated executables, bounded so a long-lived process that
#: keeps producing fresh signatures does not leak one per signature.
_EXEC_CACHE: "OrderedDict[tuple, FusedExecutable]" = OrderedDict()
_CACHE_LIMIT = 256


def set_cache_limit(n: int) -> None:
    global _CACHE_LIMIT
    if n < 1:
        raise ValueError(f"cache limit must be >= 1, got {n}")
    _CACHE_LIMIT = n
    while len(_EXEC_CACHE) > _CACHE_LIMIT:
        _EXEC_CACHE.popitem(last=False)


def get_executable(program: ir.StackProgram, *, tile_rows: int = 256,
                   tile_out_h: int = 8, tile_out_w: int = 8
                   ) -> FusedExecutable:
    """Build (or fetch) the cached executable for ``program`` at the given
    tile geometry, keyed on the structural signature so equivalent stacks
    share one."""
    key = (program.signature(), tile_rows, tile_out_h, tile_out_w)
    exe = _EXEC_CACHE.get(key)
    if exe is None:
        exe = _build_executable(program, tile_rows, tile_out_h, tile_out_w)
        _EXEC_CACHE[key] = exe
    _EXEC_CACHE.move_to_end(key)
    while len(_EXEC_CACHE) > _CACHE_LIMIT:
        _EXEC_CACHE.popitem(last=False)
    return exe


def clear_executable_cache() -> None:
    _EXEC_CACHE.clear()


def _refuse_grad(program: ir.StackProgram, tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{program.name}: a brainslug executable runs the forward only; "
            f"the generated backward kernels are Slice B of the port.  Call "
            f"it under torch.no_grad(), or use mode='xla'/'barrier' to "
            f"differentiate")


def _build_executable(program: ir.StackProgram, tile_rows: int,
                      tile_out_h: int, tile_out_w: int) -> FusedExecutable:
    names = tuple(program.inputs)
    pnames = tuple(program.param_names)
    is_nhwc = program.layout == "nhwc"

    def generated(in_list) -> bool:
        """Can this call run the kernel?  Only on the card, and for nhwc
        only when the extra inputs are broadcast side operands."""
        if not in_list[0].is_cuda:
            return False
        return not is_nhwc or (len(program.outputs) == 1 and all(
            is_broadcast_operand(a) for a in in_list[1:]))

    def call(in_list, p_list):
        _refuse_grad(program, (*in_list, *p_list))
        inputs = dict(zip(names, in_list))
        params = dict(zip(pnames, p_list))
        if not generated(in_list):
            STATS.record("fwd_reference")
            out = ref.fused_stack_ref(program, inputs, params)
            return tuple(out[v] for v in program.outputs)
        STATS.record("fwd_generated")
        if is_nhwc:
            y = nhwc.fused_nhwc(
                program, in_list[0], params,
                extras=dict(zip(names[1:], in_list[1:])),
                tile_out_h=tile_out_h, tile_out_w=tile_out_w)
            return (y,)
        out = rows.fused_rows(program, inputs, params, tile_rows=tile_rows)
        return tuple(out[v] for v in program.outputs)

    return FusedExecutable(program=program, tile_rows=tile_rows,
                           tile_out_h=tile_out_h, tile_out_w=tile_out_w,
                           call=call)


def fused_stack_apply(program: ir.StackProgram,
                      inputs: Mapping[str, torch.Tensor],
                      params: Mapping[str, torch.Tensor],
                      *,
                      mode: str = "xla",
                      tile_rows: int = 256,
                      tile_out_h: int = 8,
                      tile_out_w: int = 8) -> dict[str, torch.Tensor]:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "barrier":
        return ref.fused_stack_ref(program, inputs, params, barrier=True)
    if mode == "xla":
        return ref.fused_stack_ref(program, inputs, params)
    exe = get_executable(program, tile_rows=tile_rows, tile_out_h=tile_out_h,
                         tile_out_w=tile_out_w)
    in_list = tuple(inputs[n] for n in program.inputs)
    p_list = tuple(params[p] for p in program.param_names)
    return dict(zip(program.outputs, exe.call(in_list, p_list)))
