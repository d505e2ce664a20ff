"""Code Generator — paper compile-phase step 5.

Turns a :class:`~repro_torch.core.collapse.CollapsePlan` into an executor.
Sequences run serially, communicating through materialised boundary values
(paper §4.2); within a sequence the configured mode decides the schedule:

* ``brainslug`` — the hand-written depth-first kernels (one forward and
  one backward launch per sequence; see
  :mod:`repro_torch.kernels.fused_stack.ops`);
* ``xla``       — each sequence's plain function under ``torch.compile``
  (inductor fuses it, as XLA fuses the plain path in the JAX package);
* ``barrier``   — per-op materialisation (the paper's framework baseline).

Registry ``KERNEL`` ops compile through :func:`compile_kernel_op`: the
hand-written kernel (``hopper``) or its plain version (``ref``), decided
once from the traced shapes and the mode.

Executors are cached on the program's structural signature, plan shapes and
tile geometry (the paper generates code once per equivalent stack), kernel
closures on the kernel, backend and static attributes (identical kernel
sites share one).  The cache is LRU-bounded
(``OptimizeConfig.code_cache_size``); ``clear_cache()`` resets the dispatch
counters alongside.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Mapping

import torch

from repro_torch.core import ir
from repro_torch.core import collapse as collapse_mod
from repro_torch.core import registry as registry_mod
from repro_torch.kernels.fused_stack import ops as fused_ops

Executor = Callable[[Mapping[str, torch.Tensor], Mapping[str, torch.Tensor]],
                    dict[str, torch.Tensor]]

#: LRU over compiled executors.
_CODE_CACHE: "OrderedDict[tuple, Executor]" = OrderedDict()
_CACHE_LIMIT = 256
_LIMIT_PINNED = False          # an explicit set_cache_limit() wins over
#                                per-config floors until the next one


def set_cache_limit(n: int) -> None:
    """Bound both executor caches (this module's and the fused executable
    cache behind it) to ``n`` entries.  An explicit call pins the limit:
    later config-driven sizing will not undo it."""
    global _CACHE_LIMIT, _LIMIT_PINNED
    if n < 1:
        raise ValueError(f"cache limit must be >= 1, got {n}")
    _CACHE_LIMIT = n
    _LIMIT_PINNED = True
    while len(_CODE_CACHE) > _CACHE_LIMIT:
        _CODE_CACHE.popitem(last=False)
    fused_ops.set_cache_limit(n)


def _raise_cache_limit_to(n: int) -> None:
    """Config-driven sizing only ever raises the process-wide bound (a
    smaller config must not evict another live net's executors) and never
    overrides a pinned limit."""
    global _CACHE_LIMIT
    if _LIMIT_PINNED or n <= _CACHE_LIMIT:
        return
    _CACHE_LIMIT = n
    fused_ops.set_cache_limit(n)


def _cache_get(key: tuple):
    hit = _CODE_CACHE.get(key)
    if hit is not None:
        _CODE_CACHE.move_to_end(key)
    return hit


def _cache_put(key: tuple, value) -> None:
    _CODE_CACHE[key] = value
    _CODE_CACHE.move_to_end(key)
    while len(_CODE_CACHE) > _CACHE_LIMIT:
        _CODE_CACHE.popitem(last=False)


def compile_plan(plan: collapse_mod.CollapsePlan, *, mode: str = "xla",
                 cache_size: int | None = None) -> Executor:
    """Compile a collapse plan into ``executor(inputs, params) -> outputs``.
    In ``xla`` mode each sequence runs compiled, one compiled callable a
    sequence signature (:func:`~repro_torch.kernels.fused_stack.ops.
    xla_callable`), built at its first call."""
    if cache_size is not None:
        _raise_cache_limit_to(cache_size)
    key = (plan.program.signature(), mode, plan.input_shapes,
           tuple((s.tile_rows, s.tile_out_h, s.tile_out_w)
                 for s in plan.sequences),
           plan.device.f_chunk, plan.differentiable)
    cached = _cache_get(key)
    if cached is not None:
        return cached

    subprograms = [plan.subprogram(i) for i in range(len(plan.sequences))]

    def geometry(seq: collapse_mod.SequencePlan) -> dict:
        """The executable's tiles, feature chunk and intent, from the plan."""
        return dict(tile_rows=seq.tile_rows or 256,
                    tile_out_h=seq.tile_out_h or 8,
                    tile_out_w=seq.tile_out_w or 8,
                    f_chunk=plan.device.f_chunk,
                    differentiable=plan.differentiable)

    if mode == "brainslug":
        # Generate once: one forward + backward executable per sequence,
        # shared by equivalent sequences across stacks.
        for sub, seq in zip(subprograms, plan.sequences):
            fused_ops.get_executable(sub, **geometry(seq))

    def run_body(inputs: Mapping[str, torch.Tensor],
                 params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        env = dict(inputs)
        for sub, seq in zip(subprograms, plan.sequences):
            out = fused_ops.fused_stack_apply(
                sub, {k: env[k] for k in sub.inputs}, params, mode=mode,
                **geometry(seq))
            env.update(out)
        return {v: env[v] for v in plan.program.outputs}

    _cache_put(key, run_body)
    return run_body


#: KERNEL attrs that locate operands rather than shape the computation.
_KERNEL_PLUMBING_ATTRS = frozenset({"slots", "kernel"})


def kernel_inner(op: ir.OpNode, *, backend: registry_mod.KernelType,
                 cache_size: int | None = None) -> Callable:
    """The positional closure of one KERNEL op on ``backend``, cached on
    the kernel, the backend and the static attrs, so identical kernel sites
    share one entry.  Each call counts ``<kernel>_hopper`` (the kernel
    launched on a CUDA tensor), ``<kernel>_plain`` (its wrapper on a CPU
    tensor, which runs the kernel's plain version) or ``<kernel>_ref`` in
    ``registry.STATS``.  The autotuner calls it directly to time ``hopper``
    against ``ref`` on the same operands before it commits a dispatch."""
    if cache_size is not None:
        _raise_cache_limit_to(cache_size)
    entry = registry_mod.get(op.attrs["kernel"])
    static = {k: v for k, v in op.attrs.items()
              if k not in _KERNEL_PLUMBING_ATTRS}
    key = ("kernel", entry.name, backend.value, ir._freeze(static))
    inner = _cache_get(key)
    if inner is not None:
        return inner
    out_shape = tuple(op.attrs["out_shape"])
    out_dtype = op.attrs["out_dtype"]
    hopper = backend is registry_mod.KernelType.HOPPER
    call = entry.hopper if hopper else entry.ref

    def inner(*arrays):
        kind = ("ref" if not hopper else
                "hopper" if arrays[0].is_cuda else "plain")
        registry_mod.STATS.record(f"{entry.name}_{kind}")
        return call(list(arrays), static).reshape(out_shape).to(out_dtype)

    _cache_put(key, inner)
    return inner


def compile_kernel_op(op: ir.OpNode, *, mode: str = "xla",
                      cache_size: int | None = None,
                      backend: registry_mod.KernelType | None = None,
                      reason: str | None = None
                      ) -> tuple[Executor, registry_mod.KernelDispatch]:
    """Compile one registry KERNEL op; returns (executor, dispatch record).
    The backend (the hand-written kernel or its plain version) is decided
    here, once, from the traced shapes and the mode, and returned so that
    ``report()`` shows a fallback.  An explicit ``backend`` (with its
    ``reason``) overrides the static planner: the autotuner's measured
    dispatch arrives through it."""
    if backend is None:
        dispatch = registry_mod.plan_dispatch(op, mode)
    else:
        dispatch = registry_mod.KernelDispatch(op.attrs["kernel"], backend,
                                               reason)
    inner = kernel_inner(op, backend=dispatch.backend, cache_size=cache_size)

    def executor(inputs: Mapping[str, torch.Tensor],
                 params: Mapping[str, torch.Tensor]
                 ) -> dict[str, torch.Tensor]:
        return {op.output: inner(*registry_mod.slot_tensors(op, inputs,
                                                            params))}

    return executor, dispatch


def clear_cache() -> None:
    """Drop every compiled executor and zero the dispatch counters."""
    _CODE_CACHE.clear()
    fused_ops.clear_executable_cache()
    fused_ops.STATS.reset()
    registry_mod.STATS.reset()
