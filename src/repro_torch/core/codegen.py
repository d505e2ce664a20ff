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

Under a mesh (``mesh`` plus an active ``part``, a
:class:`~repro_torch.core.partition.SegmentPartition`) the executor runs
inside a *sharded call* (:func:`sharded_call`), the SPMD form of the JAX
package's ``shard_map`` region: every rank holds the global operands,
slices its own shard of each by its spec, runs the plan (the fused-stack
kernels, or the registry kernel) on it and all-gathers each output along
its sharded dims, so the executor keeps the global dict-in/dict-out
contract.  The mesh identity and the specs join the cache key.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Mapping

import torch

from repro_torch.core import ir
from repro_torch.core import collapse as collapse_mod
from repro_torch.core import registry as registry_mod
from repro_torch.core import verify as verify_mod
from repro_torch.distributed import collectives
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


def _reduce_replicated(ct: torch.Tensor, axes: set, mesh) -> torch.Tensor:
    """Sum a cotangent's per-rank partials over ``axes`` (the axes the
    outputs shard and its operand does not)."""
    return collectives.all_reduce_axes(ct, mesh, axes)


class _ShardedCall(torch.autograd.Function):
    """One sharded call: slice, run the body on this rank's shards, gather.

    Backward: the body's local VJP on this rank's shard of the output
    cotangents (the local graph is kept from the forward: unlike a
    ``shard_map`` region, it can be differentiated in place, so nothing
    runs twice); then each operand's cotangent is summed over the axes the
    outputs shard and the operand does not (a replicated parameter's
    partial products become total) and gathered along its own sharded
    dims back to its global shape."""

    @staticmethod
    def forward(ctx, call, *arrays):
        mesh, in_specs, out_specs = call.mesh, call.in_specs, call.out_specs
        local = [collectives.shard(a, s, mesh)
                 for a, s in zip(arrays, in_specs)]
        grad = any(ctx.needs_input_grad[1:])
        if grad:
            local = [t.detach().requires_grad_(need and t.is_floating_point())
                     for t, need in zip(local, ctx.needs_input_grad[1:])]
        with torch.set_grad_enabled(grad):
            outs = call.body(*local)
        if grad:
            ctx.call, ctx.local, ctx.outs = call, local, outs
        return tuple(collectives.gather(o.detach(), s, mesh)
                     for o, s in zip(outs, out_specs))

    @staticmethod
    def backward(ctx, *gouts):
        call = ctx.call
        mesh = call.mesh
        wants = [t for t in ctx.local if t.requires_grad]
        pairs = [(o, collectives.shard(g, s, mesh))
                 for o, g, s in zip(ctx.outs, gouts, call.out_specs)
                 if g is not None and o.requires_grad]
        cts = torch.autograd.grad([o for o, _ in pairs],
                                  wants, [g for _, g in pairs],
                                  allow_unused=True) if pairs else ()
        got = dict(zip(map(id, wants), cts))
        out_axes = set().union(*(collectives.spec_mesh_axes(s)
                                 for s in call.out_specs))
        result = [None]
        for t, spec in zip(ctx.local, call.in_specs):
            ct = got.get(id(t))
            if ct is None:
                result.append(None)
                continue
            ct = _reduce_replicated(
                ct.contiguous(), out_axes - collectives.spec_mesh_axes(spec),
                mesh)
            result.append(collectives.gather(ct, spec, mesh))
        del ctx.call, ctx.local, ctx.outs
        return tuple(result)


class sharded_call:
    """``call(*arrays) -> tuple`` of ``body`` under ``mesh``: the positional
    operands carry ``in_specs``, the outputs ``out_specs`` (see
    :class:`_ShardedCall`).  Differentiable; ``body`` returns a tuple."""

    def __init__(self, mesh, body: Callable, in_specs, out_specs):
        self.mesh, self.body = mesh, body
        self.in_specs, self.out_specs = tuple(in_specs), tuple(out_specs)

    def __call__(self, *arrays):
        return _ShardedCall.apply(self, *arrays)


def _dist_key(mesh, part) -> tuple | None:
    """Mesh identity and boundary specs: a plan wrapped for another mesh
    (or unwrapped) must not share a closure."""
    if mesh is None or part is None or not part.active:
        return None
    return (id(mesh), tuple(sorted(
        (k, tuple(s)) for k, s in (*part.in_specs.items(),
                                   *part.out_specs.items(),
                                   *part.param_specs.items()))))


def compile_plan(plan: collapse_mod.CollapsePlan, *, mode: str = "xla",
                 cache_size: int | None = None,
                 mesh=None, part=None) -> Executor:
    """Compile a collapse plan into ``executor(inputs, params) -> outputs``.
    In ``xla`` mode each sequence runs compiled, one compiled callable a
    sequence signature (:func:`~repro_torch.kernels.fused_stack.ops.
    xla_callable`), built at its first call.

    With ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) and an active
    ``part``, the plan (collapsed against the per-shard shapes) runs inside
    a :class:`sharded_call` with the partition's boundary specs."""
    if cache_size is not None:
        _raise_cache_limit_to(cache_size)
    dist_key = _dist_key(mesh, part)
    key = (plan.program.signature(), mode, plan.input_shapes,
           tuple((s.tile_rows, s.tile_out_h, s.tile_out_w)
                 for s in plan.sequences),
           plan.device.f_chunk, plan.differentiable, dist_key)
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

    if dist_key is None:
        _cache_put(key, run_body)
        return run_body

    in_names = tuple(plan.program.inputs)
    param_names = tuple(part.param_specs)
    out_names = tuple(plan.program.outputs)

    def positional(*arrays):
        out = run_body(dict(zip(in_names, arrays)),
                       dict(zip(param_names, arrays[len(in_names):])))
        return tuple(out[v] for v in out_names)

    call = sharded_call(
        mesh, positional,
        in_specs=(tuple(part.in_specs[v] for v in in_names)
                  + tuple(part.param_specs[p] for p in param_names)),
        out_specs=tuple(part.out_specs[v] for v in out_names))

    def executor(inputs: Mapping[str, torch.Tensor],
                 params: Mapping[str, torch.Tensor]
                 ) -> dict[str, torch.Tensor]:
        outs = call(*[inputs[v] for v in in_names],
                    *[params[p] for p in param_names])
        return dict(zip(out_names, outs))

    _cache_put(key, executor)
    return executor


def _unknown_kernel_error(op: ir.OpNode) -> verify_mod.VerifyError:
    """A bare KeyError from inside codegen names nothing: raise the
    verifier's error, naming the op and the invariant."""
    return verify_mod.VerifyError([verify_mod.Finding(
        "kernel.unknown", "error", op.name,
        f"kernel id {op.attrs.get('kernel')!r} has no registry entry "
        f"(known: {sorted(registry_mod.REGISTRY)})")])


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
    if op.attrs.get("kernel") not in registry_mod.REGISTRY:
        raise _unknown_kernel_error(op)
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
                      reason: str | None = None, mesh=None, part=None
                      ) -> tuple[Executor, registry_mod.KernelDispatch]:
    """Compile one registry KERNEL op; returns (executor, dispatch record).
    The backend (the hand-written kernel or its plain version) is decided
    here, once, from the traced shapes and the mode, and returned so that
    ``report()`` shows a fallback.  An explicit ``backend`` (with its
    ``reason``) overrides the static planner: the autotuner's measured
    dispatch arrives through it.

    With ``mesh`` and an active ``part`` the kernel closure, compiled
    against the per-shard shapes, runs inside a :class:`sharded_call` with
    the partition's per-slot specs; the unwrapped closure stays shared
    with single-device compiles."""
    if op.attrs.get("kernel") not in registry_mod.REGISTRY:
        raise _unknown_kernel_error(op)
    if backend is None:
        dispatch = registry_mod.plan_dispatch(op, mode)
    else:
        dispatch = registry_mod.KernelDispatch(op.attrs["kernel"], backend,
                                               reason)
    dist_key = _dist_key(mesh, part)
    if dist_key is None:
        inner = kernel_inner(op, backend=dispatch.backend,
                             cache_size=cache_size)
    else:
        n_slots = len(op.attrs["slots"])
        shard_op = dataclasses.replace(op, attrs={
            **op.attrs,
            "arg_shapes": tuple(tuple(part.shard_shapes[f"arg{i}"])
                                for i in range(n_slots)),
            "out_shape": tuple(part.shard_shapes[op.output])})
        shard_inner = kernel_inner(shard_op, backend=dispatch.backend,
                                   cache_size=cache_size)
        key = ("kernel-sharded", dispatch.backend.value,
               ir._freeze({k: v for k, v in shard_op.attrs.items()
                           if k not in _KERNEL_PLUMBING_ATTRS}), dist_key)
        call = _cache_get(key)
        if call is None:
            call = sharded_call(
                mesh, lambda *arrays: (shard_inner(*arrays),),
                in_specs=tuple(part.in_specs[f"arg{i}"]
                               for i in range(n_slots)),
                out_specs=(part.out_specs[op.output],))
            _cache_put(key, call)
        inner = lambda *arrays: call(*arrays)[0]  # noqa: E731

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
