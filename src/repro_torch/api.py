"""Public BrainSlug API of the port: ``repro_torch.api``.

The paper's promise is transparency: ``brainslug.optimize(model)`` on an
unmodified network (Listing 3).  This facade keeps it for plain PyTorch
functions:

    from repro_torch import api

    net = api.optimize(fn, *example_args,
                       config=api.OptimizeConfig(mode="brainslug"))
    y = net(*args)          # same signature and output pytree as fn
    print(net.explain())    # ops captured vs left opaque, kernels, traffic

``optimize`` traces the callable into the BrainSlug IR
(:mod:`repro_torch.core.trace`), rewrites attention / rmsnorm / swiglu /
vocab-CE clusters onto the dedicated kernels (:mod:`repro_torch.core.
registry`), partitions the graph into opaque segments and optimizable
stacks, collapses each stack against the device budget, and returns a
drop-in callable.  With ``config.differentiable=True`` ``torch.autograd``
runs through it: the stacks through the generated depth-first backward
kernels, the kernels through their wrappers' backwards, opaque ops
through eager autograd.

The result runs on ``cuda`` unless the config asks for ``cpu``.  Under
``OptimizeConfig(mesh=..., partition=...)`` every rank of the mesh calls
``optimize`` and the result with the same global arguments; stacks and
registry kernels run on each rank's shard and gather their outputs
(:mod:`repro_torch.core.partition`).  The
IR-level entry points stay in :mod:`repro_torch.core.api`; the
:func:`optimize_graph` and :func:`optimize_stack` here are deprecated
re-exports that warn.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from repro_torch.core import analyzer, codegen, collapse, ir
from repro_torch.core import api as core_api
from repro_torch.core import autotune as autotune_mod
from repro_torch.core import registry as registry_mod
from repro_torch.core import trace as trace_mod
from repro_torch.core import verify as verify_mod

OptimizeConfig = core_api.OptimizeConfig
CoverageReport = core_api.CoverageReport
AutotuneCoverage = core_api.AutotuneCoverage
StackCoverage = core_api.StackCoverage
KernelCoverage = core_api.KernelCoverage
OptimizedNet = core_api.OptimizedNet
MODES = core_api.MODES
LAYOUTS = core_api.LAYOUTS
TraceResult = trace_mod.TraceResult
KernelType = registry_mod.KernelType
KernelDispatch = registry_mod.KernelDispatch
KernelVeto = registry_mod.KernelVeto

__all__ = [
    "optimize", "OptimizedFn", "OptimizeConfig", "CoverageReport",
    "AutotuneCoverage", "StackCoverage", "KernelCoverage", "KernelType",
    "KernelDispatch", "KernelVeto", "TraceResult", "MODES", "LAYOUTS",
    "optimize_graph", "optimize_stack",
]


@dataclasses.dataclass(eq=False)
class OptimizedFn:
    """A traced and rewritten callable (the paper's optimized model): the
    original function's positional signature and output pytree; collapsed
    stacks run under ``config.mode``, registry kernels on their dispatched
    backend, everything else breadth-first as traced."""

    trace_result: trace_mod.TraceResult
    segments: list
    executors: dict[int, codegen.Executor]
    plans: dict[int, collapse.CollapsePlan]
    config: OptimizeConfig
    device: torch.device
    kernel_dispatches: dict[int, registry_mod.KernelDispatch] = \
        dataclasses.field(default_factory=dict)
    kernel_matches: tuple = ()
    kernel_vetoes: tuple = ()
    #: Committed autotune decisions by segment index; -1 is the
    #: function-level floor (the rewrite against the function as given).
    autotune_decisions: dict[int, autotune_mod.Decision] = \
        dataclasses.field(default_factory=dict)
    #: Set when the function-level floor measured the whole rewrite slower
    #: than the function as given: ``__call__`` checks its arguments and
    #: then calls that function.
    passthrough: Callable | None = None
    #: The static verifier's findings (:mod:`repro_torch.core.verify`):
    #: under verify='warn' the waived error findings stay readable here and
    #: in ``report()``; and the host seconds its passes took.
    verify_findings: tuple = ()
    verify_seconds: float = 0.0
    #: The mesh partition plan (None on one device).
    partitions: Any = None

    def __call__(self, *args):
        tr = self.trace_result
        leaves, tree = pytree.tree_flatten(args)
        if tree != tr.in_tree:
            raise TypeError(f"optimized {tr.graph.name!r} was traced with "
                            f"argument structure {tr.in_tree}, called with "
                            f"{tree}")
        for i, (leaf, (shape, dtype)) in enumerate(zip(leaves,
                                                       tr.leaf_avals)):
            got = ((tuple(leaf.shape), leaf.dtype)
                   if isinstance(leaf, torch.Tensor) else None)
            if got != (shape, dtype):
                # every executor is specialised to the traced shapes
                raise TypeError(
                    f"optimized {tr.graph.name!r}: argument leaf {i} was "
                    f"traced as {dtype}{list(shape)}, called with "
                    f"{type(leaf).__name__ if got is None else got}; "
                    f"re-run optimize() for new shapes or dtypes")
        core_api._check_device(self.device, {
            f"arg{i}": leaf for i, leaf in enumerate(leaves)})
        if self.passthrough is not None:
            return self.passthrough(*args)
        env = core_api.run_segments(self.segments, self.executors,
                                    {tr.input_name: leaves[0]},
                                    tr.bind_params(leaves))
        outs = [env[ref] if kind == "env" else
                leaves[ref] if kind == "leaf" else ref
                for kind, ref in tr.out_refs]
        return pytree.tree_unflatten(outs, tr.out_tree)

    @property
    def graph(self) -> ir.NetGraph:
        return self.trace_result.graph

    @property
    def n_stacks(self) -> int:
        return len(self.plans)

    @property
    def n_sequences(self) -> int:
        return sum(len(p.sequences) for p in self.plans.values())

    def report(self) -> CoverageReport:
        """Ops captured vs left opaque, planned HBM traffic per stack, and
        every registry dispatch with the backend that runs (a fallback to
        the plain version, or a match the probe vetoed, is listed with its
        reason)."""
        return core_api.coverage_report(
            self.segments, self.plans, self.trace_result.shapes,
            self.config.itemsize, kernel_dispatch=self.kernel_dispatches,
            vetoes=self.kernel_vetoes,
            autotune_decisions=self.autotune_decisions,
            verify=self.verify_findings, verify_seconds=self.verify_seconds,
            partitions=self.partitions)

    def explain(self) -> str:
        """Human-readable :meth:`report`."""
        return str(self.report())


def optimize(fn: Callable, *example_args: Any,
             config: OptimizeConfig = OptimizeConfig()) -> OptimizedFn:
    """Trace a plain PyTorch callable and rewrite it BrainSlug-style.

    ``example_args`` is any pytree of tensors on the config's device; the
    result is specialised to their shapes and dtypes.  Unrecognised ops
    stay opaque: ``optimize`` never rejects a function, it captures less of
    it (see :meth:`OptimizedFn.report`).

    With ``config.autotune`` every stack and registry kernel is measured
    and floored at its baseline, and then the whole rewrite is floored at
    the function as given (:func:`_floor_whole_function`)."""
    device = core_api.resolve_device(config)
    leaves = pytree.tree_leaves(example_args)
    core_api._check_device(device, {
        f"arg{i}": t for i, t in enumerate(leaves)
        if isinstance(t, torch.Tensor)})
    tr = trace_mod.trace(fn, *example_args)
    matches: tuple = ()
    vetoes: tuple = ()
    if config.kernel_registry:
        tr, matches, vetoes = registry_mod.rewrite(tr, mode=config.mode)
    # every traced output must survive, even one made mid-stack (a stack
    # executor materialises only its declared outputs)
    keep = frozenset(ref for kind, ref in tr.out_refs if kind == "env")
    # graph-level verification (SSA, dead values, recorded shapes) before
    # segmentation; plan and kernel checks run inside compile_stacks,
    # between planning and codegen
    spent = verify_mod.STATS.seconds
    graph_findings: tuple = ()
    if config.verify != "off":
        graph_findings = tuple(verify_mod.verify_trace(tr))
        verify_mod.enforce(graph_findings, config.verify,
                           subject=tr.graph.name)
    segments = analyzer.analyze(tr.graph, layout="auto", keep=keep)
    tuner = (autotune_mod.Autotuner.from_config(config)
             if config.autotune and config.partition == "none" else None)
    executors, plans, dispatches, tuned, findings, parts = \
        core_api.compile_stacks(
            segments, tr.shapes, config, param_shapes=tr.param_shapes,
            dtypes={**tr.dtypes, **tr.param_dtypes}, tuner=tuner)
    net = OptimizedFn(trace_result=tr, segments=segments,
                      executors=executors, plans=plans, config=config,
                      device=device, kernel_dispatches=dispatches,
                      kernel_matches=matches, kernel_vetoes=vetoes,
                      autotune_decisions=tuned,
                      verify_findings=graph_findings + findings,
                      verify_seconds=verify_mod.STATS.seconds - spent,
                      partitions=parts)
    if tuner is not None and parts is None:
        _floor_whole_function(tuner, net, fn, example_args, config)
    return net


def _sig_value(v):
    """Stable attr freeze for cache keys: opaque ops hold replay closures
    whose default repr embeds a memory address — key on their qualname."""
    if isinstance(v, (list, tuple)):
        return tuple(_sig_value(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _sig_value(x)) for k, x in v.items()))
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype))
    if callable(v):
        return getattr(v, "__qualname__", type(v).__name__)
    return ir._freeze(v)


def _graph_signature(graph: ir.NetGraph) -> str:
    return repr(tuple(
        (op.kind.value, op.fn, op.inputs, op.output, op.params,
         tuple(sorted((k, _sig_value(v)) for k, v in op.attrs.items())))
        for op in graph.ops))


def _floor_whole_function(tuner, net: OptimizedFn, fn: Callable,
                          example_args: tuple,
                          config: OptimizeConfig) -> None:
    """The end-to-end guardrail: time the whole rewritten callable
    (``optimized``) against ``raw``, the user's function as given: the
    eager PyTorch they would run without ``optimize``.  When the rewrite
    loses, ``net`` delegates to the function (per-segment wins do not
    always survive end to end).  On the card an error of the rewrite
    propagates (it runs the hand-written kernels); elsewhere it is
    recorded and the function as given is kept."""
    tr = net.trace_result
    key_obj = {
        "kind": "function", "name": tr.graph.name,
        "sig": _graph_signature(tr.graph),
        "avals": [[list(s), str(d)] for s, d in tr.leaf_avals],
        "mode": config.mode,
        "differentiable": config.differentiable,
        "kernel_registry": config.kernel_registry,
        "torch_device": autotune_mod.device_key(net.device),
    }

    def optimized() -> list:
        net(*example_args)              # anything still to build, untimed
        return [("fwd", net, example_args)]

    builders = {"raw": lambda: [("fwd", fn, example_args)],
                "optimized": optimized}
    decision = tuner.decide(
        key_obj, kind="function", name=tr.graph.name,
        requested="optimized", baseline="raw", builders=builders,
        must_run=autotune_mod.hand_written({"optimized": config.mode},
                                           net.device))
    net.autotune_decisions[-1] = decision
    if decision.variant == "raw":
        net.passthrough = fn


# ---------------------------------------------------------------------------
# Deprecated IR-level entry points (repro_torch.core.api keeps them).
# ---------------------------------------------------------------------------

def optimize_graph(*args, **kwargs) -> core_api.OptimizedNet:
    """Deprecated: use :func:`optimize` on a plain PyTorch function."""
    warnings.warn(
        "repro_torch.api.optimize_graph is deprecated and will be removed "
        "from this namespace; use repro_torch.api.optimize(fn, "
        "*example_args), which traces plain PyTorch functions "
        "(repro_torch.core.api.optimize_graph remains for IR-level code).",
        DeprecationWarning, stacklevel=2)
    return core_api.optimize_graph(*args, **kwargs)


def optimize_stack(*args, **kwargs) -> codegen.Executor:
    """Deprecated: use :func:`optimize` on a plain PyTorch function."""
    warnings.warn(
        "repro_torch.api.optimize_stack is deprecated and will be removed "
        "from this namespace; use repro_torch.api.optimize(fn, "
        "*example_args), which traces plain PyTorch functions "
        "(repro_torch.core.api.optimize_stack remains for IR-level code).",
        DeprecationWarning, stacklevel=2)
    return core_api.optimize_stack(*args, **kwargs)
