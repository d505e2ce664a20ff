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

The result runs on ``cuda`` unless the config asks for ``cpu``.  The
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
from repro_torch.core import registry as registry_mod
from repro_torch.core import trace as trace_mod

OptimizeConfig = core_api.OptimizeConfig
CoverageReport = core_api.CoverageReport
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
    "StackCoverage", "KernelCoverage", "KernelType", "KernelDispatch",
    "KernelVeto", "TraceResult", "MODES", "LAYOUTS", "optimize_graph", "optimize_stack",
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
            vetoes=self.kernel_vetoes)

    def explain(self) -> str:
        """Human-readable :meth:`report`."""
        return str(self.report())


def optimize(fn: Callable, *example_args: Any,
             config: OptimizeConfig = OptimizeConfig()) -> OptimizedFn:
    """Trace a plain PyTorch callable and rewrite it BrainSlug-style.

    ``example_args`` is any pytree of tensors on the config's device; the
    result is specialised to their shapes and dtypes.  Unrecognised ops
    stay opaque: ``optimize`` never rejects a function, it captures less of
    it (see :meth:`OptimizedFn.report`)."""
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
    segments = analyzer.analyze(tr.graph, layout="auto", keep=keep)
    executors, plans, dispatches = core_api.compile_stacks(
        segments, tr.shapes, config)
    return OptimizedFn(trace_result=tr, segments=segments,
                       executors=executors, plans=plans, config=config,
                       device=device, kernel_dispatches=dispatches,
                       kernel_matches=matches, kernel_vetoes=vetoes)


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
