"""BrainSlug stack programs of the LM blocks.

Each block's non-matmul chain is declared once as a
:class:`~repro_torch.core.ir.StackProgram` and run through
:func:`repro_torch.core.api.optimize_stack`.  Only the program constructors are
ported so far; the dispatchers of ``repro.layers.stacks``, which route
recognised idioms to the rmsnorm/swiglu kernels, wait for those kernels.
"""
from __future__ import annotations

import functools

from repro_torch.core import ir


@functools.lru_cache(maxsize=None)
def addnorm_program(norm: str, eps: float, has_bias: bool) -> ir.StackProgram:
    """h = x + res;  y = norm(h) * scale (+ bias)."""
    params = ("scale", "bias") if has_bias else ("scale",)
    return ir.StackProgram(
        name=f"addnorm_{norm}", inputs=("x", "res"), outputs=("y", "h"),
        layout="rows",
        ops=(
            ir.OpNode(ir.OpKind.EW_BINARY, "add", ("x", "res"), "h",
                      fn="add"),
            ir.OpNode(ir.OpKind.ROW_NORM, "norm", ("h",), "y",
                      params=params, attrs={"norm": norm, "eps": eps}),
        ))


@functools.lru_cache(maxsize=None)
def norm_program(norm: str, eps: float, has_bias: bool) -> ir.StackProgram:
    params = ("scale", "bias") if has_bias else ("scale",)
    return ir.StackProgram(
        name=f"norm_{norm}", inputs=("x",), outputs=("y",), layout="rows",
        ops=(ir.OpNode(ir.OpKind.ROW_NORM, "norm", ("x",), "y",
                       params=params, attrs={"norm": norm, "eps": eps}),))


@functools.lru_cache(maxsize=None)
def glu_program(act: str) -> ir.StackProgram:
    """y = act(gate) * up."""
    return ir.StackProgram(
        name=f"glu_{act}", inputs=("gate", "up"), outputs=("y",),
        layout="rows",
        ops=(
            ir.OpNode(ir.OpKind.EW_UNARY, "act", ("gate",), "a", fn=act),
            ir.OpNode(ir.OpKind.EW_BINARY, "mul", ("a", "up"), "y",
                      fn="mul"),
        ))


@functools.lru_cache(maxsize=None)
def act_program(act: str) -> ir.StackProgram:
    return ir.StackProgram(
        name=f"act_{act}", inputs=("x",), outputs=("y",), layout="rows",
        ops=(ir.OpNode(ir.OpKind.EW_UNARY, "act", ("x",), "y", fn=act),))
