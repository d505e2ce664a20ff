"""BrainSlug stack integration for the LM blocks.

Each block's non-matmul chain is declared once as a
:class:`~repro_torch.core.ir.StackProgram` and executed through the
BrainSlug dispatcher.  The mode (``RuntimeConfig.mode``) selects the
schedule, with the JAX package's routing:

* ``brainslug`` — the dedicated kernels where an idiom is recognised
  (residual + rms norm without bias: the rmsnorm kernel; a GLU gate with
  silu, gelu or squared_relu: the swiglu kernel), the generated fused-stack
  kernel otherwise (float32 or bfloat16);
* ``xla``       — the eager interpreter;
* ``barrier``   — the interpreter with every op output materialised.

A norm's scale and bias enter in the promoted dtype of the stream and
themselves (:func:`repro_torch.layers.base.promote`): a float32 stream
over bf16 parameters normalises in float32, as jnp's arithmetic does.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import ir
from repro_torch.kernels.fused_stack import ops as fused_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.swiglu import ops as swiglu_ops
from repro_torch.layers import base


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


# ---------------------------------------------------------------------------
# Dispatchers.  In 'brainslug' mode the recognised idioms go to their
# dedicated kernels; everything else goes through the generic fused kernel.
# ---------------------------------------------------------------------------

def add_norm(x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor | None, *, norm: str = "rms",
             eps: float = 1e-6, mode: str = "xla"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused residual add + norm.  Returns (normed, new_residual)."""
    x, residual, scale, bias = base.promote(x, residual, scale, bias)
    if mode == "brainslug" and norm == "rms" and bias is None:
        return rms_ops.rmsnorm(x, scale, residual, eps)
    params = {"scale": scale}
    if bias is not None:
        params["bias"] = bias
    out = fused_ops.fused_stack_apply(
        addnorm_program(norm, eps, bias is not None),
        {"x": x, "res": residual}, params, mode=mode)
    return out["y"], out["h"]


def apply_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None = None, *, norm: str = "rms",
               eps: float = 1e-6, mode: str = "xla") -> torch.Tensor:
    x, scale, bias = base.promote(x, scale, bias)
    if mode == "brainslug" and norm == "rms" and bias is None:
        return rms_ops.rmsnorm(x, scale, None, eps)[0]
    params = {"scale": scale}
    if bias is not None:
        params["bias"] = bias
    return fused_ops.fused_stack_apply(
        norm_program(norm, eps, bias is not None), {"x": x}, params,
        mode=mode)["y"]


def glu(gate: torch.Tensor, up: torch.Tensor, *, act: str = "silu",
        mode: str = "xla") -> torch.Tensor:
    if mode == "brainslug" and act in swiglu_ops.ACTS:
        return swiglu_ops.swiglu(gate, up, act)
    return fused_ops.fused_stack_apply(
        glu_program(act), {"gate": gate, "up": up}, {}, mode=mode)["y"]


def activation(x: torch.Tensor, *, act: str, mode: str = "xla"
               ) -> torch.Tensor:
    return fused_ops.fused_stack_apply(act_program(act), {"x": x}, {},
                                       mode=mode)["y"]
