"""Differentiable dispatch for the fused GLU gate, ported from
``repro/kernels/swiglu/ops.py``: the kernel forward, and a backward that
recomputes through the plain oracle (:func:`ref.swiglu_ref`) and
differentiates it, as the JAX package's ``jax.vjp`` of the reference does
(it has no backward kernel).  The forward saves only its inputs."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_stack.ops import DispatchStats
from repro_torch.kernels.swiglu import ref as ref_mod
from repro_torch.kernels.swiglu import swiglu as kernel_mod

#: Per call: ``kernel`` (a CUDA tensor, the Triton kernel) or ``plain`` (a
#: CPU tensor, its plain version).
STATS = DispatchStats(keys=("kernel", "plain"))

#: Gate activations the fused kernel implements.
ACTS = tuple(kernel_mod.ACT_IDS)


class _Swiglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up, act):
        ctx.act = act
        ctx.save_for_backward(gate, up)
        STATS.record("kernel" if gate.is_cuda else "plain")
        return kernel_mod.swiglu_fwd(gate, up, act=act)

    @staticmethod
    def backward(ctx, g):
        gate, up = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (gate, up)]
            y = ref_mod.swiglu_ref(*xs, act=ctx.act)
            dgate, dup = torch.autograd.grad(y, xs, g)
        return dgate, dup, None


def swiglu(gate: torch.Tensor, up: torch.Tensor, act: str = "silu"
           ) -> torch.Tensor:
    """``act(gate) * up``: the kernel on a CUDA tensor, the plain version on
    a CPU one; differentiable in both."""
    return _Swiglu.apply(gate, up, act)
