"""Differentiable dispatch for fused residual + RMSNorm, ported from
``repro/kernels/rmsnorm/ops.py``: the kernel forward, and a backward that
recomputes through the plain oracle (:func:`ref.rmsnorm_ref`) and
differentiates it, as the JAX package's ``jax.vjp`` of the reference does
(it has no backward kernel).  The forward saves only its inputs."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_stack.ops import DispatchStats
from repro_torch.kernels.rmsnorm import ref as ref_mod
from repro_torch.kernels.rmsnorm import rmsnorm as kernel_mod

#: Per call: ``kernel`` (a CUDA tensor, the Triton kernel) or ``plain`` (a
#: CPU tensor, its plain version).
STATS = DispatchStats(keys=("kernel", "plain"))


def _dispatch(x, scale, residual, eps):
    STATS.record("kernel" if x.is_cuda else "plain")
    return kernel_mod.rmsnorm_fwd(x, scale, residual, eps=eps)


class _RmsNorm(torch.autograd.Function):
    """Without a residual: ``y`` (``h`` is ``x`` itself)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return _dispatch(x, scale, None, eps)[0]

    @staticmethod
    def backward(ctx, gy):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (x, scale)]
            y, _ = ref_mod.rmsnorm_ref(*xs, None, eps=ctx.eps)
            dx, ds = torch.autograd.grad(y, xs, gy)
        return dx, ds, None


class _AddRmsNorm(torch.autograd.Function):
    """With a residual: ``(y, h)``, both taking cotangents."""

    @staticmethod
    def forward(ctx, x, scale, residual, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, residual)
        return _dispatch(x, scale, residual, eps)

    @staticmethod
    def backward(ctx, gy, gh):
        x, scale, residual = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (x, scale, residual)]
            y, h = ref_mod.rmsnorm_ref(xs[0], xs[1], xs[2], eps=ctx.eps)
            dx, ds, dr = torch.autograd.grad((y, h), xs, (gy, gh))
        return dx, ds, dr, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            residual: torch.Tensor | None = None, eps: float = 1e-6
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, h)``: the kernel on a CUDA tensor, the plain version on a CPU
    one; differentiable in ``x``, ``scale`` and ``residual``."""
    if residual is None:
        return _RmsNorm.apply(x, scale, eps), x
    return _AddRmsNorm.apply(x, scale, residual, eps)
