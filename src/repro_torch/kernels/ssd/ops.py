"""Differentiable dispatch for the SSD mixer, ported from
``repro/kernels/ssd/ops.py``.

The forward is :func:`chunked.ssd_chunked` (padding, the ``dt * x`` and
cumulative-decay prologue, the inter-chunk loop, ``y_inter`` and ``D * x``)
with the intra-chunk kernel (:func:`ssd.ssd_intra_chunk`) as its
intra-chunk step.  The backward recomputes through ``ssd_chunked`` with the
plain step under autograd, as the JAX package's ``jax.vjp`` of
``ssd_chunked`` does (it has no backward kernel).

``STATS`` counts the forward dispatches: ``kernel`` (a CUDA tensor, the
CUDA kernel) or ``plain`` (a CPU tensor, its plain version).  The backward
runs under the profiler range ``ssd.backward``, which a trace reads as the
recomputing backward's device time.
"""
from __future__ import annotations

import torch
import torch.profiler

from repro_torch.kernels.fused_stack.ops import DispatchStats
from repro_torch.kernels.ssd import chunked as chunked_mod
from repro_torch.kernels.ssd import ssd as kernel_mod

STATS = DispatchStats(keys=("kernel", "plain"))


def _forward(x, dt, A, B, C, D, chunk: int) -> torch.Tensor:
    STATS.record("kernel" if x.is_cuda else "plain")
    return chunked_mod.ssd_chunked(x, dt, A, B, C, D, chunk=chunk,
                                   intra=kernel_mod.ssd_intra_chunk)


class _Ssd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C, D)
        return _forward(x, dt, A, B, C, D, chunk)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad[:6]
        with torch.profiler.record_function("ssd.backward"), \
                torch.enable_grad():
            leaves = [None if t is None else
                      t.detach().requires_grad_(w)
                      for t, w in zip(saved, want)]
            y = chunked_mod.ssd_chunked(*leaves, chunk=ctx.chunk)
            wrt = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, gy)) if wrt else iter(())
        return (*(next(grads) if t is not None and t.requires_grad else None
                  for t in leaves), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: torch.Tensor | None = None, chunk: int = 64
        ) -> torch.Tensor:
    """The SSD mixer with the intra-chunk kernel: x (b,s,h,p), dt (b,s,h),
    A (h,), B/C (b,s,n), D (h,) or None -> y (b,s,h,p) in x's dtype;
    differentiable in every tensor argument.  The kernel on a CUDA tensor,
    its plain version on a CPU one."""
    return _Ssd.apply(x, dt, A, B, C, D, chunk)
