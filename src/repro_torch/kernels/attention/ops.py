"""Dispatch for the attention kernels, ported from
``repro/kernels/attention/ops.py``.  Flash attention is differentiable: the
kernel forward, and a backward that recomputes through the plain oracle
(:func:`ref.attention_ref`) and differentiates it, as the JAX package's
``jax.vjp`` of the reference does (it has no backward kernel); the forward
saves only q, k and v; the backward runs under the profiler range
``flash_attention.backward``.  The decode kernels are inference only.

``STATS`` counts the decode dispatches of :mod:`repro_torch.layers.attention`
per call: ``decode_kernel`` (``brainslug`` on a CUDA tensor, the CUDA
kernel), ``decode_plain`` (``brainslug`` on a CPU tensor, the kernel's
plain version) and ``decode_ref`` (``xla``/``barrier``, the oracle), and
the same three for the paged layout (``paged_decode_*``).  A serving run
diffs them around its dispatches (``STATS.delta(before)``).
"""
from __future__ import annotations

import torch
import torch.profiler

from repro_torch.kernels.attention import decode as decode_mod
from repro_torch.kernels.attention import flash as flash_mod
from repro_torch.kernels.attention import ref as ref_mod
from repro_torch.kernels.fused_stack.ops import DispatchStats

STATS = DispatchStats(keys=("decode_kernel", "decode_plain", "decode_ref",
                            "paged_decode_kernel", "paged_decode_plain",
                            "paged_decode_ref"))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, scale):
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v)
        return flash_mod.flash_attention_fwd(q, k, v, causal=causal,
                                             scale=scale, block_q=block_q,
                                             block_k=block_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad(), torch.profiler.record_function(
                "flash_attention.backward"):
            xs = [t.detach().requires_grad_() for t in (q, k, v)]
            o = ref_mod.attention_ref(*xs, causal=ctx.causal, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(o, xs, g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128, scale: float | None = None
                    ) -> torch.Tensor:
    """Flash forward and reference-recompute backward; ``scale`` overrides
    ``1/sqrt(head_dim)``."""
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k, scale)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, block_k: int = 512,
                 max_keys: int | None = None) -> torch.Tensor:
    """Inference only: one query position against a dense cache
    (``max_keys``: the caller's host bound on the lengths, which picks the
    kernel's plan)."""
    STATS.record("decode_kernel" if q.is_cuda else "decode_plain")
    return decode_mod.flash_decode(q, k, v, lengths, block_k=block_k,
                                   max_keys=max_keys)


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, table: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Inference only: one query position against a block-mapped pool."""
    STATS.record("paged_decode_kernel" if q.is_cuda else "paged_decode_plain")
    return decode_mod.paged_flash_decode(q, k_pool, v_pool, table, lengths)
