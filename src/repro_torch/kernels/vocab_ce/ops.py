"""Differentiable dispatch for the fused vocab cross-entropy, ported from
``repro/kernels/vocab_ce/ops.py``.

The forward runs the depth-first kernel (:func:`ce.fused_ce_fwd`); the
backward recomputes the logits in :data:`CHUNK_V`-column chunks against
the saved logsumexp, so the ``(T, V)`` logits are never stored.  The JAX
package computes these backwards with ``lax.scan`` outside any Pallas
kernel; here they are a Python loop of ``torch.matmul`` over the chunks,
``dh`` accumulated in float32 and each chunk's ``dw`` columns written once.

``STATS`` counts the forward dispatches: ``kernel`` (a CUDA tensor, the
CUDA kernel) or ``plain`` (a CPU tensor, its plain version).  The backward
runs under the profiler range ``vocab_ce.backward``, which a trace reads
as the chunked backward's device time.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.profiler

from repro_torch.kernels.fused_stack.ops import DispatchStats
from repro_torch.kernels.vocab_ce import ce as kernel_mod
from repro_torch.layers import base

STATS = DispatchStats(keys=("kernel", "plain"))

#: Vocab columns a chunk of the recomputing backward (the Pallas wrapper's
#: ``block_v``).
CHUNK_V = 512


def _forward(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    STATS.record("kernel" if h.is_cuda else "plain")
    return kernel_mod.fused_ce_fwd(h, w, labels)


def _chunked_bwd(h: torch.Tensor, w: torch.Tensor, lse: torch.Tensor,
                 dlogits_of: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dh, dw)`` in h's and w's dtypes, from ``dlogits_of(cols, p)``:
    the cotangent of one chunk's logits given its column ids and softmax
    probabilities ``exp(logits - lse)``."""
    t, d = h.shape
    v = w.shape[1]
    with torch.profiler.record_function("vocab_ce.backward"):
        hf = h.float()
        dh = torch.zeros((t, d), dtype=torch.float32, device=h.device)
        dw = torch.empty((d, v), dtype=torch.float32, device=h.device)
        for lo in range(0, v, CHUNK_V):
            hi = min(lo + CHUNK_V, v)
            wc = w[:, lo:hi].float()
            p = torch.exp(hf @ wc - lse[:, None])
            cols = torch.arange(lo, hi, device=h.device)[None, :]
            dlogits = dlogits_of(cols, p)
            dh += dlogits @ wc.T
            dw[:, lo:hi] = hf.T @ dlogits
        return dh.to(h.dtype), dw.to(w.dtype)


class _FusedNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels):
        lse, gold = _forward(h, w, labels)
        mask = (labels >= 0).float()
        denom = torch.clamp_min(mask.sum(), 1.0)
        ctx.save_for_backward(h, w, labels, lse, mask, denom)
        return torch.sum((lse - gold) * mask) / denom

    @staticmethod
    def backward(ctx, g):
        """d nll / d logits = (softmax - onehot) * mask / denom."""
        h, w, labels, lse, mask, denom = ctx.saved_tensors
        scale = (g * mask / denom).float()[:, None]
        safe = torch.clamp_min(labels, 0)[:, None]
        valid = (labels >= 0)[:, None]

        def dlogits(cols, p):
            onehot = ((cols == safe) & valid).float()
            return (p - onehot) * scale

        dh, dw = _chunked_bwd(h, w, lse, dlogits)
        return dh, dw, None


class _FusedGoldLogp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels):
        v = w.shape[1]
        wrapped = torch.where(labels < 0, labels + v, labels)
        lse, gold = _forward(h, w, wrapped)
        ctx.save_for_backward(h, w, wrapped, lse)
        return gold - lse

    @staticmethod
    def backward(ctx, g):
        """d logp / d logits = onehot - softmax, scaled per token by g."""
        h, w, wrapped, lse = ctx.saved_tensors
        scale = g.float()[:, None]
        gold = wrapped[:, None]

        def dlogits(cols, p):
            return ((cols == gold).float() - p) * scale

        dh, dw = _chunked_bwd(h, w, lse, dlogits)
        return dh, dw, None


def fused_nll(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
              ) -> torch.Tensor:
    """Mean masked NLL (labels < 0 masked) of ``(T, D)`` hidden states
    against a ``(D, V)`` head, a float32 scalar; ``h`` and ``w`` meet in
    their promoted dtype (a float32 ``h`` against a bf16 head runs the
    float32 kernel, and ``w``'s gradient comes back in bf16)."""
    h, w = base.promote(h, w)
    return _FusedNll.apply(h, w, labels)


def fused_gold_logp(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Per-token ``log_softmax(h @ w)[t, labels[t]]`` (T,) in float32;
    negative labels wrap python-style, as ``jnp.take_along_axis`` does."""
    return _FusedGoldLogp.apply(h, w, labels)
