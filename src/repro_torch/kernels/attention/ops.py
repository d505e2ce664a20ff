"""Dispatch for the attention kernels (forward only: the
reference-recompute backward of flash attention comes with LM training).

``STATS`` counts the decode dispatches of :mod:`repro_torch.layers.attention`
per call: ``decode_kernel`` (``brainslug`` on a CUDA tensor, the CUDA
kernel), ``decode_plain`` (``brainslug`` on a CPU tensor, the kernel's
plain version) and ``decode_ref`` (``xla``/``barrier``, the oracle).  A
serving run diffs them around its dispatches (``STATS.delta(before)``).
``paged_flash_decode`` and its counters come with the serving engine.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import decode as decode_mod
from repro_torch.kernels.attention import flash as flash_mod
from repro_torch.kernels.fused_stack.ops import DispatchStats

STATS = DispatchStats(keys=("decode_kernel", "decode_plain", "decode_ref"))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128, scale: float | None = None
                    ) -> torch.Tensor:
    """Flash forward; ``scale`` overrides ``1/sqrt(head_dim)``."""
    return flash_mod.flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                         block_q=block_q, block_k=block_k)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, block_k: int = 512
                 ) -> torch.Tensor:
    """Inference only: one query position against a dense cache."""
    STATS.record("decode_kernel" if q.is_cuda else "decode_plain")
    return decode_mod.flash_decode(q, k, v, lengths, block_k=block_k)
