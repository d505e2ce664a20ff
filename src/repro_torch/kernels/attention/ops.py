"""Dispatch for the attention kernels (forward only: the
reference-recompute backward of flash attention comes with LM training).

``STATS`` counts the decode dispatches of :mod:`repro_torch.layers.attention`
per call: ``decode_kernel`` (``brainslug`` on a CUDA tensor, the CUDA
kernel), ``decode_plain`` (``brainslug`` on a CPU tensor, the kernel's
plain version) and ``decode_ref`` (``xla``/``barrier``, the oracle), and
the same three for the paged layout (``paged_decode_*``).  A serving run
diffs them around its dispatches (``STATS.delta(before)``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import decode as decode_mod
from repro_torch.kernels.attention import flash as flash_mod
from repro_torch.kernels.fused_stack.ops import DispatchStats

STATS = DispatchStats(keys=("decode_kernel", "decode_plain", "decode_ref",
                            "paged_decode_kernel", "paged_decode_plain",
                            "paged_decode_ref"))


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


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, table: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Inference only: one query position against a block-mapped pool."""
    STATS.record("paged_decode_kernel" if q.is_cuda else "paged_decode_plain")
    return decode_mod.paged_flash_decode(q, k_pool, v_pool, table, lengths)
