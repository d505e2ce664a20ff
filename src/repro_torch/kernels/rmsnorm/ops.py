"""Dispatch for fused residual + RMSNorm (forward only: the
reference-recompute backward comes with LM training)."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_stack.ops import DispatchStats
from repro_torch.kernels.rmsnorm import rmsnorm as kernel_mod

#: Per call: ``kernel`` (a CUDA tensor, the Triton kernel) or ``plain`` (a
#: CPU tensor, its plain version).
STATS = DispatchStats(keys=("kernel", "plain"))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            residual: torch.Tensor | None = None, eps: float = 1e-6
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, h)``: the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    STATS.record("kernel" if x.is_cuda else "plain")
    return kernel_mod.rmsnorm_fwd(x, scale, residual, eps=eps)
