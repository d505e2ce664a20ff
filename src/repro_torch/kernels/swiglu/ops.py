"""Dispatch for the fused GLU gate (forward only: the reference-recompute
backward comes with LM training)."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_stack.ops import DispatchStats
from repro_torch.kernels.swiglu import swiglu as kernel_mod

#: Per call: ``kernel`` (a CUDA tensor, the Triton kernel) or ``plain`` (a
#: CPU tensor, its plain version).
STATS = DispatchStats(keys=("kernel", "plain"))

#: Gate activations the fused kernel implements.
ACTS = tuple(kernel_mod.ACT_IDS)


def swiglu(gate: torch.Tensor, up: torch.Tensor, act: str = "silu"
           ) -> torch.Tensor:
    """``act(gate) * up``: the kernel on a CUDA tensor, the plain version on
    a CPU one."""
    STATS.record("kernel" if gate.is_cuda else "plain")
    return kernel_mod.swiglu_fwd(gate, up, act=act)
