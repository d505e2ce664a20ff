"""Plain PyTorch version of the fused residual + RMSNorm kernel.

The same roundings as ``repro/kernels/rmsnorm/ref.py``: the residual add
happens in the input dtype (a rounded ``x + res`` in bf16), the statistics
and the scale multiply in float32, and one cast back at the end."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                residual: torch.Tensor | None = None,
                *, eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y, h)``: ``h = x (+ residual)``, ``y = rmsnorm(h) * scale``."""
    h = x + residual if residual is not None else x
    hf = h.float()
    var = torch.mean(torch.square(hf), dim=-1, keepdim=True)
    y = (hf * torch.rsqrt(var + eps) * scale.float()).to(h.dtype)
    return y, h
