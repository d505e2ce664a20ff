"""Plain PyTorch version of the fused GLU gate: ``act(f32(gate))`` cast to
the input dtype, then the product in that dtype, as
``repro/kernels/swiglu/ref.py`` rounds."""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTS = {
    "silu": lambda x: x * torch.sigmoid(x),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "squared_relu": lambda x: torch.square(torch.relu(x)),
}


def swiglu_ref(gate: torch.Tensor, up: torch.Tensor, *,
               act: str = "silu") -> torch.Tensor:
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    return ACTS[act](gate.float()).to(gate.dtype) * up
