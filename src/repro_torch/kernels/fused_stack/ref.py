"""Plain PyTorch version of the fused stack kernels.

It *is* the IR interpreter run breadth-first on whole tensors: one eager
PyTorch kernel per op, every intermediate in device memory.  The CPU path
runs it, and ``chip_smoke.py`` holds the CUDA kernels against it.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core import ir


def fused_stack_ref(program: ir.StackProgram,
                    inputs: Mapping[str, torch.Tensor],
                    params: Mapping[str, torch.Tensor],
                    *,
                    barrier: bool = False) -> dict[str, torch.Tensor]:
    return ir.run_program(program, inputs, params, barrier=barrier)
