"""Fused GLU gate ``y = act(gate) * up``, in Triton.

Replaces ``repro/kernels/swiglu/swiglu.py:swiglu_fwd`` (the Pallas
kernel).  ``act`` is silu, gelu (the tanh approximation) or squared_relu,
computed in float32 and cast to the input dtype; the product is then taken
in that dtype (in bf16 a product of two bf16 values is exact in float32,
so one rounding of the float32 product gives the reference's bits).

Bound: device-memory bytes: ``gate`` and ``up`` read once, ``y`` written
once.  The pass is purely element-wise, so the kernel walks the flattened
tensors in blocks of ``BLOCK`` elements, one program a block, with int64
offsets; the tail block is masked.  Breadth-first execution would write
``act(gate)`` to device memory and read it back (a full extra read and
write of the block's largest activation).

The kernel source is a module-level string, imported through
:func:`repro_torch.kernels._build.import_generated` at the first launch, so
that importing this module needs no ``triton``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.swiglu import ref

ACT_IDS = {"silu": 0, "gelu": 1, "squared_relu": 2}
BLOCK = 4096
NUM_WARPS = 8
DTYPES = (torch.float32, torch.bfloat16)

KERNEL_SRC = '''\
import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def swiglu_kernel(g_ptr, u_ptr, y_ptr, n, ACT: tl.constexpr,
                  BLOCK: tl.constexpr):
    pid = tl.program_id(0).to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    g = tl.load(g_ptr + offs, mask=mask, other=0.0)
    u = tl.load(u_ptr + offs, mask=mask, other=0.0)
    gf = g.to(tl.float32)
    if ACT == 0:
        a = gf * tl.sigmoid(gf)
    elif ACT == 1:
        a = gf * (0.5 * (1.0 + libdevice.tanh(
            0.7978845608028654 * (gf + 0.044715 * (gf * gf * gf)))))
    else:
        r = tl.maximum(gf, 0.0)
        a = r * r
    # act rounds to the input dtype; the product then rounds once
    y = a.to(g.dtype).to(tl.float32) * u.to(tl.float32)
    tl.store(y_ptr + offs, y.to(g.dtype), mask=mask)
'''


def swiglu_fwd(gate: torch.Tensor, up: torch.Tensor, *,
               act: str = "silu") -> torch.Tensor:
    """``act(gate) * up``.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel or raises."""
    if act not in ACT_IDS:
        raise ValueError(f"unknown activation {act!r}")
    if gate.device.type == "cpu":
        return ref.swiglu_ref(gate, up, act=act)
    if gate.device.type != "cuda":
        raise ValueError(f"swiglu takes cpu or cuda tensors, got "
                         f"{gate.device}")
    if gate.dtype not in DTYPES:
        raise TypeError(f"swiglu: gate must be float32 or bfloat16, got "
                        f"{gate.dtype}")
    if (up.shape != gate.shape or up.dtype != gate.dtype
            or up.device != gate.device):
        raise ValueError(f"swiglu: up {tuple(up.shape)} {up.dtype} on "
                         f"{up.device} does not match gate "
                         f"{tuple(gate.shape)} {gate.dtype} on {gate.device}")
    g = gate.contiguous()
    u = up.contiguous()
    y = torch.empty_like(g)
    n = g.numel()
    kernel = _build.import_generated("swiglu", KERNEL_SRC).swiglu_kernel
    with torch.cuda.device(gate.device):
        kernel[(-(-n // BLOCK),)](g, u, y, n, ACT=ACT_IDS[act], BLOCK=BLOCK,
                                  num_warps=NUM_WARPS)
    swiglu_fwd.launches += 1
    return y


swiglu_fwd.launches = 0
