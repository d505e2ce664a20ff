"""Fused residual add + RMSNorm, in Triton.

Replaces ``repro/kernels/rmsnorm/rmsnorm.py:rmsnorm_fwd`` (the Pallas
kernel): ``h = x (+ residual)`` in the input dtype, ``y = f32(h) *
rsqrt(mean(f32(h)^2) + eps) * f32(scale)`` cast back; it writes ``y`` and,
with a residual, ``h``.  Without a residual ``h`` is ``x`` itself.

Bound: device-memory bytes.  Each row of ``x`` (and ``residual``) is read
once and ``y`` (and ``h``) written once; the add, the row reduction and the
normalisation happen while the row is in registers.  Design: one program
owns ``R_SUB`` whole rows (all of D = 4096 in one ``BLOCK_D`` block, so the
reduction needs no second pass), and there are many programs (4,096 for
8,192 rows) so that every SM has loads in flight.  Rows past the end and
lanes past D are masked, never padded.  The Pallas kernel's
``block_rows`` (a VMEM tile) has no counterpart: rows per program follow
from D.

The kernel source is a module-level string, imported through
:func:`repro_torch.kernels._build.import_generated` at the first launch
(``@triton.jit`` reads its function's source from a real file), so that
importing this module needs no ``triton``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import ref

KERNEL_SRC = '''\
import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def rmsnorm_kernel(x_ptr, res_ptr, scale_ptr, y_ptr, h_ptr, n_rows, eps,
                   D: tl.constexpr, BLOCK_D: tl.constexpr,
                   R_SUB: tl.constexpr, HAS_RES: tl.constexpr):
    pid = tl.program_id(0)
    rows = (pid * R_SUB + tl.arange(0, R_SUB))[:, None]
    cols = tl.arange(0, BLOCK_D)[None, :]
    mask = (rows < n_rows) & (cols < D)
    offs = rows.to(tl.int64) * D + cols
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    if HAS_RES:
        r = tl.load(res_ptr + offs, mask=mask, other=0.0)
        # the add rounds to the input dtype, as the reference's x + res
        h = (x.to(tl.float32) + r.to(tl.float32)).to(x.dtype)
        tl.store(h_ptr + offs, h, mask=mask)
    else:
        h = x
    hf = h.to(tl.float32)
    var = tl.sum(hf * hf, axis=1) / D
    s = tl.load(scale_ptr + cols, mask=cols < D, other=0.0).to(tl.float32)
    y = hf * libdevice.rsqrt(var + eps)[:, None] * s
    tl.store(y_ptr + offs, y.to(x.dtype), mask=mask)
'''

#: Elements one program holds (R_SUB * BLOCK_D), at least one row.
SUB_ELEMS = 8192
DTYPES = (torch.float32, torch.bfloat16)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def launch_config(d: int) -> tuple[int, int, int]:
    """(BLOCK_D, R_SUB, num_warps) for rows of width ``d``."""
    block_d = _next_pow2(d)
    r_sub = max(1, SUB_ELEMS // block_d)
    elems = r_sub * block_d
    num_warps = 4 if elems <= 2048 else 8 if elems <= 4096 else 16
    return block_d, r_sub, num_warps


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                residual: torch.Tensor | None = None, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y, h)`` where ``h = x (+ residual)`` is the new residual
    stream and ``y = rmsnorm(h) * scale``.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, residual, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm takes cpu or cuda tensors, got {x.device}")
    d = x.shape[-1]
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if tuple(scale.shape) != (d,) or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale must be ({d},) on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError(f"rmsnorm: residual {tuple(residual.shape)} "
                         f"{residual.dtype} on {residual.device} does not "
                         f"match x {tuple(x.shape)} {x.dtype} on {x.device}")
    rows = x.numel() // d
    xf = x.reshape(rows, d).contiguous()
    rf = residual.reshape(rows, d).contiguous() if residual is not None else xf
    y = torch.empty_like(xf)
    h = torch.empty_like(xf) if residual is not None else y
    block_d, r_sub, num_warps = launch_config(d)
    kernel = _build.import_generated("rmsnorm", KERNEL_SRC).rmsnorm_kernel
    with torch.cuda.device(x.device):
        kernel[(-(-rows // r_sub),)](
            xf, rf, scale.contiguous(), y, h, rows, float(eps), D=d,
            BLOCK_D=block_d, R_SUB=r_sub, HAS_RES=residual is not None,
            num_warps=num_warps)
    rmsnorm_fwd.launches += 1
    return y.reshape(x.shape), (h.reshape(x.shape) if residual is not None
                                else x)


rmsnorm_fwd.launches = 0
