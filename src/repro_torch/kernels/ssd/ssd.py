"""The SSD intra-chunk block (Mamba2): the CUDA kernel and its plain
version.

Replaces ``repro/kernels/ssd/ssd.py:ssd_intra_chunk`` (the Pallas kernel).
Per (batch, head, chunk) cell, on float32 tiles:

    G       = C_c B_c^T                       (L, L)
    M       = G * exp(a_i - a_j) * tril       decay-masked scores
    Y_intra = M @ (dt*x)_c                    (L, P)
    S_c     = (B_c * exp(a_L - a))^T (dt*x)_c (N, P) chunk state

so the (L, L) score matrix never reaches device memory.  The kernel is
``csrc/ssd_intra_chunk.cu``: one CTA a cell, everything staged in shared
memory, float32 FMAs on the CUDA cores; its note gives the bound
(operations, at the float32 rate outside the tensor cores) and the design.
The mask is a select before the ``exp``, so overflowing decays above the
diagonal give 0, not NaN.

The plain version is :func:`ssd_intra_chunk_ref`, the intra-chunk step of
the plain chunked path (``chunked.py``).  A CPU tensor runs it; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.chunked import ssd_intra_chunk_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_intra_chunk.cu"
#: The longest chunk the kernel takes (its score tile is one 64 x 64 block).
MAX_CHUNK = 64


def ssd_intra_chunk(dtx: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dtx (b,h,nc,L,P), a (b,h,nc,L,1), B/C (b,nc,L,N), float32.  Returns
    ``(y_intra (b,h,nc,L,P), S (b,h,nc,N,P))`` in float32."""
    b, h, nc, L, p = dtx.shape
    n = B.shape[-1]
    if tuple(a.shape) != (b, h, nc, L, 1) or tuple(B.shape) != (b, nc, L, n) \
            or tuple(C.shape) != (b, nc, L, n):
        raise ValueError(f"ssd_intra_chunk: dtx {tuple(dtx.shape)}, a "
                         f"{tuple(a.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    if dtx.device.type == "cpu":
        return ssd_intra_chunk_ref(dtx, a, B, C)
    if dtx.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk takes cpu or cuda tensors, got "
                         f"{dtx.device}")
    if any(t.dtype != torch.float32 for t in (dtx, a, B, C)):
        raise TypeError("ssd_intra_chunk: dtx, a, B and C must be float32")
    if any(t.device != dtx.device for t in (a, B, C)):
        raise ValueError("ssd_intra_chunk: operands on different devices")
    if not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"ssd_intra_chunk: chunk length {L} outside "
                         f"[1, {MAX_CHUNK}]")
    y = torch.empty((b, h, nc, L, p), dtype=torch.float32, device=dtx.device)
    s = torch.empty((b, h, nc, n, p), dtype=torch.float32, device=dtx.device)
    if y.numel() == 0 and s.numel() == 0:
        return y, s
    dtx, a, B, C = (t.contiguous() for t in (dtx, a, B, C))
    lib = _library()
    with torch.cuda.device(dtx.device):
        stream = torch.cuda.current_stream(dtx.device).cuda_stream
        err = lib.ssd_intra_chunk(
            dtx.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), s.data_ptr(), b, h, nc, L, n, p, stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk launch failed: "
                           f"{lib.ssd_error(err).decode()}")
    ssd_intra_chunk.launches += 1
    return y, s


ssd_intra_chunk.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.load_library(SOURCE)
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_intra_chunk.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.ssd_intra_chunk.restype = i
        lib.ssd_error.argtypes = [i]
        lib.ssd_error.restype = ctypes.c_char_p
        lib._bound = True
    return lib
