"""The SSD intra-chunk block (Mamba2): the CUDA kernel and its plain
version.

Replaces ``repro/kernels/ssd/ssd.py:ssd_intra_chunk`` (the Pallas kernel).
Per (batch, head, chunk) cell, on float32 tiles:

    G       = C_c B_c^T                       (L, L)
    M       = G * exp(a_i - a_j) * tril       decay-masked scores
    Y_intra = M @ (dt*x)_c                    (L, P)
    S_c     = (B_c * exp(a_L - a))^T (dt*x)_c (N, P) chunk state

so the (L, L) score matrix never reaches device memory.  The kernel is
``csrc/ssd_intra_chunk.cu``: one CTA per (batch, chunk, group of heads),
which computes G once for the group and walks its heads, the next head's
operands arriving by ``cp.async``; float32 FMAs on the CUDA cores in the
plain version's order, so the two agree bit for bit; its note gives the
bound (bytes) and the design.  The heads a CTA takes come from
:func:`launch_plan`.  The mask is a select before the ``exp``, so
overflowing decays above the diagonal give 0, not NaN.

The plain version is :func:`ssd_intra_chunk_ref`, the intra-chunk step of
the plain chunked path (``chunked.py``).  A CPU tensor runs it; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.chunked import ssd_intra_chunk_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_intra_chunk.cu"
#: The longest chunk the kernel takes (its score tile is one 64 x 64 block).
MAX_CHUNK = 64
#: What computing G costs a CTA, in heads' worth of work (G is about 0.4
#: of a head's FMAs; staging C and B about as much again).
G_COST = 1


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The kernel's grid: CTA ``i`` takes head group ``i % groups`` of
    (batch, chunk) ``i // groups``, heads ``[g * heads_per_cta, (g + 1) *
    heads_per_cta)`` cut at H; ``waves`` is how many times the CTAs fill
    the card."""
    heads_per_cta: int
    groups: int
    ctas: int
    waves: int


def launch_plan(batch: int, heads: int, chunks: int, sm_count: int,
                ctas_per_sm: int) -> LaunchPlan:
    """Heads a CTA from the shape and the card: the group count whose
    ``waves x (heads_per_cta + G_COST)`` is least, the fewest groups on a
    tie.  A group shares one G; more groups fill more of the card's
    ``sm_count x ctas_per_sm`` CTA slots.  At mamba2-2.7b's 80 heads on an
    H100 (132 SMs, two CTAs an SM): 10 heads a CTA at prefill's 32 chunks
    (256 CTAs), 20 at training's 64 (256 CTAs)."""
    slots = max(sm_count, 1) * max(ctas_per_sm, 1)
    best = None
    for groups in range(1, max(heads, 1) + 1):
        per = -(-heads // groups)
        if -(-heads // per) != groups:      # the same split as fewer groups
            continue
        ctas = batch * chunks * groups
        waves = -(-ctas // slots)
        cost = waves * (per + G_COST)
        if best is None or cost < best[0]:
            best = (cost, LaunchPlan(per, groups, ctas, waves))
    return best[1]


#: Kernel CTAs an SM by (device index, L, N, P), from the occupancy query.
_CTAS_PER_SM: dict[tuple, int] = {}


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
        plan = launch_plan(b, h, nc, _sm_count(dtx.device),
                           _ctas_per_sm(lib, L, n, p))
        stream = torch.cuda.current_stream(dtx.device).cuda_stream
        err = lib.ssd_intra_chunk(
            dtx.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), s.data_ptr(), b, h, nc, L, n, p,
            plan.heads_per_cta, stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk launch failed: "
                           f"{lib.ssd_error(err).decode()}")
    ssd_intra_chunk.launches += 1
    return y, s


ssd_intra_chunk.launches = 0


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ctas_per_sm(lib: ctypes.CDLL, L: int, n: int, p: int) -> int:
    """The kernel's CTAs an SM of the current device at (L, N, P)."""
    key = (torch.cuda.current_device(), L, n, p)
    hit = _CTAS_PER_SM.get(key)
    if hit is None:
        hit = lib.ssd_ctas_per_sm(L, n, p)
        if hit < 1:
            why = (lib.ssd_error(-hit).decode() if hit < 0 else
                   "its tiles need more shared memory than an SM has")
            raise RuntimeError(f"ssd_intra_chunk: no CTA fits an SM at (L, N,"
                               f" P) = {(L, n, p)}: {why}")
        _CTAS_PER_SM[key] = hit
    return hit


def _library() -> ctypes.CDLL:
    lib = _build.load_library(SOURCE)
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_intra_chunk.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        i, p]
        lib.ssd_intra_chunk.restype = i
        lib.ssd_ctas_per_sm.argtypes = [i, i, i]
        lib.ssd_ctas_per_sm.restype = i
        lib.ssd_error.argtypes = [i]
        lib.ssd_error.restype = ctypes.c_char_p
        lib._bound = True
    return lib
