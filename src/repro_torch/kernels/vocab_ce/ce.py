"""Depth-first fused cross-entropy over the vocab head: the CUDA kernel and
its plain version.

Replaces ``repro/kernels/vocab_ce/ce.py:fused_ce_fwd`` (the Pallas kernel):
per row of ``h (T, D)`` against the head ``w (D, V)``, the logsumexp and
the gold logit of ``h @ w`` in float32, without the ``(T, V)`` logits ever
reaching device memory.  The kernel is ``csrc/fused_ce.cu``: a CTA owns a
tile of rows and one split of the vocab, accumulates each logits tile over
D in registers, makes the online (max, sum, gold) update over it and
writes one partial per (split, row); a second kernel merges the splits in
split order, so two runs give the same bits.  Two instances:

* bfloat16 on the tensor cores (``wgmma`` fed by TMA): tiles of
  :data:`TC_BLOCK_ROWS` x :data:`TC_BLOCK_V`, D in :data:`TC_BLOCK_D`-deep
  chunks, the split count from :func:`tc_split_plan`, the row tile on
  ``blockIdx.x`` so that the row tiles of one split run together and read
  its columns of ``w`` at about the same time.  A tensor map needs row
  pitches that are multiples of 16 bytes, so :func:`staged` copies an
  operand whose rows are not (D or V not a multiple of 8) into a buffer of
  padded pitch first;
* float32 on the CUDA cores: tiles of :data:`BLOCK_ROWS` x
  :data:`BLOCK_V`, the split count from :func:`split_plan`.

Its note gives the bound (operations: ``2 T D V`` at the bf16 tensor-core
rate) and the design.

The plain version is :func:`repro_torch.kernels.vocab_ce.ref.ce_ref`.  A
CPU tensor runs it; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vocab_ce import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_ce.cu"
NEG_INF = -1e30
#: The float32 kernel's tiles (``BM``, ``BN`` in ``csrc/fused_ce.cu``).
BLOCK_ROWS = 128
BLOCK_V = 128
#: CTAs the float32 split plan aims for on each SM.
CTAS_PER_SM = 8
#: The bf16 kernel's tiles (``TC_BM``, ``TC_BN``, ``TC_BK``): two
#: warpgroups of 64 rows, one m64n256 product chain each, 64-deep chunks.
TC_BLOCK_ROWS = 128
TC_BLOCK_V = 256
TC_BLOCK_D = 64
#: Waves of CTAs the bf16 split plan aims for (one CTA an SM: its ring of
#: four 48 KB stages takes most of the shared memory).
TC_WAVES = 8
#: A tensor map's row pitch must be a multiple of 16 bytes: 8 bf16.
PITCH_ELEMS = 8
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def split_plan(n_rows: int, vocab: int, sm_count: int) -> int:
    """How many vocab splits the float32 kernel's grid has: enough that the
    row tiles times the splits give :data:`CTAS_PER_SM` CTAs an SM, and at
    most one split per ``BLOCK_V``-column tile (so every split holds at
    least one real column)."""
    row_tiles = max(1, -(-n_rows // BLOCK_ROWS))
    v_tiles = max(1, -(-vocab // BLOCK_V))
    return max(1, min(v_tiles, -(-CTAS_PER_SM * sm_count // row_tiles)))


def tc_split_plan(n_rows: int, vocab: int, sm_count: int) -> int:
    """How many vocab splits the bf16 kernel's grid has: enough that the
    row tiles times the splits give :data:`TC_WAVES` waves of one CTA an
    SM, and at most one split per ``TC_BLOCK_V``-column tile.  At the
    training shape (4096 rows, vocab 102,400) on 132 SMs: 33 splits of 12
    or 13 tiles, 1056 CTAs."""
    row_tiles = max(1, -(-n_rows // TC_BLOCK_ROWS))
    v_tiles = max(1, -(-vocab // TC_BLOCK_V))
    return max(1, min(v_tiles, -(-TC_WAVES * sm_count // row_tiles)))


def staged(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``x`` (rows, cols) and its row pitch in elements, as a tensor map
    can describe it: as it is when the pitch is a multiple of
    :data:`PITCH_ELEMS` and its base 16-byte aligned, else copied into a
    buffer whose pitch is rounded up (the pad columns are never read: the
    map's width stays ``cols`` and zero-fills past it)."""
    rows, cols = x.shape
    if cols % PITCH_ELEMS == 0 and x.data_ptr() % 16 == 0:
        return x, cols
    pitch = -(-cols // PITCH_ELEMS) * PITCH_ELEMS
    buf = torch.empty((rows, pitch), dtype=x.dtype, device=x.device)
    buf[:, :cols].copy_(x)
    return buf, pitch


def fused_ce_fwd(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """h: (T, D); w: (D, V); labels: (T,) int.  Returns ``(logsumexp (T,),
    gold_logit (T,))`` in float32; the per-row NLL is ``lse - gold`` (the
    caller masks labels < 0, whose gold is 0)."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0] \
            or tuple(labels.shape) != (h.shape[0],):
        raise ValueError(f"fused_ce_fwd: h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, labels {tuple(labels.shape)}")
    if h.device.type == "cpu":
        return ref.ce_ref(h, w, labels)
    if h.device.type != "cuda":
        raise ValueError(f"fused_ce_fwd takes cpu or cuda tensors, got "
                         f"{h.device}")
    if h.dtype not in DTYPE_IDS or w.dtype != h.dtype:
        raise TypeError(f"fused_ce_fwd: h and w must share float32 or "
                        f"bfloat16, got {h.dtype}, {w.dtype}")
    if w.device != h.device or labels.device != h.device:
        raise ValueError("fused_ce_fwd: h, w, labels on different devices")
    t, d = h.shape
    v = w.shape[1]
    lse = torch.empty((t,), dtype=torch.float32, device=h.device)
    gold = torch.empty_like(lse)
    if t == 0:
        return lse, gold
    if v == 0 or d == 0:
        raise ValueError(f"fused_ce_fwd: empty head {tuple(w.shape)}")
    h, w = h.contiguous(), w.contiguous()
    lab = labels.to(torch.int32).contiguous()
    sm = torch.cuda.get_device_properties(h.device).multi_processor_count
    if h.dtype == torch.bfloat16:
        (h, ldh), (w, ldw) = staged(h), staged(w)
        n_split = tc_split_plan(t, v, sm)
    else:
        ldh, ldw = d, v
        n_split = split_plan(t, v, sm)
    part = torch.empty((3, n_split, t), dtype=torch.float32, device=h.device)
    lib = _library()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.fused_ce_fwd(
            h.data_ptr(), w.data_ptr(), lab.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), part[2].data_ptr(), lse.data_ptr(),
            gold.data_ptr(), t, d, v, ldh, ldw, n_split, DTYPE_IDS[h.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_fwd launch failed: "
                           f"{lib.fused_ce_error(err).decode()}")
    fused_ce_fwd.launches += 1
    return lse, gold


fused_ce_fwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.load_library(SOURCE)
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_ce_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                     i, p]
        lib.fused_ce_fwd.restype = i
        lib.fused_ce_error.argtypes = [i]
        lib.fused_ce_error.restype = ctypes.c_char_p
        lib._bound = True
    return lib
