"""Depth-first (flash) attention forward: the CUDA kernel and its plain
version.

Replaces ``repro/kernels/attention/flash.py:flash_attention_fwd`` (the
Pallas kernel).  The kernel is ``csrc/flash_attention.cu``: bfloat16 runs on
the tensor cores (``wgmma``, K and V through a TMA ring; one CTA per batch,
query head and 128-query block), float32 on the CUDA cores (64-query
blocks), each an online softmax over key blocks; its note gives the bound,
the design, the bf16 instance's one numerical change (P fed to the
second product as two bf16 terms) and how a head dim fills the tiles'
64-column halves (one at 64, two up to 128, four at 256, where a key block
is 64 keys in place of 128).
The plain version, :func:`flash_attention_plain`, is the Pallas kernel's
algorithm on whole tensors: ``(block_q, block_k)`` tiles, the running
max / denominator / accumulator carried across key blocks in float32, the
finite ``NEG_INF`` and the kernel's causal rule ``k_idx <= q_idx``.  A CPU
tensor runs it; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NEG_INF = -1e30
#: Head dims the CUDA kernel is built for (granite-moe-3b's 64,
#: hubert-xlarge's 80, zamba2-7b's 112, 128 and paligemma-3b's 256).
HEAD_DIMS = (64, 80, 112, 128, 256)
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def supports_head_dim(d: int) -> bool:
    """Whether the CUDA kernel has an instance of head dim ``d``."""
    return d in HEAD_DIMS


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          block_q: int = 128, block_k: int = 128
                          ) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, G, Sk, D) with H a multiple of G."""
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    rep = h // g
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    qg = q.reshape(b, g, rep, sq, d).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((b, g, rep, sq, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, block_q):
        qb = qg[:, :, :, q0:q0 + block_q]
        q_idx = torch.arange(q0, q0 + qb.shape[3], device=q.device)[:, None]
        m = torch.full(qb.shape[:-1] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape, device=q.device)
        for k0 in range(0, sk, block_k):
            kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
            s = torch.einsum("bgrqd,bgkd->bgrqk", qb, kb) * scale
            if causal:
                k_idx = torch.arange(k0, k0 + kb.shape[2], device=q.device)
                s = torch.where(k_idx[None, :] <= q_idx, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bgrqk,bgkd->bgrqd", p, vb)
            m = m_new
        out[:, :, :, q0:q0 + block_q] = (acc / torch.clamp(l, min=1e-30)
                                         ).to(q.dtype)
    return out.reshape(b, h, sq, d)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: float | None = None,
                        block_q: int = 128, block_k: int = 128
                        ) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, G, Sk, D) with H a multiple of G.

    ``block_q``/``block_k`` are the plain version's tiles (the Pallas
    kernel's); the CUDA kernel has its own, fixed at compile time."""
    b, h, sq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    g, sk = k.shape[1], k.shape[2]
    if h % g:
        raise ValueError(f"q heads {h} not a multiple of kv heads {g}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention takes cpu or cuda tensors, got "
                         f"{q.device}")
    if q.dtype not in DTYPE_IDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention: q, k, v on different devices")
    if not supports_head_dim(d):
        raise ValueError(f"flash attention: head dim {d} not in {HEAD_DIMS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, g,
            sq, sk, d, float(scale), int(causal), DTYPE_IDS[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{lib.flash_attention_error(err).decode()}")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.load_library(SOURCE)
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                            ctypes.c_float, i, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_error.argtypes = [i]
        lib.flash_attention_error.restype = ctypes.c_char_p
        lib._bound = True
    return lib
