"""Chunked SSD (state-space duality), ported from
``repro/kernels/ssd/chunked.py``: the plain tensor path of the ``xla`` and
``barrier`` modes, and what the backward of :func:`repro_torch.kernels.
ssd.ops.ssd` differentiates.

The sequence is split into chunks of length L: within a chunk the
recurrence is a masked (L, L) product; across chunks a small (N, P) state
is carried by a loop over the chunks (the JAX package's ``lax.scan``).
All arithmetic in float32, cast back at the end.  The tensors are laid out
as the intra-chunk kernel takes them, (b, h, nc, L, .), so ``ops.ssd``
runs this same driver with the kernel as its intra-chunk step.

One difference from the JAX package, on purpose: the decay mask is applied
to the exponent before the ``exp`` (``-inf`` above the diagonal, so
``exp`` gives 0 there).  The JAX package takes ``exp(a_i - a_j)`` over the
whole square and then selects; above the diagonal ``a_i - a_j`` passes 88
at realistic decays, the float32 ``exp`` overflows to inf, and its
gradient is ``0 * inf`` = NaN.  The forward values are the same.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` (B, S, ...) with ``pad`` zero positions appended to S."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t


def masked_decay(seg: torch.Tensor) -> torch.Tensor:
    """``exp(seg)`` where ``i >= j`` over the last two axes (the causal
    lower triangle of an (L, L) tile), exactly 0 elsewhere: the exponent
    is masked to ``-inf`` first, so no ``exp`` above the diagonal overflows
    and the gradient stays finite."""
    L = seg.shape[-1]
    tril = torch.ones((L, L), dtype=torch.bool, device=seg.device).tril()
    return torch.exp(seg.masked_fill(~tril, float("-inf")))


def ssd_intra_chunk_ref(dtx: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk step in plain PyTorch (the plain version of the
    kernel :func:`repro_torch.kernels.ssd.ssd.ssd_intra_chunk`).  dtx
    (b,h,nc,L,P), a (b,h,nc,L,1), B/C (b,nc,L,N), float32.  Returns
    ``(y_intra (b,h,nc,L,P), S (b,h,nc,N,P))``."""
    g = torch.einsum("bcln,bcmn->bclm", C, B)            # (b,nc,L,L)
    m = masked_decay(a - a.transpose(-1, -2))            # (b,h,nc,L,L)
    y = (g[:, None] * m) @ dtx
    decay = torch.exp(a[..., -1:, :] - a)                # (b,h,nc,L,1)
    s = (B[:, None] * decay).transpose(-1, -2) @ dtx
    return y, s


def inter_chunk_states(lam: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """The state entering each chunk: ``h_c = h_{c-1} * lam_{c-1} +
    S_{c-1}`` from ``h_0 = 0``.  ``lam`` (..., nc) and ``S`` (..., nc, N,
    P); returns ``S``'s shape."""
    nc = lam.shape[-1]
    hprev = torch.zeros_like(S.select(-3, 0))
    out = []
    for c in range(nc):
        out.append(hprev)
        hprev = hprev * lam[..., c, None, None] + S.select(-3, c)
    return torch.stack(out, dim=-3)


IntraChunk = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor,
                D: torch.Tensor | None = None, *, chunk: int = 64,
                intra: IntraChunk = ssd_intra_chunk_ref) -> torch.Tensor:
    """x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n), D (h,) -> y (b,s,h,p)
    in x's dtype.  ``intra`` is the intra-chunk step, in the kernel's
    layout: its plain version here, the CUDA kernel in ``ops.ssd``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    x, dt, B, C = (pad_seq(t, pad) for t in (x, dt, B, C))
    sp = s + pad
    nc = sp // chunk

    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf = B.float().reshape(b, nc, chunk, n).contiguous()
    Cf = C.float().reshape(b, nc, chunk, n).contiguous()
    dtx = torch.movedim(dtf[..., None] * xf, 3, 1).contiguous()  # (b,h,nc,L,p)
    a = torch.cumsum(dtf * A.float(), dim=2)             # inclusive, (b,nc,L,h)
    a = torch.movedim(a, 3, 1)[..., None].contiguous()   # (b,h,nc,L,1)

    # --- intra-chunk: the masked (L, L) product and each chunk's state ----
    y_intra, S = intra(dtx, a, Bf, Cf)                   # S (b,h,nc,n,p)

    # --- inter-chunk recurrence over the small (n, p) state ----------------
    hprevs = inter_chunk_states(torch.exp(a[..., -1, 0]), S)
    y_inter = torch.einsum("bcln,bhcl,bhcnp->bhclp", Cf, torch.exp(a[..., 0]),
                           hprevs)

    y = torch.movedim(y_intra + y_inter, 1, 3).reshape(b, sp, h, p)[:, :s]
    if D is not None:
        y = y + D.float()[None, None, :, None] * \
            x.float().reshape(b, sp, h, p)[:, :s]
    return y.to(x.dtype)


def ssd_decode_step(hstate: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor, D: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent step for serving.

    hstate: (B,H,N,P) float32; x_t: (B,H,P); dt_t: (B,H); B_t/C_t: (B,N).
    Returns (new_state, y_t in x_t's dtype)."""
    dA = torch.exp(dt_t.float() * A.float())
    dBx = torch.einsum("bn,bhp->bhnp", B_t.float(),
                       dt_t.float()[..., None] * x_t.float())
    hnew = hstate * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", C_t.float(), hnew)
    if D is not None:
        y = y + D.float()[None, :, None] * x_t.float()
    return hnew, y.to(x_t.dtype)
