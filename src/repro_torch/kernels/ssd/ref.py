"""Plain PyTorch oracle for the Mamba2 SSD mixer, ported from
``repro/kernels/ssd/ref.py``: the exact sequential recurrence.

State update per time step (post-discretization):

    h_t = exp(dt_t * A) * h_{t-1} + B_t (dt_t * x_t)^T      h: (N, P)
    y_t = C_t^T h_t + D * x_t

Shapes: x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,N) (single group),
D (H,).  Slow but unambiguous: the oracle every faster path must match.
"""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor | None = None
            ) -> torch.Tensor:
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, B, C, A))
    hstate = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * Af[None, :])                    # (B, H)
        dBx = torch.einsum("bn,bhp->bhnp", Bf[:, t],
                           dtf[:, t][..., None] * xf[:, t])        # (B,H,N,P)
        hstate = hstate * dA[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], hstate))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((b, 0, h, p), dtype=torch.float32, device=x.device))
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype)
