"""Plain PyTorch oracle for GQA attention (prefill and decode), ported from
``repro/kernels/attention/ref.py``.

The JAX oracle multiplies native-dtype operands with float32 accumulation
(``preferred_element_type``); a PyTorch product of bf16 tensors rounds its
result to bf16, so here the operands are cast to float32 first (the
products are exact, the sums float32).  The empty-softmax convention is
kept: a row with ``lengths == 0`` attends over zero keys and outputs exact
zeros.  ``gather_paged``/``paged_decode_ref`` are the paged layout's
oracles: gather the table view, then the ordinary masked decode.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *, causal: bool = True, scale: float | None = None,
                  lengths: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,G,Sk,D); optional (B,) valid lengths.

    GQA groups the query heads against their KV head (no repeated copy of
    K/V).  Causal masks ``k_idx <= q_idx + (Sk - Sq)`` without lengths and
    ``k_idx <= q_idx`` with them, as the JAX oracle does."""
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    rep = h // g
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, g, rep, sq, d).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    k_idx = torch.arange(sk, device=q.device)[None, None, None, None, :]
    if lengths is not None:
        s = torch.where(k_idx < lengths[:, None, None, None, None], s,
                        NEG_INF)
    if causal:
        q_idx = torch.arange(sq, device=q.device)[None, None, None, :, None]
        off = 0 if lengths is not None else sk - sq
        s = torch.where(k_idx <= q_idx + off, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if lengths is not None:
        p = torch.where(lengths[:, None, None, None, None] > 0, p, 0.0)
    # the JAX oracle casts p to v's dtype before the product
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor, *, scale: float | None = None
               ) -> torch.Tensor:
    return attention_ref(q, k, v, causal=False, scale=scale, lengths=lengths)


def gather_paged(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The per-slot view of a paged KV pool.

    pool: (N, G, bs, D) physical blocks; table: (B, MB) int block ids.
    Returns (B, G, MB*bs, D): position ``p`` of slot ``b`` reads
    ``pool[table[b, p // bs], :, p % bs]``.  Unmapped table entries point
    at whatever block id the host left there; their columns sit past the
    slot's length and are masked by the caller."""
    g = pool[table.long()]                      # (B, MB, G, bs, D)
    b, mb, gh, bs, d = g.shape
    return g.transpose(1, 2).reshape(b, gh, mb * bs, d)


def paged_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, table: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float | None = None
                     ) -> torch.Tensor:
    """Decode oracle over a block-mapped pool, with the same empty-softmax
    convention (``lengths == 0`` rows are exact zeros)."""
    k = gather_paged(k_pool, table)
    v = gather_paged(v_pool, table)
    return attention_ref(q, k, v, causal=False, scale=scale, lengths=lengths)
