"""Plain PyTorch oracle for the fused vocab cross-entropy, ported from
``repro/kernels/vocab_ce/ref.py``: float32 logits ``h.float() @
w.float()`` (the products are exact, the sums float32)."""
from __future__ import annotations

import torch


def ce_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(logsumexp (T,), gold_logit (T,))`` in float32; labels < 0
    give gold = 0 (the caller masks those rows)."""
    logits = h.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp_min(labels.long(), 0)
    gold = torch.gather(logits, -1, safe[:, None])[:, 0]
    gold = torch.where(labels >= 0, gold, 0.0)
    return lse, gold


def nll_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
            ) -> torch.Tensor:
    """Mean masked NLL (labels < 0 masked), the training-loss form."""
    lse, gold = ce_ref(h, w, labels)
    mask = (labels >= 0).float()
    return torch.sum((lse - gold) * mask) / torch.clamp_min(mask.sum(), 1.0)


def gold_logp_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Per-token gold log-probability (T,) in float32.  Negative labels
    wrap python-style (``labels + V``), as ``jnp.take_along_axis`` does."""
    v = w.shape[1]
    wrapped = torch.where(labels < 0, labels + v, labels).long()
    logits = h.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, wrapped[:, None])[:, 0]
    return gold - lse
