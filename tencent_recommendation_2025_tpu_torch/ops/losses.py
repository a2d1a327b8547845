"""Training objective: the reference BCE and its L2 embedding penalty.

Counterpart of ``tencent_recommendation_2025_tpu/ops/losses.py`` (l.25-55):
mean BCE-with-logits over positions whose next token is an item, positives
labelled 1 and the single uniform negative labelled 0, plus BaseLine's
explicit ``l2_emb * ||item_emb||`` (L2 norm, *not* squared). Sampled
softmax is not ported yet: ROADMAP Queue 1, Sampled softmax.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Elementwise stable binary cross-entropy with logits."""
    return torch.clamp(logits, min=0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))


def reference_bce_loss(pos_logits: torch.Tensor, neg_logits: torch.Tensor,
                       loss_mask: torch.Tensor) -> torch.Tensor:
    """mean BCE(pos, 1) + mean BCE(neg, 0) over masked positions, in f32."""
    m = loss_mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    pos = pos_logits.float()
    neg = neg_logits.float()
    return ((bce_with_logits(pos, torch.ones_like(pos)) * m).sum() / n
            + (bce_with_logits(neg, torch.zeros_like(neg)) * m).sum() / n)


def l2_emb_penalty(item_emb: torch.Tensor, l2_emb: float) -> torch.Tensor:
    """BaseLine's ``l2_emb * torch.norm(item_emb)``: L2 norm, not squared."""
    return l2_emb * torch.sqrt((item_emb.float() ** 2).sum())
