"""Training objectives: the reference BCE and its L2 embedding penalty, and
the sampled softmax with logQ correction.

Counterpart of ``tencent_recommendation_2025_tpu/ops/losses.py``:

- BCE: mean BCE-with-logits over positions whose next token is an item,
  positives labelled 1 and the single uniform negative labelled 0, plus
  BaseLine's explicit ``l2_emb * ||item_emb||`` (L2 norm, *not* squared);
- sampled softmax: softmax cross-entropy over [positive | shared
  negatives] with the logQ correction ``logit_j - log Q(j)`` on the sampled
  candidates, accidental hits and padding candidates masked out; the
  in-batch candidates (:func:`inbatch_candidates`) reuse the positives'
  tower outputs with their empirical-frequency logQ.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.sharded_embedding import ShardedTable
from .sparse_table import GatheredRows


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Elementwise stable binary cross-entropy with logits."""
    return torch.clamp(logits, min=0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))


def reference_bce_loss(pos_logits: torch.Tensor, neg_logits: torch.Tensor,
                       loss_mask: torch.Tensor,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean BCE(pos, 1) + mean BCE(neg, 0) over masked positions, in f32;
    with ``count``, the sums divide by it (a data shard's share of the
    global mean) in place of the masked positions here."""
    m = loss_mask.float()
    n = torch.clamp(m.sum() if count is None else count, min=1.0)
    pos = pos_logits.float()
    neg = neg_logits.float()
    return ((bce_with_logits(pos, torch.ones_like(pos)) * m).sum() / n
            + (bce_with_logits(neg, torch.zeros_like(neg)) * m).sum() / n)


def l2_emb_penalty(item_emb, l2_emb: float) -> torch.Tensor:
    """BaseLine's ``l2_emb * torch.norm(item_emb)``: L2 norm, not squared.
    Under sparse-table training (a :class:`GatheredRows`) it covers the
    step's touched rows only; a row-sharded table (a
    :class:`parallel.sharded_embedding.ShardedTable`) is summed over its
    shards."""
    if isinstance(item_emb, ShardedTable):
        return l2_emb * torch.sqrt(item_emb.sum_squares())
    if isinstance(item_emb, GatheredRows):
        item_emb = item_emb.rows
    return l2_emb * torch.sqrt((item_emb.float() ** 2).sum())


def sampled_softmax_loss(query: torch.Tensor, pos_emb: torch.Tensor,
                         neg_embs: torch.Tensor, neg_ids: torch.Tensor,
                         pos_ids: torch.Tensor, loss_mask: torch.Tensor,
                         num_items: int, temperature: float = 1.0,
                         neg_logq: Optional[torch.Tensor] = None,
                         count: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Sampled softmax with logQ correction and accidental-hit masking.

    query [B, L, D] encoder outputs, pos_emb [B, L, D] positive item
    embeddings, neg_embs [N, D] shared negatives, neg_ids [N] and pos_ids
    [B, L] for the masking, loss_mask [B, L] bool. ``neg_logq`` [N] is each
    candidate's log sampling probability; None means all-uniform, -log
    ``num_items``. Candidates with id <= 0 (padding slots of the in-batch
    selection) and accidental hits (a candidate equal to the row's
    positive) are masked out; the positive is not sampled and takes no
    correction. The mean over masked positions, in f32."""
    f32 = torch.float32
    q = query.float() / temperature
    pos_logit = (q * pos_emb.float()).sum(-1)                       # [B, L]
    neg_logit = torch.einsum("bld,nd->bln", q, neg_embs.float())    # [B, L, N]
    if neg_logq is None:
        neg_logq = torch.full((neg_ids.shape[0],), -float(torch.log(
            torch.tensor(float(num_items), dtype=f32))), dtype=f32,
            device=q.device)
    neg_logit = neg_logit - neg_logq[None, None, :]
    hit = (neg_ids[None, None, :] == pos_ids[..., None]) \
        | (neg_ids <= 0)[None, None, :]
    neg_logit = torch.where(hit, torch.finfo(f32).min, neg_logit)
    logits = torch.cat([pos_logit[..., None], neg_logit], -1)
    nll = -torch.log_softmax(logits, -1)[..., 0]
    m = loss_mask.float()
    return (nll * m).sum() / torch.clamp(m.sum() if count is None else count,
                                         min=1.0)


def inbatch_draw(n: int, positions: int, gen: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """[n] uniformly drawn indices into ``positions`` flattened batch
    positions, from ``gen``: the in-batch candidates' draw."""
    return torch.randint(0, positions, (n,), generator=gen, device=device)


def inbatch_ids_logq(flat_ids: torch.Tensor, flat_valid: torch.Tensor,
                     idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids [n], logq [n]) of the in-batch candidates at positions ``idx``
    of the flattened positives ``flat_ids`` and their validity
    ``flat_valid``: id 0 where a draw lands on an invalid position, logQ
    the draw's exact probability count_batch(j) / n_valid."""
    f32 = torch.float32
    idx = idx.long()
    cand_ids = torch.where(flat_valid[idx], flat_ids[idx],
                           torch.zeros_like(flat_ids[idx]))
    match = (flat_ids[None, :] == cand_ids[:, None]) & flat_valid[None, :]
    counts = match.sum(1).to(f32)
    n_valid = torch.clamp(flat_valid.sum().to(f32), min=1.0)
    logq = torch.log(torch.clamp(counts, min=1.0)) - torch.log(n_valid)
    return cand_ids, logq


def inbatch_rows(pos_embs: torch.Tensor, idx: torch.Tensor,
                 offset: int = 0) -> torch.Tensor:
    """[n, D]: the rows of ``pos_embs`` [b, L, D] at the flattened positions
    ``idx - offset`` where they fall inside it, zeros elsewhere. A data
    shard whose rows start at flattened position ``offset`` fills the
    candidates it owns; the sum over the shards is every candidate's row,
    and its gradient returns to the shard that owns it."""
    D = pos_embs.shape[-1]
    flat = pos_embs.reshape(-1, D)
    local = idx.long() - offset
    own = (local >= 0) & (local < flat.shape[0])
    rows = flat[local.clamp(0, flat.shape[0] - 1)]
    return torch.where(own[:, None], rows, torch.zeros_like(rows))


def inbatch_candidates(pos_ids: torch.Tensor, pos_embs: torch.Tensor,
                       loss_mask: torch.Tensor, n: int,
                       gen: Optional[torch.Generator] = None,
                       idx: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n`` in-batch negative candidates from the batch's positives:
    uniformly drawn positions of ``pos_ids`` [B, L] (``idx`` [n] into the
    flattened positions when given, else drawn from ``gen``), reusing the
    positives' tower outputs ``pos_embs`` [B, L, D]. Returns (ids [n], embs
    [n, D], logq [n]): logQ is the exact per-candidate probability of this
    draw, count_batch(j) / n_valid over the valid positions. Draws that land
    on an invalid position get id 0, which the loss masks out."""
    flat_ids = pos_ids.reshape(-1)
    if idx is None:
        idx = inbatch_draw(n, flat_ids.shape[0], gen, flat_ids.device)
    cand_ids, logq = inbatch_ids_logq(flat_ids, loss_mask.reshape(-1), idx)
    cand_embs = pos_embs.reshape(-1, pos_embs.shape[-1])[idx.long()]
    return cand_ids, cand_embs, logq
