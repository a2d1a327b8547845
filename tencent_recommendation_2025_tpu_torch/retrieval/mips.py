"""Exact top-k maximum-inner-product search.

Counterpart of ``tencent_recommendation_2025_tpu/retrieval/mips.py``, exact
method: blocked ``[Q, D] x [D, N]`` scoring with a running top-k merge, so
peak memory is O(Q * (k + block_n)), never O(Q * N). Indices are global
corpus rows; when k exceeds the corpus, the missing places score the
lowest f32 value with index 0. The JAX package leaves this to XLA, so here
it is plain PyTorch. The approximate and int8 tiers are not ported yet
(ROADMAP Queue 1, Retrieval tiers).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def topk_mips(queries: torch.Tensor, corpus: torch.Tensor, k: int = 10,
              block_n: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], corpus [N, D] -> (scores [Q, k] f32, indices [Q, k]
    int64)."""
    Q = queries.shape[0]
    N = corpus.shape[0]
    block_n = min(block_n, max(k, N))
    neg_inf = torch.finfo(torch.float32).min
    dev = queries.device
    best_s = torch.full((Q, k), neg_inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros((Q, k), dtype=torch.long, device=dev)
    q = queries.float()
    for start in range(0, N, block_n):
        block = corpus[start:start + block_n].float()
        s = q @ block.T
        idx = torch.arange(start, start + block.shape[0], device=dev)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, idx[None, :].expand(Q, -1)], dim=1)
        best_s, pos = torch.topk(cat_s, min(k, cat_s.shape[1]), dim=1)
        best_i = torch.gather(cat_i, 1, pos)
    # places no corpus row filled keep their initial (lowest score, row 0)
    best_i = torch.where(best_s == neg_inf, torch.zeros_like(best_i), best_i)
    return best_s, best_i


def retrieve_topk(query_embs: np.ndarray, corpus_embs: np.ndarray,
                  corpus_ids: np.ndarray, k: int = 10,
                  query_batch: int = 4096, device="cuda") -> np.ndarray:
    """Host wrapper: batch queries, map indices back to corpus ids. Returns
    [Q, k] of ``corpus_ids`` dtype (e.g. uint64 retrieval ids)."""
    corpus = torch.as_tensor(np.asarray(corpus_embs, np.float32),
                             device=device)
    out = []
    for s in range(0, len(query_embs), query_batch):
        q = torch.as_tensor(np.asarray(query_embs[s:s + query_batch],
                                       np.float32), device=device)
        _, idx = topk_mips(q, corpus, k=k)
        out.append(idx.cpu().numpy())
    return np.asarray(corpus_ids)[np.concatenate(out, axis=0)]
