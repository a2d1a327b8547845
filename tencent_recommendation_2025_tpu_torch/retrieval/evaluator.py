"""HR@k / NDCG@k evaluation.

The competition metric (SURVEY.md §0) is computed externally by the
leaderboard; the reference repo has no evaluator. This one closes the loop:
given per-user top-k creative ids and a ground-truth next creative id per
user, HR@k = fraction of users whose truth appears in their top-k, and
NDCG@k = mean 1/log2(rank+2) (single relevant item, ideal DCG = 1).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence


def hr_ndcg_at_k(top_ids: Mapping[str, Sequence], ground_truth: Mapping[str, object],
                 k: int = 10) -> Dict[str, float]:
    """top_ids: user_id -> ranked list of creative ids;
    ground_truth: user_id -> true next creative id."""
    hits = 0.0
    ndcg = 0.0
    n = 0
    for uid, truth in ground_truth.items():
        if uid not in top_ids:
            continue
        n += 1
        ranked = list(top_ids[uid])[:k]
        if truth in ranked:
            rank = ranked.index(truth)
            hits += 1.0
            ndcg += 1.0 / math.log2(rank + 2)
    if n == 0:
        return {"hr": 0.0, "ndcg": 0.0, "n": 0}
    return {"hr": hits / n, "ndcg": ndcg / n, "n": n}
