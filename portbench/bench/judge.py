"""The numbers that decide ``correct``, each held to its limit.

Training (the program's first steps against the reference's):

- ``loss_gap``: the largest relative gap of a step's loss; ``loss1_gap``:
  the first step's (before any update);
- ``grad_gap``: over the leaves, the largest gap between the program's
  first-gradient norm (read from its optimizer state after step 1) and
  the reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger; ``grad_median_gap``: the median leaf's;
  ``grad_median_gap.<group>``: the median leaf's of each group of leaves
  (:data:`GROUPS`: the embedding tables, the towers' layers, the encoder's
  blocks), so that a precision lost in one group alone shows;
- ``change_gap``, ``change_median_gap``: the same of the norms of the
  parameters' change after the checked steps, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's
  (smaller ones move under Adam by round-off alone).

Only the numbers that ``limits/<workload>.json`` holds are compared (a
number whose readings do not separate sound runs from the control and the
faults is not: PERF.md names it with its readings); the rest are printed
beside them.

Serving (the program's answers in a sample of the window's requests):

- ``query_gap``: the largest ``|q - q_ref| / |q_ref|`` of a query vector;
- ``topk_gap``: the largest amount, over the query's score scale, by which
  a returned id's exact score lies below the exact k-th best score, or a
  returned score differs from its id's exact score.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Mapping, Tuple

#: leaves below this share of the median leaf's first gradient are left out
#: of the change comparison
SMALL_GRAD = 1e-3

#: groups of leaves by the first part of their path
GROUPS = {"tables": ("item_emb", "user_emb", "pos_emb", "fused_feat"),
          "towers": ("itemdnn", "userdnn", "mm_proj"),
          "blocks": ("blocks", "last_ln")}


def _gap(p: float, r: float, scale: float) -> float:
    return abs(p - r) / max(abs(r), scale, 1e-30)


def train_numbers(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}."""
    losses = [_gap(p, r, 0.0) for p, r in zip(prog["loss"], ref["loss"])]
    leaves = sorted(ref["grad"])
    gmed = statistics.median(ref["grad"][k] for k in leaves)
    gap = {k: _gap(prog["grad"][k], ref["grad"][k], gmed) for k in leaves}
    grads = [gap[k] for k in leaves]
    groups = {f"grad_median_gap.{g}": statistics.median(
        gap[k] for k in leaves if k.split("/")[0] in heads)
        for g, heads in GROUPS.items()}
    moved = [k for k in leaves if ref["grad"][k] >= SMALL_GRAD * gmed]
    cmed = statistics.median(ref["change"][k] for k in moved)
    changes = [_gap(prog["change"][k], ref["change"][k], cmed)
               for k in moved]
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "grad_gap": max(grads),
            "grad_median_gap": statistics.median(grads), **groups,
            "change_gap": max(changes),
            "change_median_gap": statistics.median(changes)}


def worst_leaves(prog: Mapping, ref: Mapping, n: int = 3) -> Dict:
    """The ``n`` leaves with the widest gradient and change gaps (for the
    log of a failed check)."""
    gmed = statistics.median(ref["grad"].values())
    cmed = statistics.median(ref["change"].values())
    g = sorted(ref["grad"], key=lambda k: -_gap(prog["grad"][k],
                                                ref["grad"][k], gmed))[:n]
    c = sorted(ref["change"], key=lambda k: -_gap(prog["change"][k],
                                                  ref["change"][k], cmed))
    return {"grad": {k: [prog["grad"][k], ref["grad"][k]] for k in g},
            "change": {k: [prog["change"][k], ref["change"][k]]
                       for k in c[:n]}}


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number that has a limit within it, {name: {"value",
    "limit"}} of those numbers); no limit at all fails."""
    checks = {k: {"value": float(numbers[k]), "limit": float(v)}
              for k, v in limits.items()}
    ok = bool(checks) and all(c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks


def serve_numbers(queries, ref_queries, ids, scores, exact_scores,
                  kth_exact, scale) -> Dict[str, float]:
    """Tensors over the sampled queries: the program's ``queries`` [Q, D],
    the reference's; the program's top ``ids`` / ``scores`` [Q, k]; the
    exact scores of those ids for the program's queries [Q, k]; the exact
    k-th best score of each [Q]; each query's score scale [Q]."""
    q = ((queries - ref_queries).norm(dim=-1)
         / ref_queries.norm(dim=-1).clamp(min=1e-30)).max()
    rank = (kth_exact[:, None] - exact_scores).clamp(min=0).amax(-1)
    diff = (scores - exact_scores).abs().amax(-1)
    top = (rank.maximum(diff) / scale).max()
    return {"query_gap": float(q), "topk_gap": float(top)}


def summary_line(checks: Mapping) -> List[str]:
    return [f"{k} {c['value']:.6g} limit {c['limit']}"
            for k, c in checks.items()]
