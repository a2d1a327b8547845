"""The reference's first training steps: the loss of each step, the first
step's gradient and the parameters after the last, in float32.

Dense leaves take AdamW as PyTorch defines it (decoupled weight decay on
every leaf, eps outside the square root); a row-sparse table takes
row-wise Adagrad on the rows its step touched (``acc += mean(g^2)``,
``row -= lr * (g / sqrt(acc + eps) + wd * row)``). The batch runs in
blocks of rows whose BCE sums divide by the whole batch's count, so the
gradient is the whole batch's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch


def _rows(batch: Mapping, sl: slice) -> Dict:
    return {k: v[sl] for k, v in batch.items()}


def run_steps(ref, params: Mapping[str, torch.Tensor], batches: List[Dict],
              hp: Mapping, table: Optional[str] = None,
              touched: Optional[Callable] = None, chunk: int = 16,
              rows: Optional[int] = None, frozen: bool = False):
    """``len(batches)`` steps of ``ref`` (a :class:`reference.model.
    Reference`) from ``params`` (path -> tensor; not modified). ``table``:
    the leaf trained row-wise (its rows compact; ``touched(batch)`` their
    indices a step touches). ``rows``: train on the first ``rows`` rows of
    each batch only (the loss their mean); ``frozen``: leave the
    parameters as they are (both plant faults). Returns (losses, first
    gradient norms by leaf, norms of the change after the last step)."""
    P = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items() if k != table}
    v2 = {k: torch.zeros_like(v) for k, v in P.items() if k != table}
    acc = torch.zeros(P[table].shape[0], device=P[table].device) \
        if table else None
    losses, g1 = [], {}
    b1, b2, eps, lr, wd = hp["b1"], hp["b2"], 1e-8, hp["lr"], hp["wd"]
    for t, batch in enumerate(batches, start=1):
        n_rows = batch["seq"].shape[0] if rows is None else rows
        for p in P.values():
            p.grad = None
        n = ((batch["next_token_type"][:n_rows] == 1)
             & (batch["sample_valid"][:n_rows, None] > 0)).sum().float()
        n = n.clamp(min=1.0)
        total = torch.zeros((), device=n.device)
        for lo in range(0, n_rows, chunk):
            s, _ = ref.loss_sum(P, _rows(batch, slice(lo, min(lo + chunk,
                                                               n_rows))))
            (s / n).backward()
            total += s.detach()
        losses.append(float(total / n))
        with torch.no_grad():
            grads = {k: (p.grad if p.grad is not None
                         else torch.zeros_like(p)) for k, p in P.items()}
            if t == 1:
                g1 = {k: float(g.norm()) for k, g in grads.items()}
            if frozen:
                continue
            for k, p in P.items():
                g = grads[k]
                if k == table:
                    idx = touched(batch)
                    gr = g[idx]
                    acc[idx] += (gr * gr).mean(-1)
                    upd = gr * torch.rsqrt(acc[idx] + eps)[:, None] \
                        + wd * p[idx]
                    p[idx] -= hp["table_lr"] * upd
                    continue
                p.mul_(1 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
    change = {k: float((P[k].detach() - params[k].float()).norm())
              for k in P}
    return losses, g1, change
