"""Host-planned lookups with a scatter-free backward.

Counterpart of the non-kernel head of
``tencent_recommendation_2025_tpu/ops/sparse_table.py`` (l.45-96): the
tower-dedup path (train/trainer.augment_batch_dedup) runs the item tower
once per unique candidate id and spreads its rows to every consumer site by
a plan the host builds. The rest of that file (gathered-row sparse
training, the packed-table group kernels) is not ported yet: ROADMAP Queue
1, Sparse tables.
"""

from __future__ import annotations

import numpy as np
import torch


class PlannedLookup(torch.autograd.Function):
    """``rows[idx]`` whose backward is the host-scheduled segment sum:

        x = cot[perm];  c = [0; cumsum(x)];  drows[k] = c[ends[k]] - c[starts[k]]

    ``perm`` is the stable argsort of the flattened idx and ``starts`` /
    ``ends`` bound each row's segment (:func:`build_lookup_plan`). The sum
    runs in f32 and the gradient returns in the cotangent's dtype."""

    @staticmethod
    def forward(ctx, rows, idx, perm, starts, ends):
        ctx.save_for_backward(perm, starts, ends)
        return rows[idx.long().clamp(0, rows.shape[0] - 1)]

    @staticmethod
    def backward(ctx, cot):
        perm, starts, ends = ctx.saved_tensors
        D = cot.shape[-1]
        # scanned as [D, N] rows: a scan along the inner axis runs in
        # parallel over D rows of N, where one along the outer axis of
        # [N, D] has only D lanes of parallel work
        xt = cot.reshape(-1, D).float()[perm.long()].t().contiguous()
        c = torch.cat([xt.new_zeros((D, 1)), torch.cumsum(xt, 1)], 1)
        drows = (c[:, ends.long()] - c[:, starts.long()]).t()
        return drows.to(cot.dtype), None, None, None, None


def planned_lookup(rows: torch.Tensor, idx: torch.Tensor, perm: torch.Tensor,
                   starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    return PlannedLookup.apply(rows, idx, perm, starts, ends)


def build_lookup_plan(uids_np, ids_np):
    """HOST-side plan for one lookup site: positions of ``ids`` in the
    sorted ``uids`` plus the segment-sum schedule for the backward."""
    uids_np = np.asarray(uids_np)
    ids_np = np.asarray(ids_np)
    idx = np.searchsorted(uids_np, ids_np).astype(np.int32)
    idx = np.minimum(idx, len(uids_np) - 1)
    flat = idx.reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=len(uids_np)).astype(np.int32)
    ends = np.cumsum(counts).astype(np.int32)
    starts = (ends - counts).astype(np.int32)
    return {"idx": idx, "perm": perm, "starts": starts, "ends": ends}
