"""Per-shard fused HSTU blocks on a ``seq`` mesh.

Counterpart of ``tencent_recommendation_2025_tpu/parallel/ring_fused.py``.
Each block runs on each local [B, Lc, D] shard (Lc = L / S) as three
autograd units of ``ops/fused_block``, each a kernel launch on the card:

- ``RingPreProjFn``: LN1, the projection and SiLU (q pre-scaled, v scaled
  by 1/L of the whole sequence);
- S ring steps: the local queries against the key/value shard in hand,
  ``RingPairAttnFn`` at the global token offset ``(si - src) * Lc``, where
  ``src = (si - step) % S``; then the key, value and validity shards move
  one place up the ring (:meth:`rotate` of the mesh). SiLU attention has
  no softmax state, so the S f32 partials add up exactly; they sum in ring
  order and round to the activation dtype once;
- ``RingPostGateFn``: the gate, out-projection, residual, LN3 and SwiGLU.

Dropout seeds fold in the shard indices, ``seed + si * 1000003 + di *
10007``, so every (data, seq) shard draws distinct masks. The layout stays
the port's [B, L, D]; only the numbers follow the JAX package's
transposed kernels.
"""

from __future__ import annotations

from typing import List, Mapping

import torch

from ..ops import fused_block as FB


def _ring_fused_block(xs, bp, ops, valids, seed, mesh, L, cfg,
                      use_dropout):
    """One fused HSTU block on this process's shards ``xs`` (a list, in
    the order of ``mesh.seq_indices``); returns the output shards."""
    S, H = mesh.shape["seq"], cfg.num_heads
    Lc = xs[0].shape[1]
    rab = bp["hstu"]["rab"]
    pre_leaves = FB.leaves_of(bp, FB.PRE_LEAVES)
    post_leaves = FB.leaves_of(bp, FB.POST_LEAVES)
    pre = [FB.RingPreProjFn.apply(x, ops, L, H, *pre_leaves) for x in xs]
    acc: List = [None] * len(xs)
    kv = [(k, v, val) for (_, k, v, _), val in zip(pre, valids)]
    for step in range(S):
        for j, si in enumerate(mesh.seq_indices):
            k, v, val = kv[j]
            off = (si - (si - step) % S) * Lc   # negative: a future shard
            part = FB.RingPairAttnFn.apply(pre[j][0], k, v, rab, val, off, H)
            acc[j] = part if acc[j] is None else acc[j] + part
        if step + 1 < S:
            kv = mesh.rotate(kv)
    rate = float(cfg.dropout_rate) if use_dropout else 0.0
    outs = []
    for j, si in enumerate(mesh.seq_indices):
        sd = seed + si * 1000003 + mesh.data_index * 10007 \
            if use_dropout else 0
        outs.append(FB.RingPostGateFn.apply(
            xs[j], acc[j].to(xs[j].dtype), pre[j][3], ops, sd, rate, L, H,
            *post_leaves))
    return outs


def ring_fused_encode(mesh, blocks: Mapping, xs, token_types, seeds, cfg,
                      use_dropout: bool, seq_len: int):
    """Run the stacked blocks over this process's [B, Lc, D] shards ``xs``
    (``token_types`` their [B, Lc] shards, 0 = padding key) with the
    per-shard fused kernels and the ring; ``seeds`` [num_blocks] the
    blocks' dropout seeds; ``seq_len`` the whole sequence's L. Returns the
    output shards (before the final LayerNorm)."""
    from ..models.encoder import block_params

    valids = [t.to(torch.int32).contiguous() for t in token_types]
    xs = [x.contiguous() for x in xs]
    dtype = xs[0].dtype
    with torch.no_grad():
        ops_all = FB.block_operands(blocks, dtype)   # every block's, once
    for i in range(cfg.num_blocks):
        xs = _ring_fused_block(xs, block_params(blocks, i),
                               block_params(ops_all, i), valids, seeds[i],
                               mesh, seq_len, cfg, use_dropout)
    return xs
