"""Sequence-parallel ring attention, plain PyTorch.

Counterpart of ``tencent_recommendation_2025_tpu/parallel/ring_attention.py``
(XLA einsums there), which the encoder takes on a ``seq`` mesh wherever
the per-shard fused path's gate refuses (``hstu_mini``'s ReLU FFN, the
softmax MHA presets, shards shorter than 256): queries stay on their shard
while the key/value shards rotate around the ring, with causality and key
padding from global positions.

- softmax MHA: online log-sum-exp merging over the ring steps;
- HSTU: pointwise SiLU weights, so the per-step partials just add; the
  division by L uses the whole sequence's length.

Both take head-packed [B, L, D] q, k, v: on a local mesh the whole
sequence (split into the S shards here, the output concatenated back), on
a process mesh this process's [B, Lc, D] shard. Autograd differentiates
them; on a process mesh the rotation's backward sends the key/value
gradients back around the ring.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as Fn


def _shards(mesh, t):
    return [t] if mesh.process else mesh.seq_shards(t)


def _joined(mesh, outs):
    return outs[0] if mesh.process else torch.cat(outs, dim=1)


def _heads(t, H):
    B, L, D = t.shape
    return t.reshape(B, L, H, D // H).transpose(1, 2)


def _rows(t):
    B, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(B, L, H * hd)


def _positions(si, Lc, device):
    return si * Lc + torch.arange(Lc, device=device)


def _ring(mesh, q, k, v, kv_valid, step_fn, init, finish):
    """Walk the ring: ``state = step_fn(state, qh, kh, vh, mask, dist)``
    per step, on every local shard; mask and distance [B?, Lq, Lk] from
    global positions."""
    S = mesh.shape["seq"]
    qs = _shards(mesh, q)
    kv = list(zip(_shards(mesh, k), _shards(mesh, v),
                  _shards(mesh, kv_valid.to(torch.int32))))
    Lc = qs[0].shape[1]
    states = [init(t) for t in qs]
    for step in range(S):
        for j, si in enumerate(mesh.seq_indices):
            kc, vc, okc = kv[j]
            src = (si - step) % S
            dist = _positions(si, Lc, q.device)[:, None] \
                - _positions(src, Lc, q.device)[None, :]
            mask = (dist >= 0)[None] & (okc != 0)[:, None, :]
            states[j] = step_fn(states[j], qs[j], kc, vc, mask, dist)
        if step + 1 < S:
            kv = mesh.rotate(kv)
    return _joined(mesh, [finish(s, t) for s, t in zip(states, qs)])


def ring_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, kv_valid: torch.Tensor, num_heads: int,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Causal softmax attention with L sharded over the ``seq`` axis;
    ``kv_valid`` [B, L or Lc] (nonzero = real key). Scores, the online
    softmax and the sums in f32; the output in q's dtype."""
    H = num_heads
    hd = q.shape[-1] // H
    scale = hd ** -0.5 if scale is None else scale
    f32 = torch.float32
    neg = torch.finfo(f32).min

    def init(qc):
        B, Lc, _ = qc.shape
        z = qc.new_zeros((B, H, Lc, 1), dtype=f32)
        return (z + neg, z, qc.new_zeros((B, H, Lc, hd), dtype=f32))

    def step(state, qc, kc, vc, mask, dist):
        m, l, acc = state
        s = torch.matmul(_heads(qc, H).float(),
                         _heads(kc, H).float().transpose(-1, -2)) * scale
        mask = mask[:, None]
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new) * mask.to(f32)
        corr = torch.exp(m - m_new)
        acc = acc * corr + torch.matmul(p, _heads(vc, H).float())
        return m_new, l * corr + p.sum(-1, keepdim=True), acc

    def finish(state, qc):
        _, l, acc = state
        return _rows(acc / torch.clamp(l, min=1e-30)).to(qc.dtype)

    return _ring(mesh, q, k, v, kv_valid, step, init, finish)


def ring_hstu_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, kv_valid: torch.Tensor,
                        rab: torch.Tensor, num_heads: int, scale: float,
                        seq_len: int) -> torch.Tensor:
    """HSTU pointwise attention with L sharded over ``seq``: each step adds
    ``silu(q k^T * scale + rab[h, clip(dist)]) * mask / seq_len @ v`` in
    f32; the output in q's dtype. ``rab`` [H, buckets]."""
    H = num_heads
    hd = q.shape[-1] // H
    buckets = rab.shape[-1]
    f32 = torch.float32

    def init(qc):
        B, Lc, _ = qc.shape
        return qc.new_zeros((B, H, Lc, hd), dtype=f32)

    def step(acc, qc, kc, vc, mask, dist):
        s = torch.matmul(_heads(qc, H).float(),
                         _heads(kc, H).float().transpose(-1, -2)) * scale
        s = s + rab.float()[:, dist.clamp(0, buckets - 1)][None]
        a = Fn.silu(s) * mask[:, None].to(f32) / float(seq_len)
        return acc + torch.matmul(a, _heads(vc, H).float())

    def finish(acc, qc):
        return _rows(acc).to(qc.dtype)

    return _ring(mesh, q, k, v, kv_valid, step, init, finish)
