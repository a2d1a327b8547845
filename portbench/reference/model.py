"""Plain PyTorch reference of the two-tower HSTU recommender, in float32.

Written from the model's description (BaseLineO1's towers, Zhai et al.
2024's HSTU block with a SwiGLU FFN, the reference BCE loss); it imports
nothing of the program. Parameters are a flat dict ``path -> tensor`` with
the program's names (``blocks/...`` leaves stacked over the blocks).

Semantics held here:

- item tower: ``relu([item_emb[id] | fused_feat[off_f + v_f] (14 sparse)
  | mm(id) @ Wmm + bmm] @ Witem + bitem)``; a table row read for id or
  value 0 is zero (the padding contract);
- user tower: ``relu([user_emb[uid] | 4 sparse | 4 arrays, each the sum of
  its values' rows] @ Wuser + buser)``; every position runs both towers on
  its masked ids (a non-user position gives the tower of the zero input);
- encoder: ``x * sqrt(D) + pos_emb[l + 1]`` (row 0 on padding ids), then
  pre-norm blocks ``x += hstu(LN(x)); x += ffn(LN(x))`` and a final LN,
  LayerNorm eps 1e-8;
- HSTU: ``u, v, q, k = silu(x W + b)``; ``a = silu(q k^T / sqrt(hd) +
  rab[h, min(i - j, buckets - 1)]) * causal * key_valid / L``;
  ``out = (LN(a v) * u) Wo + bo``;
- SwiGLU: ``(silu(x W1) * x W3) W2`` with ``W13 = [W1 | W3]``;
- loss: mean BCE of positive logits (label 1) plus mean BCE of negative
  logits (label 0) over the positions whose next token is an item.

``Numerics(fp8=True)`` holds in 8-bit floats (e4m3 forward, e5m2
gradients, per-tensor scales) what a bf16 configuration holds in bf16: the
control that computes in the precision below the configuration's.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F

ITEM_SPARSE = 14
USER_SPARSE = 4
USER_ARRAY = 4


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the 8-bit float ``dtype`` under a per-tensor scale
    that maps its largest magnitude to ``top``."""
    s = top / x.abs().amax().clamp(min=1e-30)
    return (x * s).to(dtype).float() / s


class _Float8(torch.autograd.Function):
    """e4m3 forward, e5m2 backward: the usual 8-bit training recipe."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class Numerics:
    """How the model rounds: float32 throughout, or (``fp8``) every tensor
    that a bf16 configuration holds in its compute dtype (each product's
    operands and output, the lookups, the towers' and blocks' outputs and
    the residual stream) rounded to float8 e4m3 and its gradient to e5m2,
    each with a per-tensor scale, products accumulated in f32."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _Float8.apply(x) if self.fp8 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.act(torch.matmul(self.act(a), self.act(b)))


def feature_offsets(vocab: int):
    """Row offsets of the fused feature table: item sparse, user sparse,
    then user array features, each ``vocab + 1`` rows; total rows."""
    n = ITEM_SPARSE + USER_SPARSE + USER_ARRAY
    offs = [f * (vocab + 1) for f in range(n)]
    return offs, n * (vocab + 1) + 1


def layernorm(x, scale, bias, eps: float = 1e-8):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _rows(table, ids):
    """``table[ids]``, a zero row (and no gradient) for id 0."""
    return F.embedding(ids, table, padding_idx=0)


def _feat(P, vals, offs):
    """[..., F] values at fused offsets ``offs`` -> [..., F * D]."""
    o = torch.as_tensor(offs, device=vals.device)
    rows = _rows(P["fused_feat"], torch.where(vals > 0, vals.long() + o, 0))
    return rows.flatten(-2)


class Reference:
    """The model of one configuration: ``mm(ids)`` gives the items'
    multimodal vectors and ``feats(ids)`` their 14 sparse values;
    ``remap(ids)``, where given, the rows of ``item_emb`` that hold the ids
    (a compact row set of a 100M-row table)."""

    def __init__(self, cfg: Mapping, mm: Callable, feats: Callable,
                 nm: Numerics, remap: Optional[Callable] = None):
        m = cfg["model"]
        self.D, self.NB, self.H = m["hidden_units"], m["num_blocks"], \
            m["num_heads"]
        self.buckets = m["hstu_rel_pos_buckets"]
        self.vocab = cfg["data"]["feature_vocab"]
        self.offs, _ = feature_offsets(self.vocab)
        self.mm_vec, self.feats, self.nm, self.remap = mm, feats, nm, remap

    def item_tower(self, P, ids, sparse):
        nm = self.nm
        mmv = nm.act(nm.mm(self.mm_vec(ids), P["mm_proj/81/w"])
                     + P["mm_proj/81/b"])
        rows = _rows(P["item_emb"], ids if self.remap is None
                     else self.remap(ids))
        x = torch.cat([rows, _feat(P, sparse, self.offs[:ITEM_SPARSE]), mmv],
                      -1)
        return nm.act(F.relu(nm.mm(nm.act(x), P["itemdnn/w"])
                             + P["itemdnn/b"]))

    def user_tower(self, P, uids, sparse, arrays):
        o = self.offs[ITEM_SPARSE:]
        sp = _feat(P, sparse, o[:USER_SPARSE])
        oa = torch.as_tensor(o[USER_SPARSE:], device=arrays.device)
        ar = _rows(P["fused_feat"], torch.where(
            arrays > 0, arrays.long() + oa[:, None], 0)).sum(-2).flatten(-2)
        x = torch.cat([_rows(P["user_emb"], uids), sp, ar], -1)
        return self.nm.act(F.relu(self.nm.mm(self.nm.act(x), P["userdnn/w"])
                                  + P["userdnn/b"]))

    def hstu(self, P, i, h, key_valid):
        nm, D, H = self.nm, self.D, self.H
        B, L, _ = h.shape
        hd = D // H
        uvqk = nm.act(F.silu(nm.mm(h, P["blocks/hstu/uvqk/w"][i])
                             + P["blocks/hstu/uvqk/b"][i]))
        u, v, q, k = torch.split(uvqk, D, dim=-1)

        def heads(t):
            return t.reshape(B, L, H, hd).transpose(1, 2)

        s = nm.mm(heads(q), heads(k).transpose(-1, -2)) * hd ** -0.5
        pos = torch.arange(L, device=h.device)
        dist = (pos[:, None] - pos[None, :]).clamp(0, self.buckets - 1)
        s = s + F.embedding(dist, P["blocks/hstu/rab"][i].T) \
            .permute(2, 0, 1)[None]
        mask = (pos[None, :] <= pos[:, None])[None, None] \
            & key_valid[:, None, None, :]
        a = F.silu(s) * mask / L
        av = nm.mm(a, heads(v)).transpose(1, 2).reshape(B, L, D)
        y = layernorm(av, P["blocks/hstu/attn_ln/scale"][i],
                      P["blocks/hstu/attn_ln/bias"][i]) * u
        return nm.mm(y, P["blocks/hstu/out/w"][i]) + P["blocks/hstu/out/b"][i]

    def ffn(self, P, i, h):
        x1, x3 = torch.chunk(self.nm.mm(h, P["blocks/ffn/w13"][i]), 2, -1)
        return self.nm.mm(F.silu(x1) * x3, P["blocks/ffn/w2"][i])

    def encode(self, P, b):
        """[B, L, D] encodings of a batch (dict of tensors)."""
        seq, tt = b["seq"].long(), b["token_type"]
        it = self.item_tower(P, torch.where(tt == 1, seq, 0),
                             b["seq_item_sparse"])
        ut = self.user_tower(P, torch.where(tt == 2, seq, 0),
                             b["seq_user_sparse"], b["seq_user_array"])
        B, L = seq.shape
        act = self.nm.act
        x = act((it + ut) * math.sqrt(self.D))
        pidx = torch.arange(1, L + 1, device=seq.device)[None] * (seq != 0)
        x = act(x + _rows(P["pos_emb"], pidx))
        valid = tt != 0
        for i in range(self.NB):
            x = act(x + self.hstu(P, i, layernorm(
                x, P["blocks/attn_ln/scale"][i], P["blocks/attn_ln/bias"][i]),
                valid))
            x = act(x + self.ffn(P, i, layernorm(
                x, P["blocks/ffn_ln/scale"][i], P["blocks/ffn_ln/bias"][i])))
        return act(layernorm(x, P["last_ln/scale"], P["last_ln/bias"]))

    def loss_sum(self, P, b):
        """(sum of the BCE terms over the masked positions, their count)."""
        lf = self.encode(P, b)
        pos, neg = b["pos"].long(), b["neg"].long()
        pe = self.item_tower(P, pos, b["pos_item_sparse"])
        ne = self.item_tower(P, neg, self.feats(neg))
        m = ((b["next_token_type"] == 1)
             & (b["sample_valid"][:, None] > 0)).float()
        pl, nl = (lf * pe).sum(-1), (lf * ne).sum(-1)
        bce = F.softplus(-pl) + F.softplus(nl)
        return (bce * m).sum(), m.sum()

    @torch.no_grad()
    def queries(self, P, b):
        return self.encode(P, b)[:, -1, :]
