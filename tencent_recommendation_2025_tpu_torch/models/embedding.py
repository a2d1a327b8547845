"""Embedding tables and feature-fusion towers.

Counterpart of ``tencent_recommendation_2025_tpu/models/embedding.py``:

- the per-feature sparse and array tables live in ONE fused table addressed
  by per-feature row offsets (data/featurizer.FusedVocab);
- ``padding_idx=0`` is a functional mask: looked-up rows are multiplied by
  ``(id != 0)``;
- multimodal vectors live in dense id-indexed tables and are gathered by
  item id.

Parameters are a plain nested dict of tensors with the JAX pytree's names:

    item_emb   [I+1, D]      user_emb [U+1, D]     pos_emb [2*maxlen+1, D]
    fused_feat [R, D]        mm_proj  {fid: {w,b}} itemdnn/userdnn {w,b}

The JAX package stores an item table of 30M+ rows packed as [Vp/R, 8, 128]
for the TPU's layout, Vp the rows padded to a multiple of 256; the port
keeps it [Vp, D], the same bytes row-major, with zero pad rows
(ops/sparse_table.py). Under sparse-table training a table is a
:class:`ops.sparse_table.GatheredRows` inside the step, and every lookup of
it names its call site (``site``) for the host plans; on a data mesh a
table row-sharded over its shards is a
:class:`parallel.sharded_embedding.ShardedTable` there. On a model mesh
the tower DNNs and ``mm_proj`` are column-split
(:class:`parallel.partition.ModelShards`): each shard computes its columns
and :func:`linear` gathers them whole.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from ..config import MAX_USER_TOKENS_PER_ROW, ModelConfig
from ..data import schema as S
from ..data.featurizer import FusedVocab
from ..data.schema import FeatureSchema
from ..ops.sparse_table import GatheredRows, is_packed_scale, \
    padded_table_rows
from ..parallel.partition import ModelShards, column_parallel
from ..parallel.sharded_embedding import (ShardedTable, StaticTable,
                                          _RowTake, sharded_lookup,
                                          static_lookup)

#: vocabularies up to this size run the JAX forward as one-hot matmuls,
#: which give a ZERO row for an id above the vocabulary (a gather would read
#: the next feature's row); the port reproduces that
ONEHOT_FWD_MAX_VOCAB = 1024
#: up to this size the JAX package takes the table gradient as one-hot
#: products (``_fused_lookup_onehot_bwd``, and the one-hot forward's
#: transpose): an id above its slot's vocabulary matches no one-hot column
#: and sends NO gradient, though the gather forward reads row offset + id
#: (the next feature's); the port sums the same rows, bitwise repeatably
#: (``parallel.sharded_embedding.row_grad_sum``)
ONEHOT_BWD_MAX_VOCAB = 16384


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# ---------------------------------------------------------------------------
# Initializers (xavier-normal for >=2-D, zeros for 1-D, padding row zeroed)
# ---------------------------------------------------------------------------

def xavier_normal(gen: torch.Generator, shape, dtype=torch.float32):
    assert len(shape) >= 2, "xavier init is for >=2-D params"
    fan_in = int(np.prod(shape[:-1]))
    fan_out = shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return (torch.randn(tuple(shape), generator=gen) * std).to(dtype)


def _emb_init(gen, rows, dim, dtype=torch.float32):
    w = xavier_normal(gen, (rows, dim), dtype)
    w[0] = 0.0
    return w


def linear_init(gen, d_in, d_out):
    return {"w": xavier_normal(gen, (d_in, d_out)),
            "b": torch.zeros(d_out)}


def linear(p, x):
    """``x @ w + b``; a column-split ``w`` (a ``ModelShards`` on a model
    mesh) gives each shard's columns, gathered whole over the model group
    (``gather_from_model``), as the JAX package's SPMD result is."""
    if isinstance(p["w"], ModelShards):
        out = column_parallel(x, p["w"], p["b"])
        return out.mesh.gather_from_model(out.parts)
    return x @ p["w"] + p["b"]


def layernorm_init(dim, scale_init: float):
    return {"scale": torch.full((dim,), float(scale_init)),
            "bias": torch.zeros(dim)}


def layernorm(p, x, eps: float = 1e-8):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def tower_dims(cfg: ModelConfig, schema: FeatureSchema) -> Tuple[int, int]:
    D = cfg.hidden_units
    userdim = D * (len(S.USER_SPARSE_IDS) + 1 + len(S.USER_ARRAY_IDS)) \
        + len(S.USER_CONTINUAL_IDS)
    itemdim = D * (len(S.ITEM_SPARSE_IDS) + 1 + len(S.ITEM_ARRAY_IDS)) \
        + len(S.ITEM_CONTINUAL_IDS) + D * len(schema.mm_emb_ids)
    return userdim, itemdim


def _big_table_init(gen: torch.Generator, rows: int, dim: int, dtype,
                    device) -> torch.Tensor:
    """An item table at packed scale, [padded_table_rows(rows), dim]: drawn
    on ``device`` in ``dtype`` from a generator there, seeded from ``gen``
    (a 100M-row table drawn on the CPU would take minutes and 25.6 GB of
    host f32); row 0 and the pad rows zero."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    dgen = torch.Generator(device=device).manual_seed(seed)
    w = torch.empty((padded_table_rows(rows), dim), dtype=dtype,
                    device=device)
    std = math.sqrt(2.0 / (rows + dim))
    chunk = 1 << 22
    for lo in range(0, rows, chunk):
        hi = min(lo + chunk, rows)
        w[lo:hi] = torch.randn((hi - lo, dim), generator=dgen,
                               device=device) * std
    w[0] = 0.0
    w[rows:] = 0.0
    return w


def init_embedding_params(gen: torch.Generator, cfg: ModelConfig,
                          schema: FeatureSchema, fused: FusedVocab,
                          usernum: int, itemnum: int,
                          device="cpu") -> Dict:
    """Parameters drawn on the CPU, except an item table at packed scale,
    which is drawn on ``device`` (:func:`_big_table_init`)."""
    userdim, itemdim = tower_dims(cfg, schema)
    D = cfg.hidden_units
    big = cfg.pack_big_tables and is_packed_scale(itemnum + 1, D)
    params = {
        "item_emb": _big_table_init(gen, itemnum + 1, D,
                                    torch_dtype(cfg.table_dtype), device)
        if big else _emb_init(gen, itemnum + 1, D,
                              torch_dtype(cfg.table_dtype)),
        "user_emb": _emb_init(gen, usernum + 1, D),
        "pos_emb": _emb_init(gen, 2 * cfg.maxlen + 1, D),
        "fused_feat": _emb_init(gen, fused.total_rows, D),
        "itemdnn": linear_init(gen, itemdim, D),
        "userdnn": linear_init(gen, userdim, D),
        "mm_proj": {},
    }
    for fid in schema.mm_emb_ids:
        params["mm_proj"][fid] = linear_init(gen, schema.item_emb_dims[fid],
                                             D)
    return params


# ---------------------------------------------------------------------------
# Lookups
# ---------------------------------------------------------------------------

class _ClampedTake(torch.autograd.Function):
    """``table[clamp(ids)]`` whose backward drops id 0 and every id past the
    table's end, as the JAX package's ``_zst_bwd`` does (its scatter's
    mode='drop'): the forward reads the last row for such an id, but its
    gradient lands nowhere."""

    @staticmethod
    def forward(ctx, table, ids):
        ids = ids.long()
        ctx.save_for_backward(ids)
        ctx.shape = table.shape
        return table[ids.clamp(0, table.shape[0] - 1)]

    @staticmethod
    def backward(ctx, cot):
        (ids,) = ctx.saved_tensors
        ok = (ids > 0) & (ids < ctx.shape[0])
        cot = cot * ok[..., None].to(cot.dtype)
        dtable = cot.new_zeros(ctx.shape).index_add_(
            0, torch.where(ok, ids, 0).reshape(-1),
            cot.reshape(-1, ctx.shape[1]))
        return dtable, None


def masked_take(table, ids: torch.Tensor, dtype=None,
                site: Optional[str] = None,
                grad_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[ids] * (ids != 0)``: the padding-row-0 contract. Out-of-range
    ids clamp to the table's ends (the JAX gather's mode='clip') and send
    no gradient to the table. ``table`` may be a :class:`GatheredRows`
    (sparse-table training): ids then resolve against its rows, by the
    host plan of call site ``site`` where the step ships one; or a
    :class:`parallel.sharded_embedding.ShardedTable` (a table row-sharded on
    a data mesh): ids then resolve by ``sharded_lookup``, where an id past
    the padded table gives a zero row. ``grad_ids`` (a plain or sharded
    table): the row each id's gradient goes to, -1 for none, summed
    bitwise repeatably (the one-hot backward of
    :func:`fused_feature_lookup`)."""
    if isinstance(table, GatheredRows):
        if grad_ids is not None:
            raise ValueError("grad_ids takes a plain or a sharded table")
        emb = table.lookup(ids, site=site)
    elif isinstance(table, ShardedTable):
        emb = sharded_lookup(table.mesh, table, ids, grad_ids=grad_ids)
    elif grad_ids is not None:
        emb = _RowTake.apply(table, ids.long().clamp(0, table.shape[0] - 1),
                             grad_ids)
    else:
        emb = _ClampedTake.apply(table, ids)
    if dtype is not None:
        emb = emb.to(dtype)
    return emb * (ids != 0)[..., None].to(emb.dtype)


def fused_feature_lookup(fused_table: torch.Tensor, ids: torch.Tensor,
                         offsets, dtype=None,
                         sizes=None) -> torch.Tensor:
    """ids [..., F] with per-slot offsets [F] -> embeddings [..., F, D].

    Row = offset[f] + id when id > 0, the shared zero row otherwise. With
    per-slot vocabulary ``sizes`` no larger than ONEHOT_FWD_MAX_VOCAB, ids
    above their vocabulary give zero rows, as the JAX one-hot forward does;
    no larger than ONEHOT_BWD_MAX_VOCAB, the gradient is the JAX one-hot
    backward's (``_fused_lookup_onehot_bwd``, ``_fl_bwd``): f32 sums of
    the cotangents of the ids in (0, vocab] at offset + id (slots that
    share an offset into one slice), nothing for an id above its
    vocabulary (whose forward, past ONEHOT_FWD_MAX_VOCAB, still reads row
    offset + id), zero elsewhere, summed in a fixed order.
    """
    offsets = torch.as_tensor(np.asarray(offsets), dtype=torch.long,
                              device=ids.device)
    keep = ids > 0
    grad_ids = None
    if sizes is not None and max(sizes) <= ONEHOT_BWD_MAX_VOCAB:
        sz = torch.as_tensor(np.asarray(sizes), dtype=torch.long,
                             device=ids.device)
        live = keep & (ids <= sz)
        grad_ids = torch.where(live, ids.long() + offsets,
                               torch.full_like(ids, -1, dtype=torch.long))
        if max(sizes) <= ONEHOT_FWD_MAX_VOCAB:
            keep = live
    global_ids = torch.where(keep, ids.long() + offsets,
                             torch.zeros_like(ids, dtype=torch.long))
    return masked_take(fused_table, global_ids, dtype=dtype,
                       grad_ids=grad_ids)


def _slot_layout(fused: FusedVocab, fids):
    return ([fused.offsets[fused.slot(f)] for f in fids],
            list(fused.group_sizes(fids)))


def _array_feature_lookup(table, ids, fused: FusedVocab, fids, dtype):
    """Array features [..., F, CAP] -> per-feature summed embeddings
    [..., F, D]."""
    *lead, F, CAP = ids.shape
    flat = ids.reshape(*lead, F * CAP)
    offs, sizes = _slot_layout(fused, fids)
    emb = fused_feature_lookup(table, flat, np.repeat(offs, CAP),
                               dtype=dtype, sizes=np.repeat(sizes, CAP))
    return emb.reshape(*lead, F, CAP, -1).sum(dim=-2)


def _cast_linear(p, dtype):
    return {"w": p["w"].to(dtype), "b": p["b"].to(dtype)}


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------

def item_tower(params: Mapping, ids: torch.Tensor,
               item_sparse: torch.Tensor, item_array: torch.Tensor,
               mm_vecs: Mapping[str, torch.Tensor],
               fused: FusedVocab, schema: FeatureSchema,
               cfg: ModelConfig,
               lookup_site: Optional[str] = None,
               item_emb_override: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Item-token embedding: id emb ++ sparse ++ array-sum ++ mm-proj -> DNN
    (feature order: id, ITEM_SPARSE, ITEM_ARRAY, continual, mm).
    ``lookup_site`` names this call site for the sparse-training plans;
    ``item_emb_override``, the id embeddings looked up before (the explicit
    all-to-all of ``models.baseline.SeqRecModel._ep_override``)."""
    dtype = torch_dtype(cfg.dtype)
    feats = [item_emb_override.to(dtype) if item_emb_override is not None
             else masked_take(params["item_emb"], ids, dtype=dtype,
                              site=lookup_site)]
    if fused.n_item_sparse:
        offs, sizes = _slot_layout(fused, S.ITEM_SPARSE_IDS)
        sp = fused_feature_lookup(params["fused_feat"], item_sparse, offs,
                                  dtype=dtype, sizes=sizes)
        feats.append(sp.reshape(*sp.shape[:-2], -1))
    if fused.n_item_array:
        ar = _array_feature_lookup(params["fused_feat"], item_array, fused,
                                   S.ITEM_ARRAY_IDS, dtype)
        feats.append(ar.reshape(*ar.shape[:-2], -1))
    for fid in schema.mm_emb_ids:
        feats.append(linear(_cast_linear(params["mm_proj"][fid], dtype),
                            mm_vecs[fid].to(dtype)))
    x = torch.cat(feats, dim=-1)
    return Fn.relu(linear(_cast_linear(params["itemdnn"], dtype), x))


def user_tower(params: Mapping, ids: torch.Tensor,
               user_sparse: torch.Tensor, user_array: torch.Tensor,
               fused: FusedVocab, cfg: ModelConfig,
               lookup_site: Optional[str] = None) -> torch.Tensor:
    dtype = torch_dtype(cfg.dtype)
    feats = [masked_take(params["user_emb"], ids, dtype=dtype,
                         site=lookup_site)]
    if fused.n_user_sparse:
        offs, sizes = _slot_layout(fused, S.USER_SPARSE_IDS)
        sp = fused_feature_lookup(params["fused_feat"], user_sparse, offs,
                                  dtype=dtype, sizes=sizes)
        feats.append(sp.reshape(*sp.shape[:-2], -1))
    if fused.n_user_array:
        ar = _array_feature_lookup(params["fused_feat"], user_array, fused,
                                   S.USER_ARRAY_IDS, dtype)
        feats.append(ar.reshape(*ar.shape[:-2], -1))
    x = torch.cat(feats, dim=-1)
    return Fn.relu(linear(_cast_linear(params["userdnn"], dtype), x))


def static_take(table, ids: torch.Tensor) -> torch.Tensor:
    """A static table's rows by id, out-of-range ids clamped to its ends
    (the JAX gather's mode='clip'); ``table`` may be a
    :class:`parallel.sharded_embedding.StaticTable` (row-sharded on a data
    mesh: ``static_lookup``, which clamps to the real rows too)."""
    if isinstance(table, StaticTable):
        return static_lookup(table, ids)
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def gather_mm(mm_tables: Mapping[str, torch.Tensor], ids: torch.Tensor,
              schema: FeatureSchema, dtype=None) -> Dict[str, torch.Tensor]:
    """Gather frozen multimodal vectors by item id (id 0 hits the zero row;
    out-of-range ids clamp): :func:`static_take`."""
    out = {}
    for fid in schema.mm_emb_ids:
        v = static_take(mm_tables[fid], ids)
        out[fid] = v.to(dtype) if dtype is not None else v
    return out


def fuse_sequence(params: Mapping, batch: Mapping, mm_tables: Mapping,
                  fused: FusedVocab, schema: FeatureSchema,
                  cfg: ModelConfig, return_item_tower: bool = False,
                  item_tower_override: Optional[torch.Tensor] = None,
                  item_emb_override: Optional[torch.Tensor] = None):
    """Both towers over the sequence, added (include_user=True fusion). Ids
    are multiplied by their token-type mask before lookup.

    The user tower runs on the first MAX_USER_TOKENS_PER_ROW user positions
    of each row and the all-zero-input constant is broadcast elsewhere:
    exact, because user features are zero-filled at non-user positions.

    ``item_tower_override``: the whole item tower [B, L, D], computed before
    (the tower-dedup spread, models/baseline.dedup_spreads); the batch's
    per-position item features are not read then. ``return_item_tower``
    also returns the item tower, which the positives reuse.
    ``item_emb_override``: the item tokens' id embeddings, looked up before
    (:func:`item_tower`)."""
    seq = batch["seq"]
    tt = batch["token_type"]
    zero = torch.zeros_like(seq)
    user_ids = torch.where(tt == 2, seq, zero)
    dtype = torch_dtype(cfg.dtype)
    if item_tower_override is not None:
        it = item_tower_override.to(dtype)
    else:
        item_ids = torch.where(tt == 1, seq, zero)
        mm_vecs = gather_mm(mm_tables, item_ids, schema, dtype=dtype)
        it = item_tower(params, item_ids, batch["seq_item_sparse"],
                        batch["seq_item_array"], mm_vecs, fused, schema, cfg,
                        lookup_site="seq",
                        item_emb_override=item_emb_override)

    K = MAX_USER_TOKENS_PER_ROW
    B, L = seq.shape
    is_u = tt == 2
    iota = torch.arange(L, device=seq.device)
    score = torch.where(is_u, -iota[None, :].expand(B, L),
                        torch.full_like(seq, -L - 1, dtype=torch.long))
    posk = torch.topk(score, K, dim=1).indices                 # [B, K]
    validk = torch.gather(is_u, 1, posk)                       # [B, K]
    vk = validk.to(seq.dtype)
    uk = torch.gather(user_ids, 1, posk) * vk
    rows = torch.arange(B, device=seq.device)[:, None]
    spk = batch["seq_user_sparse"][rows, posk] * vk[..., None]
    ark = batch["seq_user_array"][rows, posk] * vk[..., None, None]
    utk = user_tower(params, uk, spk, ark, fused, cfg,
                     lookup_site="user")                       # [B, K, D]

    def zshape(t):
        return torch.zeros((1, 1) + tuple(t.shape[2:]), dtype=t.dtype,
                           device=t.device)

    const = user_tower(params, zshape(uk), zshape(spk), zshape(ark),
                       fused, cfg)                             # [1, 1, D]
    onehot = ((posk[:, :, None] == iota[None, None, :])
              & validk[:, :, None]).to(dtype)                  # [B, K, L]
    ut = const + torch.einsum("bkl,bkd->bld", onehot,
                              (utk - const).to(dtype))
    if return_item_tower:
        return it + ut, it
    return it + ut
