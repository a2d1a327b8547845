"""Row-sharded learned tables and their lookups on a data (x model) mesh.

Counterpart of ``tencent_recommendation_2025_tpu/parallel/sharded_embedding.
py``. The learned tables (``item_emb``, ``user_emb``, ``fused_feat``: the
JAX partition rules' table leaves) row-shard over the mesh's table axes:
with S = :func:`num_table_shards`, shard s holds rows ``[s * V / S, (s + 1)
* V / S)`` of the table padded to a multiple of S (:func:`pad_rows`; the pad
rows are zero and never addressed). A process of a process mesh holds the
block of its (data, model) index (``mesh.table_index``); a local mesh
holds the padded table, whose row blocks are the shards.

Inside a step the trainer hands the model a :class:`ShardedTable` in place
of each such leaf; ``models.embedding.masked_take`` dispatches on it, so
every lookup of a row-sharded table is :func:`sharded_lookup`, the port's
explicit form of the gather XLA partitions for the JAX package:

1. all-gather the ids over the data group (every shard sees the global
   batch's ids);
2. each shard takes the rows it owns, zeros elsewhere (and for the padding
   id 0);
3. on a model mesh a sum over the model group combines the shards of one
   data index (``reduce_from_model``), then a reduce-scatter sums the
   shards' rows and hands each data rank back its own batch rows.

Its backward all-gathers the cotangent and scatter-adds it into each
shard's owned rows (the fused-feature lookups' one-hot backward sums them
in a fixed order instead, :func:`row_grad_sum`): every shard receives its
rows' gradient over the global batch, and nothing else of the table
crosses the mesh.

:func:`sharded_lookup_a2a` is the item-id lookup of a data-only mesh
(``models.baseline.SeqRecModel._ep_override``; never on a model mesh, as
in the JAX package): each data rank buckets its
ids by owner into static buckets of ``cap`` slots, one all-to-all sends
them, the owners take their rows, a second all-to-all returns them. An id
past its bucket's capacity returns a zero row, loses its gradient and is
counted (``ep_overflow``), exactly as in the JAX package.

On a local mesh the data shards run one after another in one process, so a
lookup sees one data shard's ids: :func:`sharded_lookup` there is the sum of
every table shard's owned take, which is one masked take of the padded
table (each id has one owner), and :func:`sharded_lookup_a2a` buckets that
shard's ids and reads each bucket from its owner's block.

The static item-feature tables (the item ``sparse`` table, int32, and each
``mm`` table, f32: frozen, read by id) row-shard over the same axes on a
data mesh (:func:`shard_tables`, the JAX ``parallel/train.shard_tables``,
which ``parallel.train`` exports): every 2-D table of more than 64 rows
becomes a :class:`StaticTable`, padded to a multiple of S, of which a
process holds its block (copied alone from the host). :func:`static_lookup` takes it as
:func:`sharded_lookup` takes a learned table, forward only, for any dtype,
with two differences: ids clamp to the table's *real* last row before the
owner is chosen (the single device's clamp; the JAX mesh's clip reaches a
zero pad row instead), and id 0 reads row 0 as it is. One owner's row
summed with zeros is exact, so the lookup equals the whole table's take
bitwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from .mesh import table_index, table_shards

#: the learned tables the JAX partition rules row-shard (``PARAM_RULES``)
SHARDED_TABLES = ("item_emb", "user_emb", "fused_feat")


def num_table_shards(mesh, axes: Tuple[str, ...] = ("data", "model")) -> int:
    """The product of ``mesh``'s sizes on ``axes``."""
    return int(np.prod([mesh.shape.get(a, 1) for a in axes]))


def pad_rows(table: torch.Tensor, n_shards: int) -> torch.Tensor:
    """``table`` with its rows zero-padded to a multiple of ``n_shards``
    (the pad rows are never addressed: ids stay below the real rows)."""
    rows = table.shape[0]
    padded = n_shards * (-(-rows // n_shards))
    if padded == rows:
        return table
    return torch.cat([table, table.new_zeros((padded - rows,)
                                             + tuple(table.shape[1:]))])


@dataclasses.dataclass
class ShardedTable:
    """A learned table row-sharded over ``mesh``'s table axes: ``blocks``
    are the row blocks this process holds (its data index's on a process
    mesh; on a local mesh the S row blocks of ``whole``, the padded table,
    as views). Shard s owns rows [s * rows_per_shard, (s + 1) *
    rows_per_shard)."""

    blocks: List[torch.Tensor]
    mesh: object
    whole: Optional[torch.Tensor] = None

    @classmethod
    def of_leaf(cls, leaf: torch.Tensor, mesh) -> "ShardedTable":
        """The table a train state's leaf holds on ``mesh``: this process's
        block on a process mesh, the padded table on a local one."""
        if mesh.process:
            return cls([leaf], mesh)
        S = table_shards(mesh)
        if leaf.shape[0] % S:
            raise ValueError(f"a table of {leaf.shape[0]} rows does not "
                             f"split into {S} shards: pad it (pad_rows)")
        return cls(list(leaf.chunk(S)), mesh, leaf)

    @property
    def rows_per_shard(self) -> int:
        return self.blocks[0].shape[0]

    @property
    def shape(self) -> Tuple[int, ...]:
        """The padded table's shape, [S * rows_per_shard, D]."""
        return (self.rows_per_shard * table_shards(self.mesh),) \
            + tuple(self.blocks[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def sum_squares(self) -> torch.Tensor:
        """The sum of every element's square over the whole table, in f32
        (differentiable; summed over the data group on a process mesh)."""
        if self.whole is not None:
            return (self.whole.float() ** 2).sum()
        return self.mesh.sum_data([_sum_model(
            self.mesh, (self.blocks[0].float() ** 2).sum())])


def table_block(t: torch.Tensor, mesh) -> torch.Tensor:
    """A whole table leaf (a table, its moment or its row state) on
    ``mesh``: zero-padded to a multiple of the table shards, then this
    process's row block (a copy) on a process mesh, the padded leaf on a
    local one."""
    S = table_shards(mesh)
    t = pad_rows(t, S)
    if not mesh.process:
        return t
    rps = t.shape[0] // S
    lo = table_index(mesh) * rps
    return t[lo:lo + rps].clone()


def shard_table(mesh, table: torch.Tensor) -> ShardedTable:
    """A whole [V, D] table row-sharded on ``mesh`` (:func:`table_block`)."""
    return ShardedTable.of_leaf(table_block(table, mesh), mesh)


def shard_view(params: Mapping, mesh) -> dict:
    """``params`` with each row-sharded table leaf (a tensor under
    :data:`SHARDED_TABLES`) as a :class:`ShardedTable`, where ``mesh`` has
    more than one table shard; the dict itself otherwise."""
    if mesh is None or table_shards(mesh) == 1:
        return dict(params)
    return {k: ShardedTable.of_leaf(v, mesh)
            if k in SHARDED_TABLES and isinstance(v, torch.Tensor) else v
            for k, v in params.items()}


def row_grad_sum(rows: torch.Tensor, cot: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """[n_rows, D] f32: row r holds the sum of ``cot[i]`` over the i whose
    ``rows[i]`` is r; an index outside [0, n_rows) sends nothing. Bitwise
    repeatable on the card: no atomic add, as the JAX package's one-hot
    products sum in a fixed order where ``index_add_`` on the card does
    not. A stable sort of the rows, the cotangent gathered in that order,
    then a segmented sum in two levels (``torch.segment_reduce``, whose
    threads each add one segment's terms in order): pieces cut at every
    row's start and every C-th entry (C about sqrt(N)), then each row's
    pieces, so that no thread walks more than about sqrt(N) terms where a
    row of a small vocabulary holds thousands of ids."""
    flat = rows.reshape(-1).long()
    n = flat.shape[0]
    x = cot.reshape(n, cot.shape[-1]).float()
    key = torch.where((flat >= 0) & (flat < n_rows), flat,
                      torch.full_like(flat, n_rows))
    key, order = torch.sort(key, stable=True)
    x = x[order]
    dev = key.device
    ends = torch.arange(n_rows + 1, device=dev)
    chunk = max(64, math.isqrt(n))
    cuts = torch.sort(torch.cat([torch.searchsorted(key, ends),
                                 torch.arange(0, n, chunk, device=dev)]))[0]
    # the offsets are well formed by construction: no checks (a host sync)
    part = torch.segment_reduce(x, "sum", offsets=cuts, axis=0, unsafe=True)
    # each piece's row, the key at its first entry (past the end: none)
    prow = torch.cat([key, key.new_full((1,), n_rows)])[cuts[:-1]]
    return torch.segment_reduce(part, "sum",
                                offsets=torch.searchsorted(prow, ends),
                                axis=0, unsafe=True)


class _RowTake(torch.autograd.Function):
    """``src[idx]`` (every index within ``src``'s rows). Its backward is one
    ``index_add_`` into zeros, as ``embedding._ClampedTake``'s (PyTorch's
    own indexing backward, an accumulating ``index_put_``, sorts the
    indices first); with ``grad_idx`` it is :func:`row_grad_sum` into the
    rows ``grad_idx`` names instead (-1: no gradient), bitwise
    repeatable."""

    @staticmethod
    def forward(ctx, src, idx, grad_idx=None):
        ctx.save_for_backward(idx if grad_idx is None else grad_idx)
        ctx.summed = grad_idx is not None
        ctx.shape = src.shape
        return src[idx]

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        if ctx.summed:
            grad = row_grad_sum(idx, cot, ctx.shape[0]).to(cot.dtype)
        else:
            flat = idx.reshape(-1)
            grad = cot.new_zeros(ctx.shape).index_add_(
                0, flat,
                cot.reshape((flat.shape[0],) + tuple(ctx.shape[1:])))
        # one gradient per input: apply(src, idx) or apply(src, idx, grad_idx)
        return (grad,) + (None,) * (len(ctx.needs_input_grad) - 1)


def _owned_take(block: torch.Tensor, ids: torch.Tensor, lo: int,
                mask_zero: bool,
                grad_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``block``'s rows for the ids in [lo, lo + rows), zeros for the rest
    (and for id 0 with ``mask_zero``); its backward scatter-adds into the
    owned rows only, or with ``grad_ids`` (a row per id, -1 for none) sums
    into the owned rows those name (:func:`row_grad_sum`)."""
    rel = ids.long() - lo
    owned = (rel >= 0) & (rel < block.shape[0])
    if mask_zero:
        owned = owned & (ids != 0)
    grad_idx = None
    if grad_ids is not None:
        g = grad_ids.long() - lo
        grad_idx = torch.where((grad_ids >= 0) & (g >= 0)
                               & (g < block.shape[0]), g,
                               torch.full_like(g, -1))
    emb = _RowTake.apply(block, rel.clamp(0, block.shape[0] - 1), grad_idx)
    return emb * owned[..., None].to(emb.dtype)


def sharded_lookup(mesh, table: ShardedTable, ids: torch.Tensor,
                   mask_zero: bool = True,
                   grad_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable lookup of a row-sharded table: ``ids`` [B, ...] (this
    data shard's rows) -> [B, ..., D]; id 0 gives a zero row with
    ``mask_zero``, as ``embedding.masked_take``. On a process mesh: the ids
    all-gathered over the data group, each shard's owned rows, on a model
    mesh a sum over the model group (``reduce_from_model``: the shards of
    one data index hold different rows; its backward hands each the
    cotangent), a reduce-scatter back to this rank's rows. ``grad_ids``
    (the one-hot backward of ``embedding.fused_feature_lookup``): the row
    each id's gradient goes to, -1 for none, summed bitwise repeatably
    (:func:`row_grad_sum`)."""
    if mesh.process:
        if grad_ids is None:
            (gids,) = mesh.all_gather([ids])
            ggrad = None
        else:   # one collective: the ids and their gradient rows stacked
            (both,) = mesh.all_gather([torch.stack(
                [ids.long(), grad_ids.long()], dim=-1)])
            gids, ggrad = both.unbind(-1)
        lo = table_index(mesh) * table.rows_per_shard
        emb = _owned_take(table.blocks[0], gids, lo, mask_zero, ggrad)
        (out,) = mesh.reduce_scatter([_sum_model(mesh, emb)])
        return out
    return _owned_take(table.whole, ids, 0, mask_zero, grad_ids)


def _sum_model(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group of a process mesh (in its dtype;
    each id has one owner, so the sum is exact), ``t`` without a model
    axis."""
    if mesh.shape.get("model", 1) == 1:
        return t
    return mesh.reduce_from_model([t]).to(t.dtype)


def dense_lookup_oracle(table: torch.Tensor, ids: torch.Tensor,
                        mask_zero: bool = True) -> torch.Tensor:
    """The single-device semantics (``embedding.masked_take``)."""
    emb = table[ids.long()]
    if mask_zero:
        emb = emb * (ids != 0)[..., None].to(emb.dtype)
    return emb


def _buckets(flat: torch.Tensor, S: int, rps: int, cap: int, sender: int,
             mask_zero: bool):
    """The a2a's bucketing of one data rank's ids: (owner, position in the
    owner's bucket, whether the id has a slot, whether it is a real id,
    the [S, cap] send buckets). Padding ids route to the sending shard and,
    with ``mask_zero``, take no slot; positions are stable within an
    owner."""
    real = flat != 0
    owner = torch.where(real, (flat // rps).clamp(0, S - 1),
                        torch.full_like(flat, sender))
    onehot = Fn.one_hot(owner, S)
    if mask_zero:
        onehot = onehot * real[:, None]
    my_pos = (onehot.cumsum(0) - 1).gather(1, owner[:, None])[:, 0]
    ok = my_pos < cap
    if mask_zero:
        ok = ok & real
    buckets = flat.new_zeros((S, cap))
    buckets[owner[ok], my_pos[ok]] = flat[ok]
    return owner, my_pos, ok, real, buckets


def sharded_lookup_a2a(mesh, table: ShardedTable, ids: torch.Tensor,
                       capacity_factor: float = 4.0, mask_zero: bool = True,
                       return_overflow: bool = False, sender: int = 0):
    """The all-to-all lookup over the ``data`` axis (model must be 1):
    ``ids`` [B, ...] of this data rank -> [B, ..., D].

    The rank buckets its ids by owner (``rows_per_shard = ceil(V / S)``)
    into [S, cap] with ``cap = ceil(n_local / S * capacity_factor)``,
    ``n_local`` counting the padding lanes; padding ids route to the sending
    shard and take no slot under ``mask_zero``. An all-to-all sends the
    buckets, each owner takes its rows, a second all-to-all returns them.
    A real id past its bucket's capacity returns a zero row and drops its
    gradient; with ``return_overflow`` the count of such ids over the data
    group comes back too (on a local mesh, this data shard's count:
    ``sender``, the shard's data index, plays the sending rank).
    """
    if mesh.shape.get("model", 1) != 1:
        raise ValueError("the a2a lookup assumes a model axis of size 1")
    S = mesh.shape["data"]
    rps = table.rows_per_shard
    flat = ids.reshape(-1).long()
    n_local = flat.shape[0]
    cap = int(np.ceil(n_local / S * capacity_factor))
    if mesh.process:
        sender = table_index(mesh)
    owner, my_pos, ok, real, buckets = _buckets(flat, S, rps, cap, sender,
                                                mask_zero)
    if mesh.process:
        (recv,) = mesh.all_to_all([buckets.reshape(S * cap)])
        recv = recv.reshape(S, cap)
        lo = table_index(mesh) * rps
        emb = _RowTake.apply(table.blocks[0], (recv - lo).clamp(0, rps - 1))
    else:
        # what owner s receives from this sender is bucket s; one take of
        # the padded table reads each bucket from its owner's block
        recv = buckets
        lo = torch.arange(S, device=flat.device)[:, None] * rps
        emb = _RowTake.apply(table.whole, (recv - lo).clamp(0, rps - 1) + lo)
    if mask_zero:
        emb = emb * (recv != 0)[..., None].to(emb.dtype)
    D = emb.shape[-1]
    back = mesh.all_to_all([emb.reshape(S * cap, D)])[0] if mesh.process \
        else emb.reshape(S * cap, D)
    got = _RowTake.apply(back, owner * cap + torch.where(ok, my_pos, 0))
    got = torch.where(ok[:, None], got, got.new_zeros(()))
    out = got.reshape(*ids.shape, D)
    if not return_overflow:
        return out
    n_over = (~ok & real).sum()
    if mesh.process:
        n_over = mesh.all_reduce(n_over, "data")
    return out, n_over


# ---------------------------------------------------------------------------
# static tables
# ---------------------------------------------------------------------------

#: a static table row-shards when it is 2-D and has more rows than this
#: (the JAX ``shard_tables`` rule)
STATIC_MIN_ROWS = 64


@dataclasses.dataclass
class StaticTable:
    """A static (frozen) table row-sharded over ``mesh``'s table axes:
    ``blocks`` as :class:`ShardedTable`'s (on a local mesh views of
    ``whole``, the padded table), ``rows`` the table's real rows."""

    blocks: List[torch.Tensor]
    mesh: object
    rows: int
    whole: Optional[torch.Tensor] = None

    @property
    def rows_per_shard(self) -> int:
        return self.blocks[0].shape[0]

    @property
    def shape(self) -> Tuple[int, ...]:
        """The padded table's shape, [S * rows_per_shard, W]."""
        return (self.rows_per_shard * table_shards(self.mesh),) \
            + tuple(self.blocks[0].shape[1:])


def static_table(table, mesh, device=None) -> StaticTable:
    """A whole static table (a host array or a tensor) row-sharded on
    ``mesh``, on ``device`` (default: the tensor's own, else the CPU): on a
    process mesh only this process's block of ``ceil(V / S)`` rows is
    copied there (and zero-padded at the table's end); on a local mesh the
    table zero-padded to S blocks."""
    rows = table.shape[0]
    S = table_shards(mesh)
    rps = -(-rows // S)
    if device is None:
        device = table.device if isinstance(table, torch.Tensor) else "cpu"
    if not mesh.process:
        whole = pad_rows(torch.as_tensor(table, device=device), S)
        return StaticTable(list(whole.chunk(S)), mesh, rows, whole)
    lo = table_index(mesh) * rps
    part = table[lo:lo + rps]
    if isinstance(part, torch.Tensor):
        block = part.to(device, copy=True)
    else:
        block = torch.from_numpy(np.ascontiguousarray(part)).to(device)
    if block.shape[0] < rps:
        block = torch.cat([block, block.new_zeros(
            (rps - block.shape[0],) + tuple(block.shape[1:]))])
    return StaticTable([block], mesh, rows)


def shard_tables(mesh, tables, device=None) -> Any:
    """``tables`` (a dict tree of host arrays or tensors: the trainer's
    ``{"sparse", "array", "mm": {...}}``) with every 2-D table of more than
    :data:`STATIC_MIN_ROWS` rows a :class:`StaticTable` on ``mesh`` and
    every other leaf a tensor on ``device``, whole (the 3-D ``array``
    table, small tables); a :class:`StaticTable` passes as it is. The tree
    as tensors on ``device`` without a mesh or with one table shard."""
    sharded = mesh is not None and table_shards(mesh) > 1

    def put(leaf):
        if isinstance(leaf, Mapping):
            return {k: put(v) for k, v in leaf.items()}
        if isinstance(leaf, StaticTable):
            return leaf
        if sharded and getattr(leaf, "ndim", 0) == 2 \
                and leaf.shape[0] > STATIC_MIN_ROWS:
            return static_table(leaf, mesh, device)
        return torch.as_tensor(leaf, device=device)

    return put(tables)


def owned_rows(block: torch.Tensor, ids: torch.Tensor, lo: int
               ) -> torch.Tensor:
    """``block``'s rows for the ids in [lo, lo + rows), zeros for the rest
    (any dtype; no gradient)."""
    rel = ids - lo
    owned = (rel >= 0) & (rel < block.shape[0])
    rows = block[rel.clamp(0, block.shape[0] - 1)]
    return torch.where(owned[..., None], rows, rows.new_zeros(()))


def static_lookup(table: StaticTable, ids: torch.Tensor) -> torch.Tensor:
    """``table[clamp(ids, 0, rows - 1)]`` of a row-sharded static table:
    ``ids`` [B, ...] (this data shard's rows) -> [B, ..., W]. On a process
    mesh: the clamped ids all-gathered over the data group, each shard's
    owned rows (zeros elsewhere), summed over the model group on a model
    mesh, a reduce-scatter back to this rank's rows; on a local mesh one
    take of the padded table. Equal to the whole table's take bitwise."""
    idx = ids.long().clamp(0, table.rows - 1)
    mesh = table.mesh
    with torch.no_grad():
        if not mesh.process:
            return table.whole[idx]
        (gids,) = mesh.all_gather([idx])
        lo = table_index(mesh) * table.rows_per_shard
        rows = owned_rows(table.blocks[0], gids, lo)
        if mesh.shape.get("model", 1) > 1:
            rows = mesh.all_reduce(rows.contiguous(), "model")
        (out,) = mesh.reduce_scatter([rows])
    return out
