"""Training on a mesh: the train state and the batch of a data shard.

Counterpart of ``tencent_recommendation_2025_tpu/parallel/train.py``. As the
JAX package's partition rules place them, the learned tables (``item_emb``,
``user_emb``, ``fused_feat``), their AdamW moments and their row-optimizer
state row-shard over the mesh's table shards (``parallel.mesh.
table_shards``, pipe x data x model): a process of a process mesh holds the
rows of its (pipe, data, model) index s, [s * V / S, (s + 1) * V / S) of the table padded to
a multiple of S (a table at packed scale is not padded further: its Vp rows
split into whole groups); a local mesh holds the padded table, whose row
blocks are its shards. Every other parameter and its AdamW state is
replicated, one copy per process, except on a model mesh, where each
tensor-parallel leaf (``parallel/partition.py``) and its AdamW moments are
split over the model shards (:func:`land_model`: a process holds its
slice; a local mesh keeps the leaf whole and its steps slice it), and on a
pipe mesh, where each stacked block leaf and its AdamW moments are cut to
the stage's blocks (:func:`land_pipe`; a local mesh keeps them whole). The
trainer runs each data shard's rows (``train/trainer.py``), the tables'
lookups cross the shards (``parallel/sharded_embedding.py``), and the
replicated and split gradients are summed over the replica group. The
static item-feature tables row-shard over the same shards
(:func:`shard_tables`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from ..config import Config
from ..models.baseline import SeqRecModel
from ..train.trainer import (TrainState, batch_rows, init_state,
                             make_train_step)
from .mesh import (batch_index, data_rows, data_size, gather_pipe,
                   model_size, pipe_blocks, pipe_size, table_index,
                   table_shards)
from .partition import join_model, model_dims, shard_slice
# shard_tables (JAX parallel/train.py:159): the static item and mm tables
# row-sharded over the table shards, padded to S, the others whole
from .sharded_embedding import SHARDED_TABLES, shard_tables, table_block


def layout(mesh) -> Optional[tuple]:
    """The layout of a state on ``mesh`` (``TrainState.layout``): ("local",
    S) (whole tensor-parallel leaves, S row blocks of each table);
    ("process", S, this table shard) on a process mesh, followed by
    ("model", M) where M > 1 (each tensor-parallel leaf this process's model
    slice) and ("pipe", P) where P > 1 (each stacked block leaf this
    stage's blocks): :func:`split_axes`; None for whole leaves (S = 1 or no
    mesh)."""
    S = table_shards(mesh)
    if S == 1:
        return None
    if not mesh.process:
        return ("local", S)
    split = [(axis, n) for axis, n in (("model", model_size(mesh)),
                                       ("pipe", pipe_size(mesh))) if n > 1]
    return ("process", S, table_index(mesh), *split)


def split_axes(state_layout: Optional[tuple]) -> Dict[str, int]:
    """The mesh axes over which a state of ``state_layout`` holds leaves in
    slices, with their sizes: "model" (the tensor-parallel leaves) and
    "pipe" (the stacked block leaves); empty where every such leaf is
    whole (no layout, a local mesh)."""
    if state_layout is None or state_layout[0] != "process":
        return {}
    return dict(state_layout[3:])


def _replace_leaf(state: TrainState, path: str, fn, cut=None) -> None:
    """The parameter at tree ``path`` of ``state.params`` and its AdamW
    moments through ``fn``, the optimizer's references moved to the new
    leaf. ``cut(v)``: whether a moment takes ``fn`` too (default: a
    tensor whose leading dim is the leaf's)."""
    *up, name = path.split("/")
    holder = state.params
    for k in up:
        holder = holder[k]
    old = holder[name]
    with torch.no_grad():
        new = fn(old.detach()).requires_grad_(old.requires_grad)
    holder[name] = new
    for group in state.opt.param_groups:
        group["params"] = [new if p is old else p for p in group["params"]]
    if cut is None:
        def cut(v):
            return v.dim() > 0 and v.shape[0] == old.shape[0]
    if old in state.opt.state:
        st = state.opt.state.pop(old)
        state.opt.state[new] = {
            k: fn(v) if isinstance(v, torch.Tensor) and cut(v) else v
            for k, v in st.items()}


def _tensors(state: TrainState, keep):
    """The parameters at the tree paths ``keep`` accepts, then the AdamW
    state of each (its step counts too), in a fixed order."""
    from ..bridge import _flatten

    params = [t for p, t in _flatten(state.params).items() if keep(p)]
    out = [p.data for p in params]
    for p in params:
        st = state.opt.state.get(p, {})
        out += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
    return out


def _broadcast(tensors, src: int = 0, group=None) -> None:
    """The tensors of rank ``src`` to every process of ``group`` (the
    world by default; a tensor off the first one's device, as AdamW keeps
    its step counts, crosses through a copy)."""
    import torch.distributed as dist

    if not tensors:
        return
    dev = tensors[0].device
    with torch.no_grad():
        for t in tensors:
            buf = t if t.device == dev else t.to(dev)
            dist.broadcast(buf, src=src, group=group)
            if buf is not t:
                t.copy_(buf)


def land_model(state: TrainState, mesh) -> TrainState:
    """The tensor-parallel leaves of a state with whole leaves, and their
    AdamW moments, cut to this process's model slice (a process mesh with
    M > 1; ``partition.shard_slice``, JAX ``opt_state_shardings``), in
    place. A local mesh keeps them whole (its steps slice them)."""
    M = model_size(mesh)
    if mesh is None or not mesh.process or M == 1:
        return state
    for path, dim in model_dims(state.params).items():
        def fn(t, path=path, dim=dim):
            return shard_slice(t, path, dim, M, mesh.model_index).clone()

        shape = _leaf(state.params, path).shape
        _replace_leaf(state, path, fn, cut=lambda v, shape=shape:
                      tuple(v.shape) == tuple(shape))
    return state


def _block_paths(params):
    from ..bridge import _flatten

    return [p for p in _flatten(params) if p.startswith("blocks/")]


def land_pipe(state: TrainState, mesh) -> TrainState:
    """Every stacked block leaf of a state with whole leaves, and its AdamW
    moments, cut to this stage's blocks (a process mesh with pipe > 1;
    :func:`parallel.mesh.pipe_blocks`), in place. A local mesh keeps them
    whole (its stages slice them)."""
    if mesh is None or not mesh.process or pipe_size(mesh) == 1:
        return state
    for path in _block_paths(state.params):
        nb = _leaf(state.params, path).shape[0]
        rows = pipe_blocks(nb, mesh)
        _replace_leaf(state, path, lambda t, rows=rows: t[rows].clone(),
                      cut=lambda v, nb=nb: v.dim() > 0 and v.shape[0] == nb)
    return state


def whole_pipe(state: TrainState, mesh) -> TrainState:
    """The stacked block leaves of a state holding this stage's blocks, and
    their AdamW moments, whole again (gathered over the pipe group), in
    place."""
    for path in _block_paths(state.params):
        nb = _leaf(state.params, path).shape[0]
        _replace_leaf(state, path, lambda t: gather_pipe(t, mesh),
                      cut=lambda v, nb=nb: v.dim() > 0 and v.shape[0] == nb)
    return state


def _leaf(params, path):
    for k in path.split("/"):
        params = params[k]
    return params


def _land_tables(state: TrainState, mesh) -> TrainState:
    """The state's tables, their AdamW moments and their row state cut to
    this process's rows of ``mesh`` (:func:`table_block`), in place; a
    state already in the mesh's layout as it is."""
    want = layout(mesh)
    if state.layout == want:
        return state
    if state.layout is not None:
        raise ValueError(f"a train state laid out for {state.layout} cannot "
                         f"land on a mesh of layout {want}: save it and "
                         "load it there")
    for name in SHARDED_TABLES:
        if isinstance(state.params.get(name), torch.Tensor):
            _replace_leaf(state, name, lambda t: table_block(t, mesh))
    for opt in state.tables.values():
        for k in opt:
            opt[k] = table_block(opt[k], mesh)
    land_model(state, mesh)
    land_pipe(state, mesh)
    state.layout = want
    return state


def shard_existing_state(mesh, state: TrainState) -> TrainState:
    """Land a train state on ``mesh``, in place: the resume path. Its
    tables cut to this process's rows and its tensor-parallel leaves to its
    model slice (a whole table is never broadcast; a state already in the
    mesh's layout, from ``load_checkpoint(mesh=...)``, keeps them); on a
    process mesh the replicated tensors and the step become rank 0's, each
    model slice the first replica's of its model index and each stage's
    blocks its first data rank's (broadcasts), so that the replicas start
    equal."""
    _land_tables(state, mesh)
    if mesh.process:
        import torch.distributed as dist

        split = set(model_dims(state.params)) \
            if model_size(mesh) > 1 else set()
        staged = set(_block_paths(state.params)) \
            if pipe_size(mesh) > 1 else set()
        tensors = _tensors(state, lambda p: p.split("/")[0]
                           not in SHARDED_TABLES and p not in split
                           and p not in staged)
        _broadcast(tensors)
        if split:
            _broadcast(_tensors(state, lambda p: p in split),
                       src=mesh.replica_ranks[0], group=mesh.replica_group)
        if staged:
            _broadcast(_tensors(state, lambda p: p in staged),
                       src=mesh.stage_ranks[0], group=mesh.stage_group)
        dev = tensors[0].device
        step = torch.tensor([state.step], dtype=torch.int64, device=dev)
        dist.broadcast(step, src=0)
        state.step = int(step.item())
    return state


def init_sharded_state(model: SeqRecModel, cfg: Config, mesh,
                       seed: Optional[int] = None,
                       device="cuda") -> TrainState:
    """A fresh train state on ``mesh``: parameters drawn from ``seed``
    (default ``cfg.train.seed``), the same numbers in every process, each
    of which keeps its rows of the tables and of their optimizer state."""
    return _land_tables(init_state(model, cfg, seed=seed, device=device),
                        mesh)


def shard_batch(mesh, batch: Mapping, index: Optional[int] = None
                ) -> Dict[str, Any]:
    """Data shard ``index``'s contiguous block of a global batch's rows
    (default: this process's data index), as the JAX package's batch
    sharding splits the leading axis; the step's shared negatives stay
    whole. The batch itself without a mesh or with one data shard."""
    if data_size(mesh) == 1:
        return dict(batch)
    index = batch_index(mesh) if index is None else index
    return batch_rows(batch, data_rows(batch["seq"].shape[0],
                                       data_size(mesh), index))


def unpad_state(state: TrainState, model: SeqRecModel, mesh=None,
                packed: bool = False) -> TrainState:
    """The state in the mesh-independent shapes: each table, its AdamW
    moments and its row state at ``checkpoint.table_rows(model, packed)``
    rows (``fused_feat``: the fused vocabulary's), the shard padding cut; on
    a process mesh the tables are all-gathered over the table shards first
    and the tensor-parallel leaves and their moments over the model group
    (:func:`whole_model`) and the stage's blocks over the pipe group
    (:func:`whole_pipe`), which holds every leaf whole in every process
    (for a test or an export; the checkpoints stay per shard). A new
    state; the given one is left as it is."""
    import collections
    import copy

    from ..train.checkpoint import table_rows

    if state.layout is None:
        return state
    rows = dict(table_rows(model, packed),
                fused_feat=model.fused.total_rows)
    out = TrainState(_copy_tree(state.params), copy.copy(state.opt),
                     state.step, {n: dict(o) for n, o in state.tables.items()},
                     None)
    out.opt.param_groups = [dict(g, params=list(g["params"]))
                            for g in state.opt.param_groups]
    out.opt.state = collections.defaultdict(dict, state.opt.state)

    def whole(name):
        def fn(t):
            if state.layout[0] == "process":
                t = mesh.all_gather_tables([t.contiguous()])
            return t[:rows[name]].clone()
        return fn

    for name in SHARDED_TABLES:
        if isinstance(out.params.get(name), torch.Tensor):
            _replace_leaf(out, name, whole(name))
    for name, opt in out.tables.items():
        for k in opt:
            opt[k] = whole(name)(opt[k])
    split = split_axes(state.layout)
    if "model" in split:
        whole_model(out, mesh)
    if "pipe" in split:
        whole_pipe(out, mesh)
    return out


def _copy_tree(tree):
    """The dicts of a parameter tree copied, its tensors shared."""
    if isinstance(tree, Mapping):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def whole_model(state: TrainState, mesh) -> TrainState:
    """The tensor-parallel leaves of a state holding this process's model
    slices (a process mesh with M > 1) and their AdamW moments whole again
    (gathered over the model group, ``partition.shard_join``), in
    place."""
    for path, dim in model_dims(state.params).items():
        def fn(t, path=path, dim=dim):
            return join_model(mesh, t, path, dim)

        shape = _leaf(state.params, path).shape
        _replace_leaf(state, path, fn, cut=lambda v, shape=shape:
                      tuple(v.shape) == tuple(shape))
    return state


def make_sharded_train_step(model: SeqRecModel, cfg: Config, mesh):
    """The same step as ``trainer.make_train_step``, on ``mesh``."""
    return make_train_step(model, cfg, mesh)
