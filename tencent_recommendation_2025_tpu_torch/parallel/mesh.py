"""Device meshes of the port: the (pipe, data, model, seq) axes of the JAX
package's ``parallel/mesh.py``, for data-, tensor- and sequence-parallel
training.

Two kinds, with one interface that the encoder and the trainer read:

- :class:`ProcessMesh`, :func:`build_mesh`: one process per card, under
  ``torchrun`` (:func:`initialize_distributed`). Each process holds one
  (data, model, seq) shard: the rows of its data index, the model slices
  of its model index and, inside the encoder, the tokens of its seq index.
  Processes are ordered as the JAX mesh orders its devices
  (``reshape(pipe, data, model, seq)``): ``rank = (data_index * model +
  model_index) * seq + seq_index``. It keeps a ``torch.distributed`` group
  per axis: the seq group (the ranks of one (data, model) index), the data
  group (one (model, seq) index), the model group (one (data, seq) index),
  and the replica group of one model index (data x seq), over which a
  replicated or model-split gradient is summed. Key/value shards rotate
  around the seq group by point-to-point sends (:meth:`ProcessMesh.rotate`),
  the encoder output gathers along L (:meth:`ProcessMesh.gather_seq`), and
  what the loss needs of the other data shards (counts, the in-batch
  candidates) crosses the data group (:meth:`ProcessMesh.sum_data`,
  :meth:`ProcessMesh.cat_data`).
- :class:`LocalMesh`, :func:`local_mesh`: every shard in one process on one
  device, the counterpart of the JAX tests' virtual CPU devices. The
  trainer runs each data shard's rows through the model in turn, at the
  launch shapes of one card of the process mesh, and combines them as the
  process mesh does; the model shards of a data shard run one after
  another inside each layer; rotation is indexing into the list of seq
  shards; autograd sums what the process mesh all-reduces. The tests and
  ``chip_smoke.py`` use it; the CLI never builds it.

The model axis is Megatron's tensor parallelism, in the conjugate pairs of
operators a layer needs, each a ``torch.autograd.Function`` over the model
group and list-in or list-out (one tensor per model shard this process
holds: all of them on a local mesh, its own on a process mesh):
``copy_to_model`` (identity forward, a sum of the cotangents backward),
``reduce_from_model`` (the partials summed forward, in f32 and in model
order, the cotangent passed through backward), ``gather_from_model`` (the
shards concatenated along the last dim; backward, this shard's slice of
the cotangent) and ``scatter_to_model`` (this shard's slice; backward, the
cotangents gathered).

The learned tables row-shard over the table axes (pipe, data, model), as
the JAX package's partition rules place them: :func:`table_shards` shards,
of which a process holds the one of its (data, model) index
(:func:`table_index`: ``data_index * model + model_index``, the JAX
``shard_idx``; the ranks of one such index across ``seq`` hold the same
one) and a local mesh holds all. The lookups and the sparse path move rows
between them by three collectives over the data group, each
differentiable: ``all_gather`` (tiled along dim 0; its transpose a
reduce-scatter), ``reduce_scatter`` (tiled, summed; its transpose an
all-gather) and ``all_to_all`` (tiled; its transpose the reverse
exchange), and by ``reduce_from_model`` over the model group. A local mesh
takes them over its list of shards.

The serving corpus row-shards over every axis, flattened (``retrieval/
mips.py``): :func:`world_shards` shards, of which a process holds the one of
its rank and a local mesh all (``world_indices``); ``all_gather_world``
gathers the shards' winners over every process (no gradient).

Meshes with pipe > 1 raise ``NotImplementedError`` naming ROADMAP Queue 1
item 5 (slice e: pipeline parallelism).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import MeshConfig

AXES = ("pipe", "data", "model", "seq")
QUEUE_ITEM = "ROADMAP Queue 1, item 5 (Multi-device layer)"


def unported(what: str):
    raise NotImplementedError(f"{what} is not ported yet: {QUEUE_ITEM}")


def _check_axes(cfg: MeshConfig) -> None:
    if cfg.pipe > 1:
        unported(f"a mesh with pipe={cfg.pipe} (pipeline parallelism, "
                 "slice e)")


def initialize_distributed(device: str = "cuda") -> bool:
    """Join the process group ``torchrun`` describes in the environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL with one card per process (``LOCAL_RANK``) on
    ``cuda``, gloo on ``cpu``. Returns False, doing nothing, for a single
    process."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if not dist.is_initialized():
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method="env://")
    return True


class LocalMesh:
    """Every data, model and seq shard in this process (see the module
    docstring)."""

    process = False
    rank = 0
    data_index = 0

    def __init__(self, seq: int = 1, data: int = 1, model: int = 1):
        self.shape: Dict[str, int] = {"pipe": 1, "data": data,
                                      "model": model, "seq": seq}

    @property
    def seq_indices(self) -> List[int]:
        return list(range(self.shape["seq"]))

    @property
    def data_indices(self) -> List[int]:
        """The data shards whose rows run in this process: all of them."""
        return list(range(self.shape["data"]))

    @property
    def model_indices(self) -> List[int]:
        """The model shards this process holds: all of them."""
        return list(range(self.shape["model"]))

    @property
    def table_indices(self) -> List[int]:
        """The table shards this process holds: all of them."""
        return list(range(self.shape["data"] * self.shape["model"]))

    @property
    def encoder_mesh(self) -> Optional["LocalMesh"]:
        """The mesh one data shard's rows take through the encoder: its seq
        and model shards (None with neither axis)."""
        if self.shape["seq"] == 1 and self.shape["model"] == 1:
            return None
        return self if self.shape["data"] == 1 \
            else LocalMesh(seq=self.shape["seq"], model=self.shape["model"])

    def sum_data(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of one tensor per data shard (differentiable)."""
        return sum(parts[1:], parts[0])

    def cat_data(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every data shard's rows, in data order (dim 0)."""
        return torch.cat(list(parts))

    def all_gather(self, parts: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """Every shard's tensor concatenated along dim 0, for each shard
        (one tensor per data shard in, one per data shard out, as for
        every collective here)."""
        t = torch.cat(list(parts))
        return [t] * len(parts)

    def all_gather_tables(self, parts: Sequence[torch.Tensor]
                          ) -> torch.Tensor:
        """One tensor per table shard, concatenated along dim 0 in table
        order (no gradient)."""
        return torch.cat(list(parts))

    def reduce_scatter(self, parts: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """The shards' tensors summed, shard d keeping block d of dim 0."""
        return list(sum(parts[1:], parts[0]).chunk(len(parts)))

    def all_to_all(self, parts: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """Block d of shard s's dim 0 sent to shard d, which concatenates
        what it receives in shard order."""
        chunks = [p.chunk(len(parts)) for p in parts]
        return [torch.cat([c[d] for c in chunks])
                for d in range(len(parts))]

    # the model group: one tensor per model shard in or out
    def copy_to_model(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x] * self.shape["model"]

    def reduce_from_model(self, parts: Sequence[torch.Tensor]
                          ) -> torch.Tensor:
        return _ordered_sum([p.float() for p in parts])

    def gather_from_model(self, parts: Sequence[torch.Tensor], dim: int = -1
                          ) -> torch.Tensor:
        return torch.cat(list(parts), dim=dim)

    def scatter_to_model(self, x: torch.Tensor, dim: int = -1
                         ) -> List[torch.Tensor]:
        return list(x.chunk(self.shape["model"], dim=dim))

    @property
    def world_indices(self) -> List[int]:
        """The flattened shards (every axis) this process holds: all."""
        return list(range(world_shards(self)))

    def all_gather_world(self, parts: Sequence[torch.Tensor]
                         ) -> List[torch.Tensor]:
        """Every flattened shard's tensor concatenated along dim 0, in shard
        order, for each shard (no gradient)."""
        t = torch.cat(list(parts))
        return [t] * len(parts)

    def seq_shards(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The local shards of ``x`` along L (dim 1)."""
        return list(x.chunk(self.shape["seq"], dim=1))

    def gather_seq(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(shards), dim=1)

    def rotate(self, shards: list) -> list:
        """One ring step: shard i receives shard i - 1's tensors."""
        return shards[-1:] + shards[:-1]


def _ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The parts summed in list order (model order), in their dtype."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class ProcessMesh:
    """This process's place in a (data, model, seq) mesh of processes, one
    card each (see the module docstring): ``rank = (data_index * model +
    model_index) * seq + seq_index``, as the JAX mesh orders its
    devices."""

    process = True

    def __init__(self, data: int, seq: int, model: int = 1):
        rank = dist.get_rank()
        self.shape = {"pipe": 1, "data": data, "model": model, "seq": seq}
        dm, self.seq_index = divmod(rank, seq)
        self.data_index, self.model_index = divmod(dm, model)

        def rk(d, m, s):
            return (d * model + m) * seq + s

        self.seq_ranks = [rk(self.data_index, self.model_index, s)
                          for s in range(seq)]
        self.model_ranks = [rk(self.data_index, m, self.seq_index)
                            for m in range(model)]
        # every process creates every group, in the same order
        for d in range(data):
            for m in range(model):
                g = dist.new_group([rk(d, m, s) for s in range(seq)])
                if (d, m) == (self.data_index, self.model_index):
                    self.seq_group = g
        for m in range(model):
            for s in range(seq):
                g = dist.new_group([rk(d, m, s) for d in range(data)])
                if (m, s) == (self.model_index, self.seq_index):
                    self.data_group = g
        for d in range(data):
            for s in range(seq):
                g = dist.new_group([rk(d, m, s) for m in range(model)])
                if (d, s) == (self.data_index, self.seq_index):
                    self.model_group = g
        self.replica_ranks = [rk(d, self.model_index, s)
                              for d in range(data) for s in range(seq)]
        if model == 1:
            self.replica_group = None       # the world
        for m in range(model if model > 1 else 0):
            g = dist.new_group([rk(d, m, s) for d in range(data)
                                for s in range(seq)])
            if m == self.model_index:
                self.replica_group = g

    @property
    def seq_indices(self) -> List[int]:
        return [self.seq_index]

    @property
    def data_indices(self) -> List[int]:
        return [self.data_index]

    @property
    def model_indices(self) -> List[int]:
        return [self.model_index]

    @property
    def table_indices(self) -> List[int]:
        """The table shard this process holds: its (data, model) index's."""
        return [table_index(self)]

    @property
    def encoder_mesh(self) -> "ProcessMesh":
        return self

    def all_gather(self, parts: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """The data group's tensors concatenated along dim 0, in data order
        (a list of one, as every collective here takes and returns this
        shard's); the backward sums the cotangent over the group and keeps
        this shard's block (a reduce-scatter)."""
        (t,) = parts
        return [_AllGatherData.apply(t, self)]

    def all_gather_tables(self, parts: Sequence[torch.Tensor]
                          ) -> torch.Tensor:
        """Every table shard's tensor concatenated along dim 0 in table
        order (``data_index * model + model_index``): gathered over the
        model group, then over the data group (no gradient)."""
        (t,) = parts
        t = t.detach().contiguous()
        if self.shape["model"] > 1:
            t = torch.cat(gather_model(t, self))
        return _gather(t, self)

    def reduce_scatter(self, parts: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """The tensor summed over the data group, this shard keeping block
        ``data_index`` of dim 0; the backward all-gathers the cotangent."""
        (t,) = parts
        return [_ReduceScatterData.apply(t, self)]

    def all_to_all(self, parts: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """Block d of dim 0 sent to data rank d; what rank s sent here is
        block s of the result. The backward is the reverse exchange."""
        (t,) = parts
        return [_AllToAllData.apply(t, self)]

    def sum_data(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """This data shard's tensor summed over the data group: an
        all-reduce whose backward all-reduces the cotangent, so each shard
        receives the gradient of every shard's loss."""
        (t,) = parts
        return _AllReduceData.apply(t, self)

    def cat_data(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every data shard's rows, in data order (dim 0), no gradient (an
        all-gather over the data group; bool tensors cross as uint8)."""
        (t,) = parts
        was_bool = t.dtype == torch.bool
        t = (t.to(torch.uint8) if was_bool else t).detach().contiguous()
        out = [torch.empty_like(t) for _ in range(self.shape["data"])]
        dist.all_gather(out, t, group=self.data_group)
        out = torch.cat(out)
        return out.bool() if was_bool else out

    # the model group: this shard's tensor in or out, as a list of one
    def copy_to_model(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` as this shard's input of a model-split layer; the backward
        sums the cotangent over the model group."""
        return [_CopyToModel.apply(x, self)]

    def reduce_from_model(self, parts: Sequence[torch.Tensor]
                          ) -> torch.Tensor:
        """The model group's partials summed in f32, in model order (an
        all-gather and an ordered sum, so every shard holds the same bits
        as a local mesh); the backward passes the cotangent through."""
        (t,) = parts
        return _ReduceFromModel.apply(t.float(), self)

    def gather_from_model(self, parts: Sequence[torch.Tensor], dim: int = -1
                          ) -> torch.Tensor:
        """The model group's tensors concatenated along ``dim``; the
        backward keeps this shard's slice of the cotangent."""
        (t,) = parts
        return _GatherModel.apply(t, self, dim)

    def scatter_to_model(self, x: torch.Tensor, dim: int = -1
                         ) -> List[torch.Tensor]:
        """This shard's slice of ``x`` along ``dim``; the backward gathers
        the cotangent over the model group."""
        return [_ScatterModel.apply(x, self, dim)]

    @property
    def rank(self) -> int:
        return (self.data_index * self.shape["model"] + self.model_index) \
            * self.shape["seq"] + self.seq_index

    @property
    def world_indices(self) -> List[int]:
        """The flattened shard this process holds: its rank's."""
        return [self.rank]

    def all_gather_world(self, parts: Sequence[torch.Tensor]
                         ) -> List[torch.Tensor]:
        """Every process's tensor concatenated along dim 0, in rank order
        (a list of one; no gradient)."""
        (t,) = parts
        out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(out, t.detach().contiguous())
        return [torch.cat(out)]

    def seq_shards(self, x: torch.Tensor) -> List[torch.Tensor]:
        """This process's shard of ``x`` along L (dim 1), as a list of
        one."""
        Lc = x.shape[1] // self.shape["seq"]
        return [x[:, self.seq_index * Lc:(self.seq_index + 1) * Lc]]

    def gather_seq(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The seq group's shards concatenated along L; the backward keeps
        this shard's slice of the gradient summed over the group."""
        (x,) = shards
        return _GatherSeq.apply(x, self)

    def shift(self, t: torch.Tensor, step: int) -> torch.Tensor:
        """``t`` sent ``step`` places up the seq ring; the tensor of the
        process ``step`` places down returned."""
        S, si = self.shape["seq"], self.seq_index
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t.contiguous(),
                          self.seq_ranks[(si + step) % S],
                          group=self.seq_group),
               dist.P2POp(dist.irecv, out, self.seq_ranks[(si - step) % S],
                          group=self.seq_group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def rotate(self, shards: list) -> list:
        """One ring step: this shard receives the previous seq rank's
        tensors; a tensor that requires a gradient sends it back the other
        way in the backward, as ``ppermute``'s transpose does."""
        (ts,) = shards
        return [tuple(_Shift.apply(t, self) if t.requires_grad
                      else self.shift(t, 1) for t in ts)]

    def all_reduce(self, t: torch.Tensor, group: str = "world",
                   op: str = "sum") -> torch.Tensor:
        """Sum (or ``op="max"``) ``t`` in place over the world, the data,
        the seq, the model or the replica group (data x seq: the ranks of
        this model index)."""
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group={"world": None, "data": self.data_group,
                               "seq": self.seq_group,
                               "model": self.model_group,
                               "replica": self.replica_group}[group])
        return t


def gather_model(t: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Every model shard's ``t`` of a process mesh, in model order (an
    all-gather over the model group; no gradient)."""
    parts = [torch.empty_like(t) for _ in range(mesh.shape["model"])]
    dist.all_gather(parts, t.detach().contiguous(), group=mesh.model_group)
    return parts


def _model_slice(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    return t.chunk(mesh.shape["model"], dim=dim)[mesh.model_index] \
        .contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        parts = [torch.empty_like(t) for _ in range(mesh.shape["model"])]
        dist.all_gather(parts, t.detach().contiguous(),
                        group=mesh.model_group)
        return _ordered_sum(parts)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return torch.cat(gather_model(t, mesh), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _model_slice(g, ctx.mesh, ctx.dim), None, None


class _ScatterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _model_slice(x.detach(), mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(gather_model(g, ctx.mesh), dim=ctx.dim), None, \
            None


class _AllReduceData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(t.detach().clone(), "data")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), "data"), None


def _gather(t: torch.Tensor, mesh) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.shape["data"])]
    dist.all_gather(parts, t.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def _scatter(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // mesh.shape["data"],) + t.shape[1:])
    # reduce_scatter_single is the newer name of reduce_scatter_tensor
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, t, group=mesh.data_group)
    return out


def _exchange(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=mesh.data_group)
    return out


class _AllGatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _gather(t.detach(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh), None


class _ReduceScatterData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _scatter(t.detach(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh), None


class _AllToAllData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _exchange(t.detach(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.shift(t, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shift(g.contiguous(), -1), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        parts = [torch.empty_like(x) for _ in range(mesh.shape["seq"])]
        dist.all_gather(parts, x.contiguous(), group=mesh.seq_group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        # a reduce-scatter along L (dim 1): an all-reduce and this shard's
        # slice
        mesh = ctx.mesh
        g = mesh.all_reduce(g.contiguous(), "seq")
        return mesh.seq_shards(g)[0].contiguous(), None


def build_mesh(cfg: MeshConfig = MeshConfig()) -> ProcessMesh:
    """The process mesh over the initialised process group: model =
    cfg.model, seq = cfg.seq, and every leftover process folds into data,
    as the JAX ``build_mesh`` folds leftover devices."""
    _check_axes(cfg)
    n = dist.get_world_size()
    if n % (cfg.model * cfg.seq):
        raise ValueError(f"{n} processes are not divisible by model="
                         f"{cfg.model} x seq={cfg.seq}")
    return ProcessMesh(n // (cfg.model * cfg.seq), cfg.seq, cfg.model)


def local_mesh(cfg: MeshConfig = MeshConfig()) -> LocalMesh:
    """A mesh of cfg.data x cfg.model x cfg.seq shards in this process on
    one device.
    With dropout on, its unfused "ring" route draws whole-sequence masks
    where a process mesh draws per-shard ones, so the two agree there only
    with dropout off; the fused ring folds the shard seeds on both. Each
    data shard draws its dropout masks from its own generator, as a process
    of that data index does."""
    _check_axes(cfg)
    return LocalMesh(seq=cfg.seq, data=cfg.data, model=cfg.model)


def data_rows(global_batch: int, n_data: int, index: int) -> slice:
    """Data shard ``index``'s contiguous block of a global batch's rows, as
    the JAX package's batch sharding splits the leading axis."""
    if global_batch % n_data:
        raise ValueError(f"batch {global_batch} is not divisible by data="
                         f"{n_data}")
    per = global_batch // n_data
    return slice(index * per, (index + 1) * per)


def host_batch_slice(global_batch: int, mesh=None) -> slice:
    """The rows of a global batch that this process trains: its data
    index's share (all of them without a process mesh)."""
    if mesh is None or not mesh.process:
        return slice(0, global_batch)
    return data_rows(global_batch, mesh.shape["data"], mesh.data_index)


TABLE_AXES = ("pipe", "data", "model")


def table_shards(mesh: Optional[object]) -> int:
    """S, the row shards of a learned table on ``mesh``: the product of the
    table axes (the JAX package's ``TABLE_AXES``), 1 without a mesh."""
    if mesh is None:
        return 1
    n = 1
    for a in TABLE_AXES:
        n *= mesh.shape.get(a, 1)
    return n


def table_index(mesh: Optional[object]) -> int:
    """This process's table shard: ``data_index * model + model_index``
    (pipe = 1; JAX ``sharded_embedding.py``'s ``shard_idx``), 0 without a
    mesh. A local mesh holds every shard (``table_indices``)."""
    if mesh is None or not mesh.process:
        return 0
    M = mesh.shape.get("model", 1)
    return mesh.data_index * M + (mesh.model_index if M > 1 else 0)


def world_shards(mesh: Optional[object]) -> int:
    """The flattened shards of ``mesh``: the product of every axis (the
    serving corpus's shards, JAX ``retrieval/mips.py``'s ``n_shards``), 1
    without a mesh."""
    if mesh is None:
        return 1
    n = 1
    for a in AXES:
        n *= mesh.shape.get(a, 1)
    return n


def seq_size(mesh: Optional[object]) -> int:
    return 1 if mesh is None else mesh.shape.get("seq", 1)


def data_size(mesh: Optional[object]) -> int:
    return 1 if mesh is None else mesh.shape.get("data", 1)


def model_size(mesh: Optional[object]) -> int:
    return 1 if mesh is None else mesh.shape.get("model", 1)
