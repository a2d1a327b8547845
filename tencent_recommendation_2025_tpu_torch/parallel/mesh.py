"""Device meshes of the port: the (pipe, data, model, seq) axes of the JAX
package's ``parallel/mesh.py``, for data-, tensor-, sequence- and
pipeline-parallel training.

Two kinds, with one interface that the encoder and the trainer read:

- :class:`ProcessMesh`, :func:`build_mesh`: one process per card, under
  ``torchrun`` (:func:`initialize_distributed`). Each process holds one
  (data, model, seq) shard: the rows of its data index, the model slices
  of its model index and, inside the encoder, the tokens of its seq index.
  Processes are ordered as the JAX mesh orders its devices
  (``reshape(pipe, data, model, seq)``): ``rank = ((pipe_index * data +
  data_index) * model + model_index) * seq + seq_index``. It keeps a
  ``torch.distributed`` group per axis: the seq group (the ranks of one
  (pipe, data, model) index), the data group (one (model, seq) index, over
  pipe x data: see below), the model group (one (pipe, data, seq) index),
  the replica group of one model index (pipe x data x seq), over which a
  replicated or model-split gradient is summed, and with pipe > 1 the pipe
  group of each data column (one (data, model, seq) index) and the stage
  group of each pipe index (its data ranks). Key/value shards rotate
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

The pipe axis (pipeline parallelism, ``parallel/pipeline_parallel.py``)
composes with data only (pipe > 1 with model or seq raises ``ValueError``,
as the JAX ``build_mesh`` asserts). Outside the encoder a pipe x data mesh
is a data mesh of P x D shards in the JAX order ``pipe_index * data +
data_index`` (JAX ``BATCH_RULES``: the batch over ("pipe", "data")): the
rows of a global batch (:func:`data_size`, ``data_indices``,
:func:`host_batch_slice`), the data group's collectives and the table
shards. Inside it, each data column's P ranks run the stacked blocks as a
GPipe schedule, stage p holding blocks [p NB / P, (p + 1) NB / P)
(:func:`pipe_blocks`); ``pp_microbatches`` (the mesh config's) sets its
microbatches.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import MeshConfig

AXES = ("pipe", "data", "model", "seq")


def check_mesh(mesh, what: str) -> None:
    """Raise ``TypeError`` for a ``mesh`` that is no mesh: an object
    without a ``shape`` (``what`` names the caller)."""
    if getattr(mesh, "shape", None) is None:
        raise TypeError(f"{what}: {mesh!r} is not a mesh (it has no "
                        "`shape`): pass a ProcessMesh or a LocalMesh")


def check_axes(shape: Dict[str, int]) -> None:
    """Raise ``ValueError`` for a pipe axis with a model or a seq axis in a
    mesh's ``shape``, as the JAX ``build_mesh`` asserts."""
    if shape.get("pipe", 1) > 1 and (shape.get("model", 1) > 1
                                     or shape.get("seq", 1) > 1):
        raise ValueError(
            "pipe>1 composes with data parallelism only (model=seq=1)")


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

    def __init__(self, seq: int = 1, data: int = 1, model: int = 1,
                 pipe: int = 1, pp_microbatches: int = 8):
        self.shape: Dict[str, int] = {"pipe": pipe, "data": data,
                                      "model": model, "seq": seq}
        check_axes(self.shape)
        self.pp_microbatches = pp_microbatches

    @property
    def seq_indices(self) -> List[int]:
        return list(range(self.shape["seq"]))

    @property
    def data_indices(self) -> List[int]:
        """The data shards whose rows run in this process: all of them
        (pipe x data, flattened, on a pipe mesh)."""
        return list(range(data_size(self)))

    @property
    def model_indices(self) -> List[int]:
        """The model shards this process holds: all of them."""
        return list(range(self.shape["model"]))

    @property
    def table_indices(self) -> List[int]:
        """The table shards this process holds: all of them."""
        return list(range(table_shards(self)))

    @property
    def encoder_mesh(self) -> Optional["LocalMesh"]:
        """The mesh one data shard's rows take through the encoder: its seq
        and model shards, or its pipe stages (None without any of those
        axes)."""
        if self.shape["pipe"] > 1:
            return LocalMesh(pipe=self.shape["pipe"],
                             pp_microbatches=self.pp_microbatches)
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
    """This process's place in a (pipe, data, model, seq) mesh of processes,
    one card each (see the module docstring): ``rank = ((pipe_index * data
    + data_index) * model + model_index) * seq + seq_index``, as the JAX
    mesh orders its devices."""

    process = True

    def __init__(self, data: int, seq: int, model: int = 1, pipe: int = 1,
                 pp_microbatches: int = 8):
        rank = dist.get_rank()
        self.shape = {"pipe": pipe, "data": data, "model": model,
                      "seq": seq}
        check_axes(self.shape)
        self.pp_microbatches = pp_microbatches
        rest, self.seq_index = divmod(rank, seq)
        rest, self.model_index = divmod(rest, model)
        self.pipe_index, self.data_index = divmod(rest, data)
        me = (self.pipe_index, self.data_index, self.model_index,
              self.seq_index)

        def rk(p, d, m, s):
            return ((p * data + d) * model + m) * seq + s

        def groups(axes):
            """Every group of the ranks that differ only along ``axes``
            (every process creates every group, in the same order), and
            this process's: (its group, its ranks in group order)."""
            sizes = dict(zip("pdms", (pipe, data, model, seq)))
            fixed = [a for a in "pdms" if a not in axes]
            mine = None
            for key in itertools.product(*(range(sizes[a]) for a in fixed)):
                at = dict(zip(fixed, key))
                ranks = [rk(**at, **dict(zip(axes, var)))
                         for var in itertools.product(
                             *(range(sizes[a]) for a in axes))]
                g = dist.new_group(ranks)
                if all(me["pdms".index(a)] == at[a] for a in fixed):
                    mine = (g, ranks)
            return mine

        self.seq_group, self.seq_ranks = groups("s")
        # the data group spans pipe x data: the batch's shards
        self.data_group, _ = groups("pd")
        self.model_group, self.model_ranks = groups("m")
        if model == 1:
            self.replica_group = None       # the world
            self.replica_ranks = list(range(dist.get_world_size()))
        else:
            self.replica_group, self.replica_ranks = groups("pds")
        self.pipe_group = self.stage_group = None
        self.pipe_ranks = self.stage_ranks = None
        if pipe > 1:
            self.pipe_group, self.pipe_ranks = groups("p")
            self.stage_group, self.stage_ranks = groups("d")
            _warm(self.pipe_group)

    @property
    def seq_indices(self) -> List[int]:
        return [self.seq_index]

    @property
    def data_indices(self) -> List[int]:
        """This process's data shard: pipe x data flattened
        (``pipe_index * data + data_index``)."""
        return [batch_index(self)]

    @property
    def model_indices(self) -> List[int]:
        return [self.model_index]

    @property
    def table_indices(self) -> List[int]:
        """The table shard this process holds: its (pipe, data, model)
        index's."""
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
        out = [torch.empty_like(t) for _ in range(data_size(self))]
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
        return (batch_index(self) * self.shape["model"]
                + self.model_index) * self.shape["seq"] + self.seq_index

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
        the seq, the model, the replica group (pipe x data x seq: the ranks
        of this model index), the pipe group (this data column's stages)
        or the stage group (this pipe index's data ranks)."""
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group={"world": None, "data": self.data_group,
                               "seq": self.seq_group,
                               "model": self.model_group,
                               "replica": self.replica_group,
                               "pipe": self.pipe_group,
                               "stage": self.stage_group}[group])
        return t


def _warm(group) -> None:
    """One all-reduce over ``group``: NCCL creates a group's communicator at
    its first collective, which must involve every rank of the group,
    before point-to-point batches that involve only some of them."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    dist.all_reduce(torch.zeros(1, device=dev), group=group)


def gather_model(t: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Every model shard's ``t`` of a process mesh, in model order (an
    all-gather over the model group; no gradient)."""
    parts = [torch.empty_like(t) for _ in range(mesh.shape["model"])]
    dist.all_gather(parts, t.detach().contiguous(), group=mesh.model_group)
    return parts


def gather_pipe(t: torch.Tensor, mesh) -> torch.Tensor:
    """A stacked block leaf (or moment) whole from this stage's blocks: the
    pipe group's slices concatenated along dim 0, in stage order (no
    gradient)."""
    parts = [torch.empty_like(t) for _ in range(mesh.shape["pipe"])]
    dist.all_gather(parts, t.detach().contiguous(), group=mesh.pipe_group)
    return torch.cat(parts)


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
    parts = [torch.empty_like(t) for _ in range(data_size(mesh))]
    dist.all_gather(parts, t.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def _scatter(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // data_size(mesh),) + t.shape[1:])
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
    """The process mesh over the initialised process group: pipe =
    cfg.pipe, model = cfg.model, seq = cfg.seq, and every leftover process
    folds into data, as the JAX ``build_mesh`` folds leftover devices."""
    n = dist.get_world_size()
    rest = cfg.pipe * cfg.model * cfg.seq
    if n % rest:
        raise ValueError(f"{n} processes are not divisible by pipe*model*"
                         f"seq={rest}")
    return ProcessMesh(n // rest, cfg.seq, cfg.model, cfg.pipe,
                       cfg.pp_microbatches)


def local_mesh(cfg: MeshConfig = MeshConfig()) -> LocalMesh:
    """A mesh of cfg.pipe x cfg.data x cfg.model x cfg.seq shards in this
    process on one device.
    With dropout on, its unfused "ring" route draws whole-sequence masks
    where a process mesh draws per-shard ones, so the two agree there only
    with dropout off; the fused ring folds the shard seeds on both. Each
    data shard draws its dropout masks from its own generator, as a process
    of that data index does."""
    return LocalMesh(seq=cfg.seq, data=cfg.data, model=cfg.model,
                     pipe=cfg.pipe, pp_microbatches=cfg.pp_microbatches)


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
    return data_rows(global_batch, data_size(mesh), batch_index(mesh))


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
    """This process's table shard: ``(pipe_index * data + data_index) *
    model + model_index`` (JAX ``sharded_embedding.py``'s ``shard_idx``
    over ``TABLE_AXES``), 0 without a mesh. A local mesh holds every shard
    (``table_indices``)."""
    if mesh is None or not mesh.process:
        return 0
    M = mesh.shape.get("model", 1)
    return batch_index(mesh) * M + (mesh.model_index if M > 1 else 0)


def batch_index(mesh) -> int:
    """A process's data shard of a global batch's rows: ``pipe_index *
    data + data_index`` (pipe x data flattened, JAX ``BATCH_RULES``)."""
    return getattr(mesh, "pipe_index", 0) * mesh.shape.get("data", 1) \
        + mesh.data_index


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
    """The data shards of a global batch: pipe x data (the JAX batch
    sharding over ("pipe", "data")), 1 without a mesh."""
    return 1 if mesh is None else \
        mesh.shape.get("pipe", 1) * mesh.shape.get("data", 1)


def pipe_size(mesh: Optional[object]) -> int:
    return 1 if mesh is None else mesh.shape.get("pipe", 1)


def pipe_blocks(num_blocks: int, mesh) -> slice:
    """The blocks stage ``mesh.pipe_index`` of a process mesh holds:
    [p NB / P, (p + 1) NB / P) (the stacked leaves' leading axis over
    ``pipe``); all of them without a pipe axis. Raises where P does not
    divide NB, with the JAX message."""
    P = pipe_size(mesh)
    if num_blocks % P:
        raise ValueError(f"num_blocks {num_blocks} not divisible by pipe "
                         f"stages {P}")
    if P == 1 or not mesh.process:
        return slice(0, num_blocks)
    k = num_blocks // P
    return slice(mesh.pipe_index * k, (mesh.pipe_index + 1) * k)


def model_size(mesh: Optional[object]) -> int:
    return 1 if mesh is None else mesh.shape.get("model", 1)
