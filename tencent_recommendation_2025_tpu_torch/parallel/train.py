"""Training on a mesh: the train state and the batch of a data shard.

Counterpart of ``tencent_recommendation_2025_tpu/parallel/train.py``. The
JAX package places each leaf with its partition rules (tables row-sharded
over (data, model), the EP layout) and lets one jitted SPMD step emit the
collectives. Here the parameters and optimizer state are replicated, one
copy per process (a local mesh holds one for all its shards), and the
trainer runs each data shard's rows and sums their gradients
(``train/trainer.py``). Replicated tables compute the same numbers as the
row-sharded ones; the row layout belongs to ROADMAP Queue 1 item 5b, which
takes :func:`unpad_state` as its seam.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from ..config import Config
from ..models.baseline import SeqRecModel
from ..train.trainer import (TrainState, batch_rows, init_state,
                             make_train_step)
from .mesh import data_rows


def init_sharded_state(model: SeqRecModel, cfg: Config, mesh,
                       seed: Optional[int] = None,
                       device="cuda") -> TrainState:
    """A fresh train state on ``mesh``: parameters drawn from ``seed``
    (default ``cfg.train.seed``), replicated. Every process draws the same
    numbers from the same seed on the CPU."""
    return init_state(model, cfg, seed=seed, device=device)


def shard_batch(mesh, batch: Mapping, index: Optional[int] = None
                ) -> Dict[str, Any]:
    """Data shard ``index``'s contiguous block of a global batch's rows
    (default: this process's data index), as the JAX package's batch
    sharding splits the leading axis; the step's shared negatives stay
    whole. The batch itself without a mesh or with one data shard."""
    if mesh is None or mesh.shape["data"] == 1:
        return dict(batch)
    index = mesh.data_index if index is None else index
    return batch_rows(batch, data_rows(batch["seq"].shape[0],
                                       mesh.shape["data"], index))


def _tensors(state: TrainState):
    """Every tensor of a train state, in a fixed order: the parameters, the
    AdamW state of each parameter, the tables' row-optimizer state."""
    from ..bridge import _flatten

    params = list(_flatten(state.params).values())
    out = [p.data for p in params]
    for p in params:
        st = state.opt.state.get(p, {})
        out += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
    for name in sorted(state.tables):
        out += [state.tables[name][k] for k in sorted(state.tables[name])]
    return out


def shard_existing_state(mesh, state: TrainState) -> TrainState:
    """Land an existing train state (a resumed checkpoint) on ``mesh``, the
    resume path: on a process mesh every tensor of it and its step are rank
    0's (a broadcast over the world; a tensor off the parameters' device,
    as AdamW keeps its step counts, crosses through a copy there), so that
    the replicas start equal; on a local mesh it is the state itself."""
    if not mesh.process:
        return state
    import torch.distributed as dist

    tensors = _tensors(state)
    dev = tensors[0].device
    with torch.no_grad():
        for t in tensors:
            buf = t if t.device == dev else t.to(dev)
            dist.broadcast(buf, src=0)
            if buf is not t:
                t.copy_(buf)
        step = torch.tensor([state.step], dtype=torch.int64, device=dev)
        dist.broadcast(step, src=0)
    state.step = int(step.item())
    return state


def unpad_state(state: TrainState, params_template=None) -> TrainState:
    """The state as a checkpoint keeps it, in the mesh-independent shapes.
    Replicated tables carry no shard padding, so this is the state itself;
    row-sharded tables (ROADMAP Queue 1 item 5b) will cut it here."""
    return state


def make_sharded_train_step(model: SeqRecModel, cfg: Config, mesh):
    """The same step as ``trainer.make_train_step``, on ``mesh``."""
    return make_train_step(model, cfg, mesh)
