"""Training: train and eval steps, the host preps, epoch loop.

Counterpart of ``tencent_recommendation_2025_tpu/train/trainer.py`` for one
device: the BCE or sampled-softmax loss, backward (the fused block's
backward kernel on the card), AdamW over the dense parameters, per-epoch
validation, the epoch-end retrieval eval (``eval_retrieval_users``) and
checkpoints. Tables listed in ``train.sparse_tables``
(``item_emb``, ``user_emb``) train by the gather-train pattern of
``ops/sparse_table.py``: the host dedups the step's touched ids
(:func:`augment_batch_sparse`), the step differentiates the loss with
respect to the gathered rows only and updates them with a row-sparse
optimizer, in place; a table at packed scale (30M+ rows) writes back whole
groups through the group-scatter kernel. PyTorch runs eagerly, so a step is
a plain function; the train state is updated in place (the JAX package's is
immutable and donated), which keeps one copy of the parameters and
optimizer state.

A ``seq`` mesh (``parallel/mesh``) trains the encoder sequence-parallel:
on a local mesh in one process; on a process mesh (one process per card,
under ``torchrun``) each process takes its data index's rows, the loss is
normalised by the global count of masked positions, and the gradients are
summed over every process, so each holds the single-device gradient of the
global batch and the replicated parameters stay equal.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: any other mesh (a preset's ``cfg.mesh`` in one process trains
single-device, as the JAX CLI falls back), ``grad_accum_steps > 1``, and the
SIGTERM / preemption checkpoint with its mid-epoch resume.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..bridge import _flatten
from ..config import MAX_USER_TOKENS_PER_ROW, Config
from ..data.featurizer import ItemFeatureTables
from ..data.pipeline import prefetch
from ..models.baseline import SeqRecModel
from ..ops import losses as LS
from ..ops import sparse_table as ST
from ..parallel.mesh import host_batch_slice, seq_size
from ..parallel.mesh import unported as mesh_unported
from . import telemetry as T


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1, "
                              f"{item}")


def check_supported(cfg: Config, mesh=None) -> None:
    """Raise on the training options the port does not cover yet. A
    preset's ``cfg.mesh`` is not one of them: in one process the port
    trains it on one device, as the JAX CLI does where the devices are
    missing. A ``mesh`` must have a seq axis above 1, pipe = model = 1,
    dense tables and the BCE loss (the sampled softmax's in-batch negatives
    span the global batch); anything else raises ``NotImplementedError``
    naming ROADMAP Queue 1 item 5."""
    t = cfg.train
    if mesh is not None:
        shape = getattr(mesh, "shape", None)
        if shape is None:
            mesh_unported(f"training on the device mesh {mesh!r}")
        if shape.get("pipe", 1) > 1 or shape.get("model", 1) > 1:
            mesh_unported(f"training on a mesh with pipe or model > 1 "
                          f"({dict(shape)})")
        if seq_size(mesh) < 2:
            mesh_unported(f"training on a mesh without a seq axis "
                          f"({dict(shape)}: data parallelism alone)")
        if t.sparse_tables:
            mesh_unported("sparse tables on a device mesh")
        if t.loss_type == "sampled_softmax":
            mesh_unported("the sampled softmax on a device mesh (its "
                          "in-batch negatives span the global batch)")
    if not set(t.sparse_tables) <= {"item_emb", "user_emb"}:
        raise ValueError("train.sparse_tables takes subsets of (item_emb, "
                         f"user_emb), not {t.sparse_tables}")
    if t.grad_accum_steps > 1:
        _unported("gradient accumulation (train.grad_accum_steps > 1)",
                  "item 3 (training options)")


@dataclasses.dataclass
class TrainState:
    """Parameters (a nested dict; f32 leaves that take gradients, and the
    sparse-trained tables, which do not), the dense leaves' AdamW, each
    sparse table's row-optimizer state (``tables``: name -> {"mu", "nu"}
    or {"acc"}) and the count of steps taken."""
    params: Dict
    opt: torch.optim.Optimizer
    step: int = 0
    tables: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict)


def lr_at_step(tcfg, step: int) -> float:
    """Learning rate at a global step: the single source of the schedule,
    which the optimizer applies and the telemetry logs. Defaults are the
    reference's constant lr."""
    lr = float(tcfg.lr)
    if tcfg.lr_warmup_steps > 0:
        lr = lr * min(step / tcfg.lr_warmup_steps, 1.0)
    if tcfg.lr_schedule == "cosine" and tcfg.lr_total_steps > 0:
        span = max(1, tcfg.lr_total_steps - tcfg.lr_warmup_steps)
        t = min(max((step - tcfg.lr_warmup_steps) / span, 0.0), 1.0)
        lr = lr * 0.5 * (1.0 + math.cos(math.pi * t))
    return lr


def param_leaves(params: Mapping):
    """[(path, leaf)] of a parameter tree in a fixed (sorted) order."""
    return list(_flatten(params).items())


def dense_leaves(params: Mapping, cfg: Config):
    """:func:`param_leaves` without the sparse-trained tables: the leaves
    AdamW updates."""
    sparse = set(cfg.train.sparse_tables)
    return [(p, t) for p, t in param_leaves(params)
            if p.split("/")[0] not in sparse]


def make_optimizer(cfg: Config, params: Mapping) -> torch.optim.Optimizer:
    """AdamW as optax builds it over the dense leaves: eps 1e-8 outside the
    square root, weight decay on every leaf (none with ``weight_decay ==
    0``: plain Adam); the learning rate is set before each step from
    :func:`lr_at_step`."""
    t = cfg.train
    return torch.optim.AdamW([p for _, p in dense_leaves(params, cfg)],
                             lr=lr_at_step(t, 0), betas=(t.adam_b1, t.adam_b2),
                             eps=1e-8, weight_decay=t.weight_decay)


def init_state(model: SeqRecModel, cfg: Config, seed: Optional[int] = None,
               params: Optional[Mapping] = None,
               device="cpu") -> TrainState:
    """A fresh state: parameters drawn from ``seed`` (default
    ``cfg.train.seed``; an item table at packed scale is drawn on
    ``device`` itself), or copies of the given ``params``, on ``device``:
    dense leaves that take gradients, sparse-trained tables that do not,
    with their row-optimizer state (``cfg.train.table_optimizer``)."""
    fresh = params is None
    if fresh:
        seed = cfg.train.seed if seed is None else seed
        params = model.init(torch.Generator().manual_seed(seed),
                            device=device)
    sparse = set(cfg.train.sparse_tables)

    def leafify(t, grad):
        if isinstance(t, Mapping):
            return {k: leafify(v, grad) for k, v in t.items()}
        t = t.detach().to(device)
        t = t if fresh else t.clone()      # the caller keeps its tensors
        return t.requires_grad_(True) if grad else t

    params = {k: leafify(v, k not in sparse) for k, v in params.items()}
    tables = {n: ST.init_table_opt(params[n], cfg.train.table_optimizer,
                                   cfg.train.table_moments_dtype)
              for n in cfg.train.sparse_tables}
    return TrainState(params, make_optimizer(cfg, params), 0, tables)


def device_tables(item_tables: ItemFeatureTables, device) -> Dict[str, Any]:
    """The static item-feature and mm tables, on the device once."""
    return {"sparse": torch.as_tensor(item_tables.sparse, device=device),
            "array": torch.as_tensor(item_tables.array, device=device),
            "mm": {k: torch.as_tensor(v, device=device)
                   for k, v in item_tables.mm.items()}}


def put_batch(batch: Mapping, device) -> Dict[str, Any]:
    """A host batch on ``device`` (nested dicts, the sparse prep's per-site
    plans, kept nested)."""
    return {k: put_batch(v, device) if isinstance(v, Mapping)
            else torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def step_generator(seed: int, step: int, device,
                   shard: Optional[int] = None) -> torch.Generator:
    """The step's randomness: a generator on the device seeded from
    (seed + 1, step), as the JAX step folds the step into its key, so a run
    is reproducible step by step; a data shard's index, where given, folds
    in too (its rows draw their own masks)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(
        [seed + 1, step] + ([] if shard is None else [shard]))
        .generate_state(1, np.uint64)[0] >> 1))
    return gen


def shard_batch(batch: Mapping, mesh=None) -> Dict[str, Any]:
    """This process's rows of a global batch (:func:`parallel.mesh.
    host_batch_slice`): every tensor whose first axis is the batch's; the
    batch itself without a process mesh."""
    if mesh is None or not mesh.process:
        return batch
    B = batch["seq"].shape[0]
    rows = host_batch_slice(B, mesh)
    return {k: v[rows] if isinstance(v, torch.Tensor) and v.dim() > 0
            and v.shape[0] == B else v for k, v in batch.items()}


def _data_shard(mesh) -> Optional[int]:
    """The data index that folds into the step generator: on a process
    mesh with data > 1 only."""
    if mesh is None or not mesh.process or mesh.shape["data"] == 1:
        return None
    return mesh.data_index


def compute_loss(model: SeqRecModel, params, batch, mm_tables, item_tables,
                 cfg: Config, train: bool,
                 gen: Optional[torch.Generator] = None, mesh=None
                 ) -> Tuple[torch.Tensor, Dict]:
    """``train.loss_type`` "sampled_softmax": :func:`_sampled_softmax`;
    otherwise the reference BCE over next-item positions, plus the L2
    penalty on the item table when ``l2_emb`` > 0. ``params`` may hold
    :class:`ops.sparse_table.GatheredRows` tables. The encoder runs on
    ``mesh``. On a process mesh ``batch`` holds this process's rows: the
    BCE divides by the global count of masked positions, the metrics hold
    the global loss, and the loss returned is this process's share, whose
    gradients summed over every process are the global loss's."""
    if cfg.train.loss_type == "sampled_softmax":
        return _sampled_softmax(model, params, batch, mm_tables,
                                item_tables, cfg, train, gen)
    pos_logits, neg_logits, loss_mask = model.logits(
        params, batch, mm_tables, item_tables, train=train, gen=gen,
        mesh=mesh)
    n_mask = loss_mask.sum().float()
    proc = mesh is not None and mesh.process
    if proc:
        n_mask = mesh.all_reduce(n_mask, "data")
    bce = LS.reference_bce_loss(pos_logits, neg_logits, loss_mask,
                                count=n_mask if proc else None)
    l2 = LS.l2_emb_penalty(params["item_emb"], cfg.train.l2_emb) \
        if cfg.train.l2_emb > 0.0 else None
    loss = bce if l2 is None else bce + l2
    if not proc:
        return loss, {"loss": loss.detach(), "bce": bce.detach(),
                      "n_mask": n_mask}
    # every seq rank computes its rows' loss in full; each data rank adds
    # its rows' share, the penalty once
    S, dp = mesh.shape["seq"], mesh.shape["data"]
    bce_all = mesh.all_reduce(bce.detach().clone(), "data")
    total = bce_all if l2 is None else bce_all + l2.detach()
    share = (bce if l2 is None else bce + l2 / dp) / S
    return share, {"loss": total, "bce": bce_all, "n_mask": n_mask}


def _sampled_softmax(model: SeqRecModel, params, batch, mm_tables,
                     item_tables, cfg: Config, train: bool,
                     gen: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """Sampled softmax over [positive | shared negatives]: the positives
    reuse the sequence item tower shifted by one (only the final column
    runs its own tower), the negatives are ``batch["sampled_neg_ids"]``
    (the host preps sample them) or drawn on the device, and with
    ``num_inbatch_negatives`` > 0 the batch's positives join them with
    their empirical logQ. With tower dedup one tower serves every site.
    The draws come from ``gen``; without one (the eval step) from a
    generator seeded 0, as the JAX eval step's fixed key."""
    t = cfg.train
    dev = batch["seq"].device
    draw = gen if gen is not None else \
        torch.Generator(device=dev).manual_seed(0)
    if "dedup_uids" in batch:
        it_seq, pos_last, neg_embs = model.dedup_spreads(params, batch,
                                                         mm_tables)
        log_feats = model.log2feats(params, batch, mm_tables, train=train,
                                    gen=gen, item_tower_override=it_seq)
        neg_ids = batch["sampled_neg_ids"]
    else:
        log_feats, it_seq = model.log2feats(params, batch, mm_tables,
                                            train=train, gen=gen,
                                            return_item_tower=True)
        pos_last = model.pos_last(params, batch, mm_tables)
        neg_ids = batch.get("sampled_neg_ids")
        if neg_ids is None:
            neg_ids = torch.randint(1, model.itemnum + 1,
                                    (t.num_sampled_negatives,),
                                    generator=draw, device=dev,
                                    dtype=torch.int32)
        neg_embs = model.candidates(params, neg_ids, mm_tables, item_tables,
                                    "negs")
    pos_embs = torch.cat([it_seq[:, 1:].to(pos_last.dtype), pos_last], 1)
    loss_mask = batch["next_token_type"] == 1
    if "sample_valid" in batch:
        loss_mask = loss_mask & (batch["sample_valid"][:, None] > 0)
    neg_logq = None
    if t.num_inbatch_negatives > 0:
        inb_ids, inb_embs, inb_logq = LS.inbatch_candidates(
            batch["pos"], pos_embs, loss_mask, t.num_inbatch_negatives,
            gen=draw)
        uni = -float(torch.log(torch.tensor(float(model.itemnum))))
        neg_logq = torch.cat([torch.full((neg_ids.shape[0],), uni,
                                         device=dev), inb_logq])
        neg_ids = torch.cat([neg_ids, inb_ids.to(neg_ids.dtype)])
        neg_embs = torch.cat([neg_embs, inb_embs.to(neg_embs.dtype)])
    loss = LS.sampled_softmax_loss(log_feats, pos_embs, neg_embs, neg_ids,
                                   batch["pos"], loss_mask, model.itemnum,
                                   neg_logq=neg_logq)
    return loss, {"loss": loss.detach(), "n_mask": loss_mask.sum().float()}


def _grad_metrics(metrics: Dict, grads) -> Dict:
    metrics = dict(metrics)
    metrics["grad_max"] = torch.stack([g.abs().max() for g in grads]).max()
    metrics["grad_mean"] = torch.stack([g.abs().mean() for g in grads]).mean()
    return metrics


def _sfx(name: str) -> str:
    """Batch-key suffix of a sparse table's prep: item_emb keeps the bare
    names, other tables append ``@<table>``."""
    return "" if name == "item_emb" else "@" + name


def packed_item_table(cfg: Config, itemnum: int) -> bool:
    """Whether ``item_emb`` is at packed scale: Vp rows, written back in
    whole groups (``ops.sparse_table.is_packed_scale``). ``user_emb`` never
    is."""
    return bool(cfg.model.pack_big_tables) and ST.is_packed_scale(
        itemnum + 1, cfg.model.hidden_units)


def _collect_touched_ids(batch, cfg: Config, name: str) -> torch.Tensor:
    """Every id the step can touch in table ``name`` (the device fallback
    when the batch ships no ``touched_uids``). item_emb: sequence item
    tokens, positives, and the sampled or uniform negatives; user_emb: the
    sequence's user tokens."""
    tt, seq = batch["token_type"], batch["seq"]
    zero = torch.zeros_like(seq)
    if name == "user_emb":
        return torch.where(tt == 2, seq, zero).reshape(-1)
    negs = batch["sampled_neg_ids"] \
        if cfg.train.loss_type == "sampled_softmax" else batch["neg"]
    return torch.cat([torch.where(tt == 1, seq, zero).reshape(-1),
                      batch["pos"].reshape(-1).to(seq.dtype),
                      negs.reshape(-1).to(seq.dtype)])


def sparse_loss_backward(model: SeqRecModel, cfg: Config, state: TrainState,
                         batch, mm_tables, item_tables,
                         gen: Optional[torch.Generator] = None):
    """Forward and backward of a sparse-table step: per table in
    ``train.sparse_tables`` the touched rows are gathered (by whole groups
    at packed scale) into a :class:`ops.sparse_table.GatheredRows` whose
    rows take the gradient; then the loss and its backward, into the dense
    leaves' ``.grad`` and the rows' ``.grad``. Returns (loss, metrics, per
    table {"uids", "rows", "V", "group_plan", "group_buf"})."""
    batch = dict(batch)
    t = cfg.train
    if t.loss_type == "sampled_softmax" and "sampled_neg_ids" not in batch:
        batch["sampled_neg_ids"] = torch.randint(
            1, model.itemnum + 1, (t.num_sampled_negatives,), generator=gen,
            device=batch["seq"].device, dtype=torch.int32)
    params = dict(state.params)
    per = {}
    for name in t.sparse_tables:
        sfx = _sfx(name)
        table = state.params[name]
        V = table.shape[0]
        plans = batch.pop("sparse_plans" + sfx, {})
        group_plan = None
        if "scatter_groups" + sfx in batch:
            group_plan = {k: batch.pop(f"scatter_{k}{sfx}")
                          for k in ("groups", "slot_src", "uid_pos")}
        elif name == "item_emb" and packed_item_table(cfg, model.itemnum):
            # its write-back is the group kernel's, never a row write
            raise ValueError(
                "item_emb is at packed scale (>= TABLE_PACK_MIN_ROWS rows) "
                "and writes back whole groups: the batch needs its host "
                "group plan (scatter_groups, from augment_batch_sparse)")
        if "touched_uids" + sfx in batch:
            uids = batch.pop("touched_uids" + sfx)
        else:
            ids_all = _collect_touched_ids(batch, cfg, name)
            uids = ST.unique_touched(ids_all, ids_all.shape[0], V)
        with torch.no_grad():
            if group_plan is not None:
                # one dim-0 group gather feeds the forward's rows and the
                # write-back's old group content
                gathered, group_buf = ST.gather_rows_grouped(
                    table, uids, group_plan, cfg.model.hidden_units)
            else:
                gathered, group_buf = ST.gather_rows(table, uids), None
        rows = gathered.rows.requires_grad_(True)
        params[name] = ST.GatheredRows(uids, rows, plans)
        per[name] = dict(uids=uids, rows=rows, V=V, group_plan=group_plan,
                         group_buf=group_buf)
    loss, metrics = compute_loss(model, params, batch, mm_tables,
                                 item_tables, cfg, train=True, gen=gen)
    loss.backward()
    return loss, metrics, per


def make_train_step(model: SeqRecModel, cfg: Config, mesh=None):
    """``step(state, batch, mm_tables, item_tables) -> (state, metrics)``:
    loss, backward, AdamW over the dense leaves at the step's learning
    rate. With ``train.sparse_tables`` the listed tables train row-sparse
    (:func:`sparse_loss_backward`, then ``ops.sparse_table.
    apply_row_update`` at ``lr_at_step(step + 1)`` and global step ``step +
    1``), and the metrics count the step's touched rows. The state updates
    in place; the dense gradients stay on the leaves (``.grad``) until the
    next step. Metrics stay on the device."""
    check_supported(cfg, mesh)
    t = cfg.train
    sparse = tuple(t.sparse_tables)
    if "item_emb" not in sparse and packed_item_table(cfg, model.itemnum):
        raise ValueError(
            "tables at packed scale (>=30M rows) must train sparsely: set "
            "train.sparse_tables=('item_emb',) or pack_big_tables=False")
    proc = mesh is not None and mesh.process

    def step_fn(state: TrainState, batch, mm_tables, item_tables):
        dev = next(iter(_flatten(state.params).values())).device
        gen = step_generator(t.seed, state.step, dev, _data_shard(mesh))
        state.opt.zero_grad(set_to_none=True)
        if sparse:
            _, metrics, per = sparse_loss_backward(
                model, cfg, state, batch, mm_tables, item_tables, gen)
        else:
            loss, metrics = compute_loss(model, state.params,
                                         shard_batch(batch, mesh),
                                         mm_tables, item_tables, cfg,
                                         train=True, gen=gen, mesh=mesh)
            loss.backward()
        leaves = [p for _, p in dense_leaves(state.params, cfg)]
        for p in leaves:
            # AdamW skips a leaf without a gradient, where optax still
            # decays it: a leaf the loss does not reach gets zeros
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in leaves]
        if proc:
            # one all-reduce of every gradient: the global batch's sum
            flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
        for group in state.opt.param_groups:
            group["lr"] = lr_at_step(t, state.step)
        state.opt.step()
        if sparse:
            touched = torch.zeros((), dtype=torch.int64, device=dev)
            with torch.no_grad():
                for name, p in per.items():
                    drows = p["rows"].grad if p["rows"].grad is not None \
                        else torch.zeros_like(p["rows"])
                    grouped = p["group_plan"] is not None
                    ST.apply_row_update(
                        state.params[name], state.tables[name], p["uids"],
                        drows, group_plan=p["group_plan"],
                        rows0=p["rows"].detach() if grouped else None,
                        table_old=p["group_buf"], kind=t.table_optimizer,
                        lr=lr_at_step(t, state.step + 1),
                        step=state.step + 1, b1=t.adam_b1, b2=t.adam_b2,
                        weight_decay=t.weight_decay)
                    grads.append(drows)
                    # the sentinel is the physical row count: real rows only
                    touched += (p["uids"] < p["V"]).sum()
            metrics = dict(metrics, touched_rows=touched)
        metrics = _grad_metrics(metrics, grads)
        state.step += 1
        return state, metrics

    return step_fn


def make_eval_step(model: SeqRecModel, cfg: Config, mesh=None):
    @torch.no_grad()
    def step_fn(params, batch, mm_tables, item_tables):
        return compute_loss(model, params, shard_batch(batch, mesh),
                            mm_tables, item_tables, cfg, train=False,
                            mesh=mesh)[1]

    return step_fn


# ---------------------------------------------------------------------------
# tower dedup (host numpy)
# ---------------------------------------------------------------------------

def tower_dedup_capacity(cfg: Config, itemnum: int,
                         n_data_shards: int = 1) -> int:
    """Static unique-candidate capacity of the tower-dedup plan: a
    ``tower_dedup_cap_frac`` fraction of the step's candidate-id stream
    (seq item tokens + the final-positive column + negatives), clamped to
    the vocabulary and rounded up to a multiple of 8."""
    B = cfg.train.batch_size // n_data_shards
    L = cfg.model.maxlen + 1
    n = B * L + B
    if cfg.train.loss_type == "sampled_softmax":
        n += 0 if n_data_shards > 1 else cfg.train.num_sampled_negatives
    else:
        n += B * L
    cap = min(int(np.ceil(n * cfg.train.tower_dedup_cap_frac)), itemnum + 1)
    return max(16, -(-cap // 8) * 8)


class _DedupOverflow(Exception):
    def __init__(self, unique: int, cap: int):
        super().__init__(unique, cap)
        self.unique, self.cap = unique, cap


#: rate-limited tower-dedup fallback warnings: count of fallbacks so far
#: (warn on the first, then every 1000th)
_DEDUP_FALLBACKS = {"n": 0}


def _warn_dedup_fallback(e: _DedupOverflow) -> None:
    n = _DEDUP_FALLBACKS["n"] = _DEDUP_FALLBACKS["n"] + 1
    if n == 1 or n % 1000 == 0:
        print(f"WARNING: tower-dedup fallback #{n}: {e.unique} unique "
              f"candidate ids exceed the static capacity {e.cap}; this "
              "batch trains through the dense per-position towers (exact, "
              "just slower). If most batches fall back, raise "
              "train.tower_dedup_cap_frac or disable train.tower_dedup.")


def augment_batch_dedup(batch, cfg: Config, item_feats, itemnum: int,
                        step_key=None, n_data_shards: int = 1):
    """HOST-side tower-dedup prep (``cfg.train.tower_dedup``): dedup the
    step's candidate ids (sequence item tokens, the final-positive column,
    the negatives), gather the unique ids' features from the host feature
    tables, and ship one ``planned_lookup`` plan per consumer site. The
    device then runs ONE item tower at [cap] rows. Exact: spreading the
    unique rows reproduces the per-position towers.

    A batch whose unique count exceeds the static capacity ships
    un-dedup'd (dense per-position towers) with a rate-limited warning.
    Under sampled softmax the negatives are sampled here from ``step_key``
    (numpy), where the batch has none yet. Runs before
    :func:`augment_batch_sparse`, whose item_emb plan keys on the dedup'd
    id column."""
    if n_data_shards != 1:
        _unported("the stacked per-shard tower-dedup plan",
                  "Multi-device layer")
    out = dict(batch)
    ss = cfg.train.loss_type == "sampled_softmax"
    if ss and "sampled_neg_ids" not in out:
        out["sampled_neg_ids"] = _sample_negatives(cfg, itemnum, step_key)
    tt = np.asarray(out["token_type"])
    seq_ids = np.where(tt == 1, np.asarray(out["seq"]), 0)
    pos_last = np.asarray(out["pos"])[:, -1:]
    negs = np.asarray(out["sampled_neg_ids"] if ss else out["neg"])
    cap = tower_dedup_capacity(cfg, itemnum)
    sites = [("seq", seq_ids), ("pos_last", pos_last), ("negs", negs)]
    u = np.unique(np.concatenate([i.reshape(-1) for _, i in sites]))
    if len(u) > cap:
        _warn_dedup_fallback(_DedupOverflow(len(u), cap))
        return out   # un-dedup'd: per-position features intact
    uids = np.full((cap,), itemnum + 1, np.int32)   # sentinel sorts last
    uids[:len(u)] = u
    out["dedup_uids"] = uids
    safe = np.where(uids <= itemnum, uids, 0)        # sentinel -> zero row
    out["dedup_sparse"] = item_feats.sparse[safe].astype(np.int32)
    out["dedup_array"] = item_feats.array[safe].astype(np.int32)
    for site, ids in sites:
        for k, v in ST.build_lookup_plan(uids, ids).items():
            out[f"dedup_{site}_{k}"] = v
    # the per-position feature copies these plans replace
    for k in ("seq_item_sparse", "seq_item_array", "pos_item_sparse",
              "pos_item_array"):
        out.pop(k, None)
    return out


def _sample_negatives(cfg: Config, itemnum: int, step_key) -> np.ndarray:
    """The step's shared uniform negatives, drawn on the host from
    ``step_key`` as the JAX package draws them."""
    r = np.random.default_rng(step_key)
    return r.integers(1, itemnum + 1,
                      cfg.train.num_sampled_negatives).astype(np.int32)


# ---------------------------------------------------------------------------
# sparse-table prep (host numpy)
# ---------------------------------------------------------------------------

def sparse_touch_capacity(cfg: Config, name: str = "item_emb") -> int:
    """Static touched-id capacity of one batch in table ``name``."""
    if name == "user_emb":
        # the samplers hold rows to MAX_USER_TOKENS_PER_ROW user tokens, so
        # the dedup'd user ids number at most B * K (+1 for the padding 0)
        return cfg.train.batch_size * MAX_USER_TOKENS_PER_ROW + 1
    n = 2 * cfg.train.batch_size * (cfg.model.maxlen + 1)
    if cfg.train.loss_type == "sampled_softmax":
        return n + cfg.train.num_sampled_negatives
    return n + cfg.train.batch_size * (cfg.model.maxlen + 1)


def _user_token_positions(token_type, K: int):
    """Host twin of embedding.fuse_sequence's earliest-K user positions:
    (posk [B, K], validk [B, K])."""
    B, L = token_type.shape
    is_u = token_type == 2
    score = np.where(is_u, -np.arange(L, dtype=np.int64)[None, :], -L - 1)
    posk = np.argsort(-score, axis=1, kind="stable")[:, :K]
    return posk, np.take_along_axis(is_u, posk, axis=1)


def augment_batch_sparse(batch, cfg: Config, itemnum: int, step_key,
                         n_table_shards: int = 1, usernum: int = 0):
    """HOST-side sparse-table prep, in the input pipeline: samples the
    softmax negatives (numpy) where the batch has none, and per table in
    ``train.sparse_tables`` ships the dedup'd ``touched_uids`` (sentinel =
    the table's physical rows), at packed scale the group write plan
    (``scatter_groups``, ``scatter_slot_src``, ``scatter_uid_pos``), and
    one lookup plan per call site (``sparse_plans``). Keys of tables other
    than item_emb carry ``@<table>``; ``user_emb`` needs ``usernum``. The
    per-shard plan of a mesh-sharded table (``n_table_shards`` > 1) is not
    ported."""
    if n_table_shards != 1:
        _unported("the per-shard plan of a mesh-sharded table",
                  "Multi-device layer")
    out = dict(batch)
    ss = cfg.train.loss_type == "sampled_softmax"
    if ss and "sampled_neg_ids" not in out:
        out["sampled_neg_ids"] = _sample_negatives(cfg, itemnum, step_key)
    tt, seq = np.asarray(out["token_type"]), np.asarray(out["seq"])
    D = cfg.model.hidden_units
    for name in (cfg.train.sparse_tables or ("item_emb",)):
        sfx = _sfx(name)
        packed = False
        if name == "user_emb":
            if usernum <= 0:
                raise ValueError("augment_batch_sparse: user_emb needs "
                                 "usernum")
            ids_all = np.where(tt == 2, seq, 0).reshape(-1)
            rows = usernum + 1        # user_emb is never packed
        else:
            negs = out["sampled_neg_ids"] if ss else out["neg"]
            ids_all = np.concatenate([
                np.where(tt == 1, seq, 0).reshape(-1),
                np.asarray(out["pos"]).reshape(-1),
                np.asarray(negs).reshape(-1)])
            rows = itemnum + 1
            packed = packed_item_table(cfg, itemnum)
        vocab = ST.padded_table_rows(rows) if packed else rows
        uids = ST.host_unique_touched(ids_all,
                                      sparse_touch_capacity(cfg, name), vocab)
        out["touched_uids" + sfx] = uids
        if packed:
            plan = ST.host_group_plan(uids, vocab, ST.scatter_group_rows(D))
            for k, v in plan.items():
                out[f"scatter_{k}{sfx}"] = v
        if name == "user_emb":
            posk, validk = _user_token_positions(tt, MAX_USER_TOKENS_PER_ROW)
            uk = np.take_along_axis(seq, posk, axis=1) * validk
            plans = {"user": ST.build_lookup_plan(uids, uk)}
        elif "dedup_uids" in out:
            # tower dedup: the item_emb lookup is the dedup'd tower's column
            plans = {"dedup": ST.build_lookup_plan(uids, out["dedup_uids"])}
        else:
            plans = {"seq": ST.build_lookup_plan(uids,
                                                 np.where(tt == 1, seq, 0)),
                     "pos_last": ST.build_lookup_plan(
                         uids, np.asarray(out["pos"])[:, -1:])}
            if ss:
                plans["negs"] = ST.build_lookup_plan(uids,
                                                     out["sampled_neg_ids"])
            else:
                plans["posneg"] = ST.build_lookup_plan(uids, out["neg"])
        out["sparse_plans" + sfx] = plans
    return out


# ---------------------------------------------------------------------------
# epoch-end retrieval eval
# ---------------------------------------------------------------------------

#: items the retrieval eval encodes at a time
_EVAL_ENCODE_ROWS = 8192


def make_retrieval_eval(model: SeqRecModel, tables: Mapping, mm_tables,
                        put, max_users: int, k: int = 10):
    """Epoch-end retrieval eval over the validation split: HR@k and NDCG@k
    (the competition metric). The whole item corpus is encoded with the
    item tower, in chunks of 8,192 ids, and the last next-item position of
    up to ``max_users`` validation users is scored against it with
    :func:`retrieval.mips.topk_mips_approx`, as the JAX package's
    ``make_retrieval_eval`` does. Unlike it, the last chunk is not padded
    with item-0 rows, which the JAX package scores as candidates (they can
    take a place in a top k); for ``itemnum % 8192 == 0`` the two agree.

    ``tables``: the device item-feature tables of :func:`device_tables`;
    ``put``: a host batch to the device. Returns ``eval_fn(params,
    valid_loader) -> {"hr", "ndcg", "n"}`` or None without a scored
    user."""
    from ..retrieval import mips as MIPS

    @torch.no_grad()
    def encode_all(params):
        """[itemnum, D]: row i is item id i + 1."""
        dev = tables["sparse"].device
        last = tables["sparse"].shape[0] - 1
        out = []
        for s in range(1, model.itemnum + 1, _EVAL_ENCODE_ROWS):
            ids = torch.arange(s, min(s + _EVAL_ENCODE_ROWS,
                                      model.itemnum + 1), device=dev)
            rows = ids.clamp(max=last)
            out.append(model.encode_items(
                params, ids, tables["sparse"][rows], tables["array"][rows],
                {fid: t[rows] for fid, t in tables["mm"].items()}))
        return torch.cat(out)

    def eval_fn(params, valid_loader):
        qs, ts, seen = [], [], 0
        for batch in valid_loader.epoch(0):
            with torch.no_grad():
                q = model.predict(params, put(batch), mm_tables)
            q = q.float().cpu().numpy()
            # the last position must be a real sample predicting an item
            ok = (np.asarray(batch["sample_valid"]) == 1) \
                & (np.asarray(batch["next_token_type"])[:, -1] == 1) \
                & (np.asarray(batch["pos"])[:, -1] > 0)
            qs.append(q[ok])
            ts.append(np.asarray(batch["pos"])[:, -1][ok])
            seen += int(ok.sum())
            if seen >= max_users:
                break
        if seen == 0:
            return None
        q = np.concatenate(qs)[:max_users]
        t = np.concatenate(ts)[:max_users]
        corpus = encode_all(params)
        _, idx = MIPS.topk_mips_approx(
            torch.as_tensor(q, device=corpus.device), corpus.float(), k=k)
        got = idx.cpu().numpy() + 1
        hit = got == t[:, None]
        any_hit = hit.any(axis=1)
        ranks = hit.argmax(axis=1)
        ndcg = np.where(any_hit, 1.0 / np.log2(ranks + 2.0), 0.0)
        return {"hr": float(any_hit.mean()), "ndcg": float(ndcg.mean()),
                "n": int(len(t))}

    return eval_fn


# ---------------------------------------------------------------------------
# epoch loop
# ---------------------------------------------------------------------------

def train_loop(model: SeqRecModel, cfg: Config, train_loader, valid_loader,
               item_tables: ItemFeatureTables,
               log_dir: Optional[str] = None,
               tb_dir: Optional[str] = None,
               ckpt_dir: Optional[str] = None,
               state: Optional[TrainState] = None,
               num_epochs: Optional[int] = None,
               start_epoch: int = 0,
               skip_steps: int = 0,
               mesh=None,
               profile_steps: int = 0,
               profile_dir: Optional[str] = None,
               profile_start: int = 4,
               verbose: bool = True,
               device="cuda") -> TrainState:
    """The reference epoch loop: train epochs with per-step telemetry
    (JSONL ``train.log`` and TensorBoard), a full validation pass and a
    checkpoint per epoch. ``start_epoch`` = epochs a resumed ``state`` has
    done; the step count resumes from ``state.step``.

    Metrics stay on the device and are fetched every ``log_every`` steps.
    ``profile_steps`` > 0 traces steps ``profile_start`` ..
    ``profile_start + profile_steps - 1`` with ``torch.profiler`` into
    ``profile_dir/trace.json``. The loop installs no SIGTERM handler:
    preemption checkpoints are not ported yet.

    With a ``mesh`` the steps run on it (see :func:`make_train_step`); on a
    process mesh every process runs the loop on the same global batches,
    and only rank 0 logs, evaluates retrieval and writes checkpoints."""
    from .checkpoint import save_checkpoint

    if skip_steps:
        _unported("mid-epoch resume from a preemption checkpoint",
                  "Resilience")
    device = torch.device(device)
    if state is None:
        state = init_state(model, cfg, device=device)
    train_step = make_train_step(model, cfg, mesh)
    eval_step = make_eval_step(model, cfg, mesh)
    if mesh is not None and mesh.process and mesh.rank != 0:
        log_dir = tb_dir = ckpt_dir = None
        verbose = False
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, eval_retrieval_users=0))
    tables = device_tables(item_tables, device)
    mm_tables = tables["mm"]

    def put(b):
        return put_batch(b, device)

    epochs = num_epochs or cfg.train.num_epochs
    jlog = T.JsonlLogger(log_dir)
    tb = T.TBWriter(tb_dir)
    timer = T.StepTimer(total_steps=len(train_loader) * epochs,
                        initial_step=state.step)

    probe_batch = None
    if valid_loader is not None and len(valid_loader) > 0:
        probe_batch = put(next(iter(valid_loader.epoch(0))))

    # epoch-end competition-metric eval (train.eval_retrieval_users)
    retrieval_eval_fn = None
    if cfg.train.eval_retrieval_users > 0 and valid_loader is not None:
        retrieval_eval_fn = make_retrieval_eval(
            model, tables, mm_tables, put,
            max_users=cfg.train.eval_retrieval_users)

    # the dedup plan indexes whole rows of one process's batch: not under a
    # seq mesh or several processes (JAX train/trainer.py:1070-1080)
    dedup_on = cfg.train.tower_dedup and mesh is None
    if cfg.train.tower_dedup and not dedup_on and verbose:
        print("WARNING: train.tower_dedup needs a single-process mesh "
              "without seq/pipe sharding (model>1 only with sparse "
              "item_emb) — disabled for this run")
    sparse = bool(cfg.train.sparse_tables)
    # a touched row read by the gather and written back, in the table dtype
    row_bytes = cfg.model.hidden_units * \
        (2 if cfg.model.table_dtype == "bfloat16" else 4)
    pending = []   # (record without loss, device metrics)

    def flush(epoch):
        if not pending:
            return
        keys = [k for k in ("loss", "bce", "grad_max", "grad_mean",
                            "touched_rows") if k in pending[0][1]]
        fetched = torch.stack([torch.stack([m[k].float() for k in keys])
                               for _, m in pending]).tolist()
        for (rec, _), vals in zip(pending, fetched):
            m = dict(zip(keys, vals))
            gs = rec["global_step"]
            rec["loss"] = m["loss"]
            if "bce" in m:
                rec["bce"] = m["bce"]
            jlog.write(rec)
            tb.scalar("Loss/train", m["loss"], gs)
            if "bce" in m:
                tb.scalar("Loss/BCE", m["bce"], gs)
            tb.scalar("Performance/step_time", rec["step_time"], gs)
            tb.scalar("Performance/steps_per_second",
                      rec["steps_per_second"], gs)
            tb.scalar("Performance/examples_per_second_per_chip",
                      rec["steps_per_second"] * cfg.train.batch_size, gs)
            if "touched_rows" in m and rec["step_time"] > 0:
                # the step's own count of dedup'd rows across sparse tables
                gb = m["touched_rows"] * row_bytes * 2 / 1e9
                tb.scalar("Performance/lookup_gb_s", gb / rec["step_time"],
                          gs)
                tb.scalar("Performance/touched_rows", m["touched_rows"], gs)
            if gs % cfg.train.grad_log_every == 0:
                lr_now = lr_at_step(cfg.train, gs)
                tb.scalar("Gradient/max", m["grad_max"], gs)
                tb.scalar("Gradient/mean", m["grad_mean"], gs)
                tb.scalar("LearningRate/base", lr_now, gs)
                if sparse:
                    tb.scalar("LearningRate/table", lr_now, gs)
        last = pending[-1][0]
        if verbose:
            print(f"  epoch {epoch} step {last['step'] + 1}/"
                  f"{len(train_loader)} loss {last['loss']:.4f} "
                  f"{last['steps_per_second']:.2f} steps/s "
                  f"ETA {T.format_time(last['estimated_remaining_time'])}")
        pending.clear()

    def epoch_batches(epoch):
        if not (dedup_on or sparse):
            return train_loader.epoch(epoch)

        def prep(b, i):
            key = (cfg.train.seed, 97, epoch, i)
            if dedup_on:
                # first: the sparse prep keys its item_emb plan on the
                # dedup'd id column
                b = augment_batch_dedup(b, cfg, item_tables, model.itemnum,
                                        step_key=key)
            if sparse:
                b = augment_batch_sparse(b, cfg, model.itemnum, key,
                                         usernum=model.usernum)
            return b

        # the cached loader runs the prep on its worker pool (keyed by batch
        # index, so deterministic); other loaders get it serially on the
        # prefetch thread
        if getattr(train_loader, "supports_prep", False):
            return train_loader.epoch(epoch, prep=prep)
        return (prep(b, i) for i, b in enumerate(train_loader.epoch(epoch)))

    if start_epoch >= epochs and verbose:
        print(f"resume: {start_epoch}/{epochs} epochs already trained — "
              "nothing to do")
    prof = None
    ticks = 0
    try:
        for epoch in range(start_epoch + 1, epochs + 1):
            for step, batch in enumerate(prefetch(epoch_batches(epoch),
                                                  put)):
                ticks += 1
                if profile_steps and profile_dir and prof is None \
                        and ticks == profile_start:
                    prof = _start_profiler()
                t0 = time.time()
                state, metrics = train_step(state, batch, mm_tables, tables)
                if prof is not None and \
                        ticks == profile_start + profile_steps - 1:
                    _stop_profiler(prof, profile_dir, verbose)
                    prof = None
                rec = timer.tick(time.time() - t0)
                rec.update({"global_step": timer.global_step, "epoch": epoch,
                            "step": step})
                pending.append((rec, metrics))
                if (step + 1) % cfg.train.log_every == 0:
                    flush(epoch)
                if probe_batch is not None and \
                        timer.global_step % cfg.train.grad_log_every == 0:
                    vm = eval_step(state.params, probe_batch, mm_tables,
                                   tables)
                    tb.scalar("Valid/loss", float(vm["loss"]),
                              timer.global_step)
            flush(epoch)

            # validation pass
            vstart = time.time()
            vloss, vsteps = 0.0, 0
            if valid_loader is not None:
                for batch in prefetch(valid_loader.epoch(0), put):
                    m = eval_step(state.params, batch, mm_tables, tables)
                    vloss += float(m["loss"])
                    vsteps += 1
            valid_loss = vloss / max(1, vsteps)
            vtime = time.time() - vstart
            tb.scalar("Loss/valid", valid_loss, timer.global_step)
            tb.scalar("Performance/validation_time", vtime, epoch)
            if verbose:
                print(f"epoch {epoch}: valid_loss {valid_loss:.4f} "
                      f"({T.format_time(vtime)})")
            if retrieval_eval_fn is not None:
                r = retrieval_eval_fn(state.params, valid_loader)
                if r is not None:
                    tb.scalar("Retrieval/HR@10", r["hr"], timer.global_step)
                    tb.scalar("Retrieval/NDCG@10", r["ndcg"],
                              timer.global_step)
                    jlog.write({"event": "retrieval_eval", "epoch": epoch,
                                "global_step": timer.global_step, **r})
                    if verbose:
                        print(f"epoch {epoch}: HR@10 {r['hr']:.4f} "
                              f"NDCG@10 {r['ndcg']:.4f} (n={r['n']})")
            if ckpt_dir:
                path = save_checkpoint(ckpt_dir, state, timer.global_step,
                                       valid_loss,
                                       extra_meta={"epoch": epoch},
                                       model_config=model.cfg)
                if verbose:
                    print(f"checkpoint written: {path.name}")
    finally:
        if prof is not None:   # run too short for the window
            _stop_profiler(prof, profile_dir, verbose)
        jlog.close()
        tb.close()
    return state


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof, profile_dir, verbose: bool) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
    if verbose:
        print(f"profiler: trace written to {profile_dir}")
