"""Training: train and eval steps, tower-dedup prep, epoch loop.

Counterpart of ``tencent_recommendation_2025_tpu/train/trainer.py`` for one
device and dense tables: the BCE loss, backward (the fused block's backward
kernel on the card), AdamW, per-epoch validation and checkpoints. PyTorch
runs eagerly, so a step is a plain function; the train state is updated in
place (the JAX package's is immutable and donated), which keeps one copy of
the parameters and optimizer moments.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: a mesh, ``sparse_tables``, ``grad_accum_steps > 1``, the sampled
softmax loss, ``eval_retrieval_users > 0``, and the SIGTERM / preemption
checkpoint with its mid-epoch resume.
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
from ..config import Config
from ..data.featurizer import ItemFeatureTables
from ..data.pipeline import prefetch
from ..models.baseline import SeqRecModel
from ..ops import losses as LS
from ..ops.sparse_table import build_lookup_plan
from . import telemetry as T


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1, "
                              f"{item}")


def check_supported(cfg: Config, mesh=None) -> None:
    """Raise on the training options the port does not cover yet."""
    t = cfg.train
    if mesh is not None or cfg.mesh.data * cfg.mesh.model * cfg.mesh.seq \
            * cfg.mesh.pipe > 1:
        _unported("training on a device mesh", "Multi-device layer")
    if t.sparse_tables:
        _unported("sparse-table training (train.sparse_tables)",
                  "Sparse tables and grad accumulation")
    if t.grad_accum_steps > 1:
        _unported("gradient accumulation (train.grad_accum_steps > 1)",
                  "Sparse tables and grad accumulation")
    if t.loss_type != "bce":
        _unported(f"the {t.loss_type} loss", "Sampled softmax")
    if t.eval_retrieval_users > 0:
        _unported("epoch-end retrieval eval (train.eval_retrieval_users)",
                  "Retrieval tiers")


@dataclasses.dataclass
class TrainState:
    """Parameters (a nested dict of f32 leaves that take gradients), their
    AdamW optimizer and the count of steps taken."""
    params: Dict
    opt: torch.optim.Optimizer
    step: int = 0


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


def make_optimizer(cfg: Config, params: Mapping) -> torch.optim.Optimizer:
    """AdamW as optax builds it: eps 1e-8 outside the square root, weight
    decay on every leaf (none with ``weight_decay == 0``: plain Adam); the
    learning rate is set before each step from :func:`lr_at_step`."""
    t = cfg.train
    return torch.optim.AdamW([p for _, p in param_leaves(params)],
                             lr=lr_at_step(t, 0), betas=(t.adam_b1, t.adam_b2),
                             eps=1e-8, weight_decay=t.weight_decay)


def init_state(model: SeqRecModel, cfg: Config, seed: Optional[int] = None,
               params: Optional[Mapping] = None,
               device="cpu") -> TrainState:
    """A fresh state: parameters drawn from ``seed`` (default
    ``cfg.train.seed``), or the given ``params``, as leaves on ``device``
    that take gradients."""
    if params is None:
        seed = cfg.train.seed if seed is None else seed
        params = model.init(torch.Generator().manual_seed(seed))

    def leafify(t):
        if isinstance(t, Mapping):
            return {k: leafify(v) for k, v in t.items()}
        return t.detach().to(device).clone().requires_grad_(True)

    params = leafify(params)
    return TrainState(params, make_optimizer(cfg, params), 0)


def device_tables(item_tables: ItemFeatureTables, device) -> Dict[str, Any]:
    """The static item-feature and mm tables, on the device once."""
    return {"sparse": torch.as_tensor(item_tables.sparse, device=device),
            "array": torch.as_tensor(item_tables.array, device=device),
            "mm": {k: torch.as_tensor(v, device=device)
                   for k, v in item_tables.mm.items()}}


def put_batch(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's randomness: a generator on the device seeded from
    (seed + 1, step), as the JAX step folds the step into its key, so a run
    is reproducible step by step."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(
        [seed + 1, step]).generate_state(1, np.uint64)[0] >> 1))
    return gen


def compute_loss(model: SeqRecModel, params, batch, mm_tables, item_tables,
                 cfg: Config, train: bool,
                 gen: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """The reference BCE over next-item positions, plus the L2 penalty on
    the item table when ``l2_emb`` > 0."""
    if cfg.train.loss_type != "bce":
        _unported(f"the {cfg.train.loss_type} loss", "Sampled softmax")
    pos_logits, neg_logits, loss_mask = model.logits(
        params, batch, mm_tables, item_tables, train=train, gen=gen)
    bce = LS.reference_bce_loss(pos_logits, neg_logits, loss_mask)
    loss = bce
    if cfg.train.l2_emb > 0.0:
        loss = loss + LS.l2_emb_penalty(params["item_emb"], cfg.train.l2_emb)
    return loss, {"loss": loss.detach(), "bce": bce.detach(),
                  "n_mask": loss_mask.sum().float()}


def _grad_metrics(metrics: Dict, grads) -> Dict:
    metrics = dict(metrics)
    metrics["grad_max"] = torch.stack([g.abs().max() for g in grads]).max()
    metrics["grad_mean"] = torch.stack([g.abs().mean() for g in grads]).mean()
    return metrics


def make_train_step(model: SeqRecModel, cfg: Config, mesh=None):
    """``step(state, batch, mm_tables, item_tables) -> (state, metrics)``:
    loss, backward, AdamW at the step's learning rate. The state updates in
    place; the gradients stay on the leaves (``.grad``) until the next
    step. Metrics stay on the device."""
    check_supported(cfg, mesh)

    def step_fn(state: TrainState, batch, mm_tables, item_tables):
        dev = next(iter(_flatten(state.params).values())).device
        gen = step_generator(cfg.train.seed, state.step, dev)
        state.opt.zero_grad(set_to_none=True)
        loss, metrics = compute_loss(model, state.params, batch, mm_tables,
                                     item_tables, cfg, train=True, gen=gen)
        loss.backward()
        leaves = [p for _, p in param_leaves(state.params)]
        for p in leaves:
            # AdamW skips a leaf without a gradient, where optax still
            # decays it: a leaf the loss does not reach gets zeros
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = _grad_metrics(metrics, [p.grad for p in leaves])
        for group in state.opt.param_groups:
            group["lr"] = lr_at_step(cfg.train, state.step)
        state.opt.step()
        state.step += 1
        return state, metrics

    return step_fn


def make_eval_step(model: SeqRecModel, cfg: Config):
    @torch.no_grad()
    def step_fn(params, batch, mm_tables, item_tables):
        return compute_loss(model, params, batch, mm_tables, item_tables, cfg,
                            train=False)[1]

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
    ``step_key`` is accepted for the JAX signature (it seeds the sampled
    softmax negatives there, which the port does not have yet)."""
    if n_data_shards != 1:
        _unported("the stacked per-shard tower-dedup plan",
                  "Multi-device layer")
    if cfg.train.loss_type != "bce":
        _unported(f"tower dedup with the {cfg.train.loss_type} loss",
                  "Sampled softmax")
    out = dict(batch)
    tt = np.asarray(out["token_type"])
    seq_ids = np.where(tt == 1, np.asarray(out["seq"]), 0)
    pos_last = np.asarray(out["pos"])[:, -1:]
    negs = np.asarray(out["neg"])
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
        for k, v in build_lookup_plan(uids, ids).items():
            out[f"dedup_{site}_{k}"] = v
    # the per-position feature copies these plans replace
    for k in ("seq_item_sparse", "seq_item_array", "pos_item_sparse",
              "pos_item_array"):
        out.pop(k, None)
    return out


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
    preemption checkpoints are not ported yet."""
    from .checkpoint import save_checkpoint

    if skip_steps:
        _unported("mid-epoch resume from a preemption checkpoint",
                  "Resilience")
    device = torch.device(device)
    if state is None:
        state = init_state(model, cfg, device=device)
    train_step = make_train_step(model, cfg, mesh)
    eval_step = make_eval_step(model, cfg)
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

    dedup_on = cfg.train.tower_dedup
    pending = []   # (record without loss, device metrics)

    def flush(epoch):
        if not pending:
            return
        keys = ("loss", "bce", "grad_max", "grad_mean")
        fetched = torch.stack([torch.stack([m[k].float() for k in keys])
                               for _, m in pending]).tolist()
        for (rec, _), vals in zip(pending, fetched):
            m = dict(zip(keys, vals))
            gs = rec["global_step"]
            rec["loss"] = m["loss"]
            rec["bce"] = m["bce"]
            jlog.write(rec)
            tb.scalar("Loss/train", m["loss"], gs)
            tb.scalar("Loss/BCE", m["bce"], gs)
            tb.scalar("Performance/step_time", rec["step_time"], gs)
            tb.scalar("Performance/steps_per_second",
                      rec["steps_per_second"], gs)
            tb.scalar("Performance/examples_per_second_per_chip",
                      rec["steps_per_second"] * cfg.train.batch_size, gs)
            if gs % cfg.train.grad_log_every == 0:
                tb.scalar("Gradient/max", m["grad_max"], gs)
                tb.scalar("Gradient/mean", m["grad_mean"], gs)
                tb.scalar("LearningRate/base", lr_at_step(cfg.train, gs), gs)
        last = pending[-1][0]
        if verbose:
            print(f"  epoch {epoch} step {last['step'] + 1}/"
                  f"{len(train_loader)} loss {last['loss']:.4f} "
                  f"{last['steps_per_second']:.2f} steps/s "
                  f"ETA {T.format_time(last['estimated_remaining_time'])}")
        pending.clear()

    def epoch_batches(epoch):
        if not dedup_on:
            return train_loader.epoch(epoch)

        def prep(b, i):
            return augment_batch_dedup(b, cfg, item_tables, model.itemnum,
                                       step_key=(cfg.train.seed, 97, epoch,
                                                 i))

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
