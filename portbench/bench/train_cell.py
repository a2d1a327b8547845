"""A training cell: the port's ``train_loop`` driven as ``cli.train`` drives
it, over the benchmark's batches, for the checked steps and then the timed
window, in one call.

Set-up makes the tables, the weights and the train state from the seed,
then runs the first ``checked_steps`` steps through the window's own call
and feed (``train_loop`` with its host preps on the loader's worker pool,
as ``cli.train``'s cached loader runs them, its prefetch thread and its
``put_batch``). The same loader goes on into the window: the window starts
when the step after the checked ones starts and ends when ``train_loop``
returns. A wrapper around the step that ``train_loop`` builds
(``trainer.make_train_step``) reads the checked steps' losses, the first
gradient from the optimizer's state after step 1 and the parameters after
the last checked step; it also starts the profiler of a traced run. After
the window the program's state is freed and the plain reference follows
the checked steps from the same weights and batches.

On several cards (one process a card, joined before the run: ``launch``)
every process runs this with the same seed, so each makes the same global
batches and weights; ``train_loop`` runs on the port's process mesh over
them, rank 0 decides where the window ends for all, and rank 0 alone runs
the reference and reports.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from . import program as PG
from . import record as R
from . import traffic as TF


class Ranks:
    """The cell's processes, one a card. One process: no mesh. Several,
    joined by ``torch.distributed`` before the run: the port's process mesh
    over them (every process on data, as ``cli.train`` builds it under
    ``torchrun``) and a gloo group of the harness's own for its host-side
    exchanges, which the prefetch thread uses while the main thread runs
    the program's collectives."""

    def __init__(self, cfg):
        import torch.distributed as dist

        self.mesh, self.host, self.rank, self.n = None, None, 0, 1
        if dist.is_initialized():
            from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
                build_mesh

            self.mesh = build_mesh(cfg.mesh)
            self.host = dist.new_group(backend="gloo")
            self.rank, self.n = dist.get_rank(), dist.get_world_size()

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the processes, in place."""
        if self.mesh is not None:
            torch.distributed.all_reduce(x)
        return x

    def root_says(self, go: bool) -> bool:
        """Rank 0's ``go``, on every process."""
        if self.host is None:
            return go
        t = torch.tensor([int(go)])
        torch.distributed.broadcast(t, 0, group=self.host)
        return bool(t.item())

    def gather(self, obj) -> List:
        """Every process's ``obj``, in rank order."""
        if self.host is None:
            return [obj]
        out = [None] * self.n
        torch.distributed.all_gather_object(out, obj, group=self.host)
        return out

    def close(self) -> None:
        if self.mesh is not None:
            torch.distributed.destroy_process_group()


class WindowLoader:
    """``train_loop``'s loader, as ``cli.train``'s cached loader
    (``data/cached_dataset.py`` ``CachedTrainLoader``) serves it: the
    batches in turn, each given ``train_loop``'s host prep on a pool of
    ``workers`` threads, one batch in flight before the first and at most
    ``workers + 1`` after; for the checked steps and then until
    ``deadline`` (host ``time.time()``, set when the window starts), on
    several processes until rank 0's deadline, so that every process takes
    the same steps. Once the deadline has passed no batch is sent; those in
    flight are trained, inside the window."""

    supports_prep = True

    def __init__(self, batches, ranks: Ranks, workers: int):
        self.batches, self.ranks, self.workers = batches, ranks, workers
        self.deadline: Optional[float] = None

    def __len__(self) -> int:
        return 1 << 20            # train_loop's ETA only; the deadline ends

    def epoch(self, epoch, prep=None):
        def build(i):
            b = self.batches[i % len(self.batches)]
            return prep(b, i) if prep is not None else b

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            inflight: deque = deque()
            sent, going = 0, True

            def send() -> bool:
                nonlocal sent, going
                going = going and self.ranks.root_says(
                    self.deadline is None or time.time() < self.deadline)
                if going:
                    inflight.append(pool.submit(build, sent))
                    sent += 1
                return going

            send()
            while inflight:
                yield inflight.popleft().result()
                while len(inflight) <= self.workers and send():
                    pass


def _touched(batch: Dict) -> np.ndarray:
    """Every item id a step's row-sparse table update touches (0 too)."""
    tt, seq = batch["token_type"], batch["seq"]
    return np.unique(np.concatenate([np.where(tt == 1, seq, 0).ravel(),
                                     batch["pos"].ravel(),
                                     batch["neg"].ravel()]).astype(np.int64))


class Recorder:
    """Wraps the step ``train_loop`` builds: reads the checked steps and
    marks the window; with ``trace`` profiles ``traced_steps`` steps from
    window step ``traced_from`` and times the program's host entries."""

    def __init__(self, run: R.Run, cfg, loader: WindowLoader, seconds: int,
                 checked: int, init: Dict, table: Optional[str],
                 uni: Optional[torch.Tensor], trace: bool, tr: Dict,
                 t0: float):
        from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
            table_index
        from tencent_recommendation_2025_tpu_torch.parallel.\
            sharded_embedding import SHARDED_TABLES

        self.run, self.cfg, self.loader = run, cfg, loader
        # the tables a mesh row-shards, and this process's block of each
        self.ranks, self.sharded = loader.ranks, SHARDED_TABLES
        self.block = table_index(self.ranks.mesh)
        self.seconds, self.checked, self.init = seconds, checked, init
        self.table, self.uni, self.trace, self.tr = table, uni, trace, tr
        self.t0 = t0
        self.calls = 0
        self.losses, self.grad, self.change = [], {}, {}
        self.t_window: Optional[float] = None
        self.step_s = []
        self.starts = []               # the window's step starts
        self.prof = None

    # -- the checked steps ------------------------------------------------
    def _grad(self, state):
        from tencent_recommendation_2025_tpu_torch.train import trainer as TR

        b1 = self.cfg.train.adam_b1
        out = {}
        for path, p in TR.dense_leaves(state.params, self.cfg):
            m = state.opt.state[p]["exp_avg"]
            if path in self.sharded:
                # this process's rows of a row-sharded table; over all
                out[path] = float(self.ranks.sum(
                    m.pow(2).sum(dtype=torch.float64)) ** 0.5)
            else:
                out[path] = float(m.norm())
            out[path] /= 1 - b1
        if self.table:
            # this process's rows of the accumulator; the table's over all
            acc = self.ranks.sum(
                state.tables[self.table]["acc"].double().sum())
            out[self.table] = float(
                (acc * self.cfg.model.hidden_units) ** 0.5)
        return out

    def _change(self, state):
        from tencent_recommendation_2025_tpu_torch.bridge import _flatten

        out = {}
        for path, p in _flatten(state.params).items():
            p = p.detach()
            if path not in self.sharded:
                out[path] = float((p - self.init[path]).norm())
                continue
            # this process's row block [lo, lo + rows) of a row-sharded
            # table (past the table's rows: zero padding); of the row-sparse
            # table the touched rows in it
            lo = self.block * p.shape[0]
            if path == self.table:
                mine = (self.uni >= lo) & (self.uni < lo + p.shape[0])
                d = p[self.uni[mine] - lo].float() - self.init[path][mine]
            else:
                d = p.clone()
                real = self.init[path][lo:lo + p.shape[0]]
                d[:len(real)] -= real
            out[path] = float(self.ranks.sum(
                d.pow(2).sum(dtype=torch.float64)) ** 0.5)
        return out

    # -- the wrapper ------------------------------------------------------
    def wrap(self, make):
        def make_step(model, cfg, mesh=None):
            step = make(model, cfg, mesh)

            def wrapped(state, batch, mm_tables, item_tables):
                self.before(state)
                with torch.profiler.record_function("pb.step"):
                    out = step(state, batch, mm_tables, item_tables)
                self.after(*out)
                return out

            return wrapped

        return make_step

    def before(self, state):
        i = self.calls
        if i == self.checked:
            R.sync()
            R.log(self.t0, f"window starts after {i} checked steps "
                  f"({', '.join(f'{s:.3f}' for s in self.step_s)} s)")
            self.t_window = time.time()
            self.loader.deadline = self.t_window + self.seconds
            if self.trace:
                self._patch_optimizer(state)
        k = i - self.checked
        if self.trace and k == self.tr["traced_from"]:
            self.t_prof = time.time()
            self.prof = R.profile_stretch()
        self.t_step = time.time()
        if k >= 0:
            self.starts.append(self.t_step)

    def after(self, state, metrics):
        self.calls += 1
        i = self.calls
        if i <= self.checked:
            self.losses.append(float(metrics["loss"]))
            self.step_s.append(time.time() - self.t_step)
            if i == 1:
                self.grad = self._grad(state)
            if i == self.checked:
                self.change = self._change(state)
        k = i - self.checked
        if self.prof is not None and k == self.tr["traced_from"] \
                + self.tr["traced_steps"]:
            self.finish_trace()

    def finish_trace(self):
        prof, t0 = self.prof
        n = self.calls - self.checked - self.tr["traced_from"]
        self.run.trace = R.finish_stretch(prof, t0, n)
        self.prof = None
        wall = time.time() - self.t_prof
        self.run.traced_wall_s += wall
        self.run.traced_units += n
        # the window's untraced part keeps its length
        self.loader.deadline += wall

    def _patch_optimizer(self, state):
        inner = state.opt.step

        def step(*a, **k):
            with torch.profiler.record_function("pb.adamw"):
                return inner(*a, **k)

        state.opt.step = step


def _host_timer(run: R.Run, name: str, fn, active, count=None):
    """``fn`` timed on the host into ``run.host_s[name]`` while the window
    runs (``active()``), inside a span of its name; from any thread."""
    lock = threading.Lock()

    def timed(*a, **k):
        t = time.perf_counter()
        with torch.profiler.record_function(f"pb.{name}"):
            out = fn(*a, **k)
        if active():
            with lock:
                run.host_s[name] += time.perf_counter() - t
                run.counts[name] += 1
                if count is not None:
                    count(out)
        return out

    return timed


class Inputs:
    """A training cell's inputs from the seed: the port's configuration and
    model, the batches, the static tables, the weights and an untouched
    copy of them for the reference (of a row-sparse table, the rows the
    checked steps touch, ``uni``)."""

    def __init__(self, cell, seed: int, device, t0: float):
        cj, tr = cell.config, cell.traffic
        self.B = B = tr["rows_per_chip"] * cell.chips
        self.cfg = cfg = PG.port_config(cj, B)
        self.model = PG.port_model(cj, cfg)
        R.log(t0, "port imported")
        self.batches = TF.make_batches(tr, PG.model_info(cj), seed, B)
        R.log(t0, f"{len(self.batches)} batches of {B} rows")
        # the program's tower dedup runs in one process only
        self.dedup = bool(cfg.train.tower_dedup) and cell.chips == 1
        self.tables, self.dev = PG.static_tables(cj, seed, device,
                                                 host_sparse=self.dedup)
        R.log(t0, "static item tables")
        self.rows = PG.item_rows(cfg, cj["data"]["itemnum"])
        self.params = PG.make_params(cj, seed, device, self.rows)
        R.log(t0, "weights")
        self.checked = tr["checked_steps"]
        self.table = table = "item_emb" \
            if "item_emb" in cfg.train.sparse_tables else None
        self.uni = None
        if table:
            self.uni = torch.as_tensor(np.unique(np.concatenate(
                [_touched(b) for b in self.batches[:self.checked]])),
                device=device)
        self.init = {k: (v[self.uni].float() if k == table else v)
                     .detach().clone() for k, v in self.params.items()}


def run_cell(cell, seed: int, seconds: int, trace: bool, t0: float,
             device="cuda"):
    """(Run, the program's readings of the checked steps, the reference's,
    device memory peak over the cards) of one run; None on every process
    but rank 0 of several."""
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        table_index, table_shards
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cj, tr = cell.config, cell.traffic
    x = Inputs(cell, seed, device, t0)
    cfg, model, batches, tables, dev = x.cfg, x.model, x.batches, x.tables, \
        x.dev
    checked, table, uni, init, rows = x.checked, x.table, x.uni, x.init, \
        x.rows
    ranks = Ranks(cfg)
    if ranks.n != cell.chips:
        raise ValueError(f"{cell.name} runs on {cell.chips} processes, not "
                         f"{ranks.n}")
    # this process's row block of the row-sharded table (all of it on one)
    block = -(-rows // table_shards(ranks.mesh))
    lo = table_index(ranks.mesh) * block
    run = R.Run(kind="train", chips=cell.chips, config=cj, traffic=tr,
                rows=x.B, dedup=x.dedup)
    state = PG.train_state(cfg, x.params)
    del x
    R.log(t0, "train state")
    loader = WindowLoader(batches, ranks, tr["prep_workers"])
    rec = Recorder(run, cfg, loader, seconds, checked, init, table, uni,
                   trace, tr, t0)
    patched = {"make_train_step": TR.make_train_step}
    TR.make_train_step = rec.wrap(TR.make_train_step)
    if trace:
        def active():
            return rec.t_window is not None and rec.prof is None

        def touched(out):
            if "touched_uids" in out:
                u = out["touched_uids"]
                run.counts["touched_rows"] += int(
                    ((u >= lo) & (u < min(lo + block, rows))).sum())

        for name, key in (("augment_batch_dedup", "prep.dedup"),
                          ("augment_batch_sparse", "prep.sparse"),
                          ("put_batch", "put")):
            patched[name] = getattr(TR, name)
            setattr(TR, name, _host_timer(
                run, key, patched[name], active,
                touched if name == "augment_batch_sparse" else None))
        for name, key in (("gather_rows_grouped", "table_gather"),
                          ("sharded_gather_rows", "table_gather"),
                          ("apply_row_update", "table_update"),
                          ("sharded_apply_row_update", "table_update")):
            patched["ST." + name] = getattr(ST, name)
            setattr(ST, name, _host_timer(run, key, getattr(ST, name),
                                          active))
    try:
        R.reset_peak()
        TR.train_loop(model, cfg, loader, None, tables, state=state,
                      num_epochs=1, mesh=ranks.mesh, verbose=False,
                      device=device)
        R.sync()
        t_end = time.time()
    finally:
        for name, fn in patched.items():
            if name.startswith("ST."):
                setattr(ST, name[3:], fn)
            else:
                setattr(TR, name, fn)
    if rec.prof is not None:
        rec.finish_trace()
    t = run.trace
    cards = ranks.gather((R.peak_bytes(), t and (t.busy_s, t.collective_s)))
    peak = max(c[0] for c in cards)
    if t is not None:
        # the device's busy and collective seconds: the mean over the cards
        t.busy_s, t.collective_s = (sum(c[1][k] for c in cards) / len(cards)
                                    for k in (0, 1))
    run.setup_s = rec.t_window - t0
    run.window_s = t_end - rec.t_window
    run.units = rec.calls - checked
    prog = {"loss": rec.losses, "grad": rec.grad, "change": rec.change}
    gaps = sorted(np.diff(rec.starts) * 1e3) or [0.0]
    # the program's state goes before the reference runs
    del state, tables, model, loader, rec
    R.log(t0, f"window: {run.units} steps in {run.window_s:.2f} s; step "
          f"intervals ms median {gaps[len(gaps) // 2]:.1f}, p90 "
          f"{gaps[int(len(gaps) * 0.9)]:.1f}, max {gaps[-1]:.1f}")
    ranks.close()
    R.free()
    if ranks.rank != 0:
        return None
    ref = reference_steps(cj, cfg, seed, init, batches[:checked], dev, uni,
                          table, device)
    R.log(t0, "reference")
    return run, prog, ref, peak


def reference_steps(cj, cfg, seed: int, init: Dict, batches, dev, uni,
                    table: Optional[str], device, fp8: bool = False,
                    rows: Optional[int] = None, frozen: bool = False
                    ) -> Dict:
    """The reference's readings of the checked steps (``fp8``: the
    control's; ``rows`` / ``frozen``: a fault planted in it)."""
    from ..reference.model import Numerics, Reference
    from ..reference.train import run_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vocab = PG.feature_vocab(cj)
    mm = dev["mm"][cj["data"]["mm_emb_ids"][0]]
    remap = (lambda ids: torch.searchsorted(uni, ids)) if table else None
    ref = Reference(cj, mm=lambda ids: mm[ids],
                    feats=lambda ids: TF.item_sparse(ids, seed, vocab, torch),
                    nm=Numerics(fp8=fp8), remap=remap)
    bt = [{k: torch.as_tensor(v, device=device) for k, v in b.items()}
          for b in batches]

    def touched(b):
        tt, seq = b["token_type"], b["seq"].long()
        ids = torch.unique(torch.cat([torch.where(tt == 1, seq, 0).ravel(),
                                      b["pos"].long().ravel(),
                                      b["neg"].long().ravel()]))
        return remap(ids)

    t = cfg.train
    hp = {"lr": t.lr, "wd": t.weight_decay, "b1": t.adam_b1,
          "b2": t.adam_b2, "table_lr": t.lr}
    losses, grad, change = run_steps(ref, init, bt, hp, table=table,
                                     touched=touched if table else None,
                                     rows=rows, frozen=frozen)
    return {"loss": losses, "grad": grad, "change": change}
