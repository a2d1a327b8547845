#!/usr/bin/env python3
"""Data parallelism across cards: N processes, one card each, joined by
NCCL, against one process on one card.

    python3 scripts/nccl_dp_check.py                  # 4 cards
    python3 scripts/nccl_dp_check.py --device cpu --nproc 2 --small

The second form rehearses the same path on the CPU in gloo processes at
small widths. The script makes a seeded fixture under build/nccl_dp/ (1024
users, 5000 items, 256..1000 events, as ``chip_smoke.py``'s flagship
fixture), then for each case below takes one ``make_train_step`` step from
the same seeded state on the first global batch: in this process on one
device (no mesh), and in N worker processes on a process mesh
(``parallel.mesh.build_mesh``; each worker this file run again with the
torchrun variables set). Per case it holds the process mesh's loss and
gradient (rank 0's, all-reduced) to the single device's, every rank's
parameters after the step bitwise equal to rank 0's, and (sampled softmax)
every rank's candidates equal to the single device's; then it times 6
synchronised steps after 2 on both sides (host clock; per card on the
mesh).

- ``bce_dp``: hstu_flagship ``--maxlen 1023`` (L=1024, B=128, BCE), data N;
  bf16: loss within 1e-4 relative, every gradient at cosine >= 0.999.
- ``softmax_dp``: sampled_softmax_dp ``--maxlen 255`` (L=256, B=64, 64
  in-batch negatives), data N; bf16, the same limits.
- ``bce_dp_seq2``: the flagship on data N/2 x seq 2 (the fused ring across
  cards); f32 (the ring rounds elsewhere than the single device in bf16):
  loss within 1e-5 relative, cosine >= 0.999.

Dropout 0, tower dedup off (several processes gate it off). Prints the
card line, one line per check ending in ``ok`` or ``FAIL`` (also on
stderr), and a last line ``NCCL_DP {json}``; exits non-zero if a check
failed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "nccl_dp"
FIXTURE = dict(num_users=1024, num_items=5000, min_seq=256, max_seq=1000,
               seed=21)
#: (preset, maxlen, batch, loss, seq, dtype) of each case
CASES = {"bce_dp": ("hstu_flagship", 1023, 128, "bce", 1, "bfloat16"),
         "softmax_dp": ("sampled_softmax_dp", 255, 64, "sampled_softmax", 1,
                        "bfloat16"),
         "bce_dp_seq2": ("hstu_flagship", 1023, 128, "bce", 2, "float32")}
SMALL = dict(maxlen=63, batch=8, hidden_units=16, num_blocks=2)
STEPS = 6
TIMEOUT = 600


def log(*a):
    print(*a, flush=True)
    text = " ".join(map(str, a))
    if "FAIL" in text:
        print(text, file=sys.stderr, flush=True)


def _world(case, small):
    """(model, config, item tables, first global batch) of ``case``."""
    sys.path.insert(0, str(ROOT))
    from tencent_recommendation_2025_tpu_torch.cli import train as TRN
    from tencent_recommendation_2025_tpu_torch.data.dataset import \
        TrainSampler
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.pipeline import (
        TrainLoader, train_val_split)
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    preset, maxlen, batch, loss, _, dtype = CASES[case]
    args = ["--preset", preset, "--maxlen", str(maxlen), "--batch_size",
            str(batch), "--dropout_rate", "0", "--dtype", dtype,
            "--loss_type", loss]
    if small:
        args += ["--maxlen", str(SMALL["maxlen"]), "--batch_size",
                 str(SMALL["batch"]), "--hidden_units",
                 str(SMALL["hidden_units"]), "--num_blocks",
                 str(SMALL["num_blocks"])]
    cfg = TRN.build_config(TRN.get_args(args))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, tower_dedup=False))
    data = TencentGRData(WORK / "data", mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    tr, _ = train_val_split(len(sampler), cfg.train.valid_fraction,
                            cfg.train.seed)
    b = next(iter(TrainLoader(sampler, tr, cfg.train.batch_size,
                              seed=cfg.train.seed).epoch(1)))
    if loss == "sampled_softmax":
        b["sampled_neg_ids"] = TR._sample_negatives(
            cfg, data.itemnum, (cfg.train.seed, 97, 1, 0))
    return model, cfg, tables, b


def _run(case, small, device, mesh):
    """One step from the seeded state, then STEPS timed after 2: (loss,
    gradients by leaf, parameters after the first step, candidates the
    sampled softmax took, ms a step)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import losses as LS
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    model, cfg, tables, batch = _world(case, small)
    state = PT.init_sharded_state(model, cfg, mesh, seed=5, device=device)
    tabs = TR.device_tables(tables, device)
    b = TR.put_batch(batch, device)
    step = PT.make_sharded_train_step(model, cfg, mesh)
    seen, loss_fn = [], LS.sampled_softmax_loss

    def spy(query, pos, negs, neg_ids, *a, **kw):
        seen.append(neg_ids.detach().cpu().clone())
        return loss_fn(query, pos, negs, neg_ids, *a, **kw)

    LS.sampled_softmax_loss = spy
    try:
        state, m = step(state, b, tabs["mm"], tabs)
    finally:
        LS.sampled_softmax_loss = loss_fn
    loss = float(m["loss"])
    grads = {p: t.grad.float().cpu().numpy()
             for p, t in TR.param_leaves(state.params)}
    params = {p: t.detach().float().cpu().numpy()
              for p, t in TR.param_leaves(state.params)}
    cands = torch.cat(seen).numpy() if seen else np.zeros(0)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    for _ in range(2):
        state, m = step(state, b, tabs["mm"], tabs)
    sync()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, m = step(state, b, tabs["mm"], tabs)
    sync()
    ms = (time.perf_counter() - t0) / STEPS * 1e3
    return loss, grads, params, cands, ms


def _worker(out_dir, device, small):
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        build_mesh, initialize_distributed)

    initialize_distributed(device)
    res = {}
    for case, (*_, seq, _) in CASES.items():
        mesh = build_mesh(MeshConfig(seq=seq))
        loss, grads, params, cands, ms = _run(case, small, device, mesh)
        res[f"{case}:shape"] = np.array([mesh.shape["data"],
                                         mesh.shape["seq"]])
        res[f"{case}:loss"] = np.float64(loss)
        res[f"{case}:cands"] = cands
        res[f"{case}:ms"] = np.float64(ms)
        res.update({f"{case}:param:{p}": v for p, v in params.items()})
        if mesh.rank == 0:
            res.update({f"{case}:grad:{p}": v for p, v in grads.items()})
        dist.barrier()
    np.savez(Path(out_dir) / f"rank{dist.get_rank()}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def _cos(a, b):
    a, b = a.reshape(-1).astype(np.float64), b.reshape(-1).astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return 1.0 if na == 0.0 and nb == 0.0 else float(a @ b / (na * nb))


def main() -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--nproc", default=4, type=int)
    p.add_argument("--small", action="store_true",
                   help="CPU rehearsal widths (L=64, D=16, 2 blocks, B=8)")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from tencent_recommendation_2025_tpu_torch.data import synthetic

    card = "cpu"
    if args.device == "cuda":
        if torch.cuda.device_count() < args.nproc:
            log(f"nccl_dp_check: {args.nproc} cards wanted, "
                f"{torch.cuda.device_count()} present FAIL")
            return 2
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        card = "; ".join(out.stdout.strip().splitlines())
        from tencent_recommendation_2025_tpu_torch.ops import kernels

        kernels.build_all()       # once, before the workers load it
    log(card)
    out_dir = WORK / "out"
    out_dir.mkdir(parents=True, exist_ok=True)
    if not (WORK / "data").exists():
        fixture = dict(FIXTURE, num_users=64) if args.small else FIXTURE
        synthetic.generate(WORK / "data", mm_emb_ids=("81",), **fixture)
    # the single device first, alone on its card (its steps are timed)
    dev = "cuda:0" if args.device == "cuda" else "cpu"
    one = {case: _run(case, args.small, dev, None) for case in CASES}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(args.nproc):
        env = dict(os.environ, WORLD_SIZE=str(args.nproc), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(out_dir), args.device, "1" if args.small else "0"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    ok = True
    for rank, pr in enumerate(procs):
        try:
            text, _ = pr.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log(f"nccl_dp_check: workers exceeded {TIMEOUT} s FAIL")
            return 1
        if pr.returncode != 0:
            log(f"rank {rank} exited {pr.returncode} FAIL:\n{text[-4000:]}")
            ok = False
    if not ok:
        return 1
    ranks = [np.load(out_dir / f"rank{r}.npz") for r in range(args.nproc)]
    summary = {}
    for case, (*_, dtype) in CASES.items():
        loss, grads, _, cands, ms = one[case]
        r0 = ranks[0]
        rel_lim = 1e-5 if dtype == "float32" else 1e-4
        rel = abs(float(r0[f"{case}:loss"]) - loss) / abs(loss)
        worst = min((_cos(r0[f"{case}:grad:{p}"], g), p)
                    for p, g in grads.items())
        equal = all(np.array_equal(r[k], r0[k]) for r in ranks[1:]
                    for k in r0.files if k.startswith(f"{case}:param:"))
        same_cands = all(np.array_equal(r[f"{case}:cands"], cands)
                         for r in ranks)
        ok_c = rel <= rel_lim and worst[0] >= 0.999 and equal and same_cands
        ok &= ok_c
        shape = tuple(int(x) for x in r0[f"{case}:shape"])
        mesh_ms = max(float(r[f"{case}:ms"]) for r in ranks)
        summary[case] = dict(mesh=shape, dtype=dtype, loss_rel=rel,
                             lowest_cos=worst[0], replicas_equal=equal,
                             candidates_equal=same_cands,
                             mesh_ms=mesh_ms, single_ms=ms)
        log(f"{case}: {args.nproc} processes, mesh (data, seq) {shape}, "
            f"{dtype}: loss {float(r0[f'{case}:loss']):.6f} against one "
            f"process's {loss:.6f} (relative {rel:.2e}, limit {rel_lim:g});"
            f" lowest gradient cosine {worst[0]:.6f} ({worst[1]}, limit "
            f"0.999); parameters after the step bitwise equal on every rank "
            f"{equal}; candidates ({len(cands)}) equal on every rank and to "
            f"one process's {same_cands}; step {mesh_ms:.3f} ms on the mesh "
            f"(slowest rank) against {ms:.3f} ms in one process (host clock, "
            f"synchronised, {STEPS} after 2) {'ok' if ok_c else 'FAIL'}")
    print("NCCL_DP " + json.dumps({"device": card, "nproc": args.nproc,
                                   "cases": summary}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[2], sys.argv[3], sys.argv[4] == "1")
    else:
        sys.exit(main())
