"""Row-sharded sparse tables across processes (tencent_recommendation_2025_
tpu_torch/parallel/, ops/sparse_table.py, train/) on the CPU: groups of
processes joined by gloo, each the worker of this file run as a script.

- 2 processes (data 2), 4 (data 4) and 4 (data 2 x seq 2): each rank holds
  V / S rows of every learned table and of its optimizer state (a packed
  table, ``TABLE_PACK_MIN_ROWS`` patched to 1, Vp / S rows: no shard
  padding), and two steps of ``sharded_multihost`` cut to D=16, 2 blocks,
  L=32, batch 8 (BCE, dropout off, f32) leave the tables, all-gathered, and
  every other parameter equal to a local mesh's and to one device's, at
  the loss's rtol 1e-5 and the parameters' rtol / atol 1e-5 (Adam's first
  steps divide each gradient by its own magnitude, so a gradient near its
  eps that sums in another order moves by a part of lr); rowwise Adagrad
  on the packed table, lazy Adam on the unpacked item and user tables.
- ``cli.train --preset sharded_multihost --mesh_model 1 --device cpu``
  under 2 processes trains one epoch on the synthetic set and writes a
  per-shard checkpoint (one file per table extent, each written by its
  owner), which the port's ``cli.infer`` serves in one process.

Each group of processes has a time limit of its own; the groups run at
once, started by a module fixture."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = 150
CLI_ARGS = ["--preset", "sharded_multihost", "--mesh_model", "1",
            "--maxlen", "31", "--hidden_units", "16", "--num_blocks", "2",
            "--num_heads", "2", "--dtype", "float32", "--device", "cpu",
            "--num_workers", "1", "--batch_size", "8", "--num_epochs", "1"]
#: name -> (table optimizer, sparse tables, packed)
CASES = {"packed": ("rowwise_adagrad", ("item_emb",), True),
         "lazy": ("lazy_adam", ("item_emb", "user_emb"), False)}
GROUPS = {"two": (2, 1, ("packed", "lazy")), "four": (4, 1, ("packed",)),
          "four_seq": (4, 2, ("lazy",))}
STEPS = 2


# ---------------------------------------------------------------------------
# shared by the workers and the tests
# ---------------------------------------------------------------------------

def _world(data_dir, case):
    import dataclasses

    from tencent_recommendation_2025_tpu_torch.config import PRESETS
    from tencent_recommendation_2025_tpu_torch.data.dataset import \
        TrainSampler
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.pipeline import \
        TrainLoader
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel

    opt, sparse, _ = CASES[case]
    cfg = PRESETS["sharded_multihost"]()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hidden_units=16, num_blocks=2,
                                  num_heads=2, maxlen=31, dtype="float32",
                                  dropout_rate=0.0),
        train=dataclasses.replace(cfg.train, batch_size=8, tower_dedup=False,
                                  loss_type="bce", table_optimizer=opt,
                                  sparse_tables=sparse))
    data = TencentGRData(data_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    loader = TrainLoader(sampler, np.arange(len(sampler)), 8, seed=3,
                         num_workers=1)
    batch = next(iter(loader.epoch(1)))
    return cfg, model, tables, batch


def _steps(data_dir, case, mesh):
    """(the tables' and optimizer states' rows this process holds, the
    parameters after STEPS steps whole at their rows, the losses)."""
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        table_shards
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    saved = ST.TABLE_PACK_MIN_ROWS
    if CASES[case][2]:
        ST.TABLE_PACK_MIN_ROWS = 1
    try:
        cfg, model, tables, batch = _world(data_dir, case)
        state = PT.init_sharded_state(model, cfg, mesh, seed=5,
                                      device="cpu") if mesh is not None \
            else TR.init_state(model, cfg, seed=5)
        b = TR.augment_batch_sparse(batch, cfg, model.itemnum, (0, 1),
                                    n_table_shards=table_shards(mesh),
                                    usernum=model.usernum)
        tabs = TR.device_tables(tables, "cpu")
        step = TR.make_train_step(model, cfg, mesh)
        losses = []
        for _ in range(STEPS):
            state, m = step(state, TR.put_batch(b, "cpu"), tabs["mm"], tabs)
            losses.append(float(m["loss"]))
        tensors = {p: t for p, t in state.params.items()
                   if isinstance(t, torch.Tensor)}
        held = {p: list(t.shape) for p, t in tensors.items()}
        held.update({f"{n}/{k}": list(t.shape)
                     for n, o in state.tables.items() for k, t in o.items()})
        for p, t in tensors.items():
            st = state.opt.state.get(t, {})
            if "exp_avg" in st:
                held[f"{p}/exp_avg"] = list(st["exp_avg"].shape)
        if mesh is not None:
            state = PT.unpad_state(state, model, mesh,
                                   packed=CASES[case][2])
        params = {p: t.detach().float() for p, t in
                  TR.param_leaves(state.params)}
        params.update({f"{n}/{k}": t.float() for n, o in
                       state.tables.items() for k, t in o.items()})
    finally:
        ST.TABLE_PACK_MIN_ROWS = saved
    return held, params, losses


# ---------------------------------------------------------------------------
# the worker: one process of a group, run as a script
# ---------------------------------------------------------------------------

def _worker(kind, out_dir, data_dir, seq, cases):
    import torch.distributed as dist

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        build_mesh, initialize_distributed)

    torch.set_num_threads(1)
    if kind == "cli":
        from tencent_recommendation_2025_tpu_torch.cli import train as TRN

        TRN.main(CLI_ARGS)
        return
    initialize_distributed("cpu")
    mesh = build_mesh(MeshConfig(seq=seq))
    res = {}
    for case in cases.split(","):
        held, params, losses = _steps(data_dir, case, mesh)
        res[f"{case}:held"] = json.dumps(held)
        res.update({f"{case}:param:{p}": t.numpy()
                    for p, t in params.items()})
        res[f"{case}:losses"] = np.asarray(losses)
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(n, kind, out_dir, data_dir, seq=1, cases="", env_extra=None):
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT), **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), kind,
             str(out_dir), str(data_dir), str(seq), cases],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs, time.monotonic()


def _wait(group):
    procs, t0 = group
    outs = []
    for p in procs:
        left = max(1.0, GROUP_TIMEOUT - (time.monotonic() - t0))
        try:
            out, _ = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"process group exceeded {GROUP_TIMEOUT} s")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope="module")
def groups(synth_dir, tmp_path_factory):
    """Every process group, started at once."""
    root = tmp_path_factory.mktemp("sharded_dist")
    dirs = {k: root / k for k in list(GROUPS) + ["cli"]}
    for d in dirs.values():
        d.mkdir()
    started = {name: _start(n, "step", dirs[name], synth_dir, seq,
                            ",".join(cases))
               for name, (n, seq, cases) in GROUPS.items()}
    started["cli"] = _start(2, "cli", dirs["cli"], synth_dir, env_extra={
        "TRAIN_DATA_PATH": str(synth_dir),
        "TRAIN_LOG_PATH": str(dirs["cli"] / "logs"),
        "TRAIN_CKPT_PATH": str(dirs["cli"] / "ckpt")})
    return started, dirs, {}


def _results(groups, name):
    started, dirs, outs = groups
    if name not in outs:
        outs[name] = _wait(started[name])
    return dirs[name], outs[name]


_REF = {}


def _reference(synth_dir, case, shards):
    """One device's run and a local mesh's of ``shards`` data shards."""
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh

    key = (case, shards)
    if key not in _REF:
        mesh = None if shards == 1 else local_mesh(MeshConfig(data=shards))
        _REF[key] = _steps(synth_dir, case, mesh)
    return _REF[key]


_CASES = [(g, c) for g, (_, _, cases) in GROUPS.items() for c in cases]


@pytest.mark.parametrize("group,case", _CASES)
def test_each_rank_holds_its_rows(groups, synth_dir, group, case):
    """V / S rows a rank of every learned table and of its optimizer state
    (V padded to a multiple of S; a packed table's Vp split as it is)."""
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST

    n, seq, _ = GROUPS[group]
    S = n // seq
    out_dir, _ = _results(groups, group)
    _, model, _, _ = _world(synth_dir, case)
    packed = CASES[case][2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ST, "TABLE_PACK_MIN_ROWS", 1)
        Vp = ST.padded_table_rows(model.itemnum + 1)
    V = {"item_emb": Vp if packed else model.itemnum + 1,
         "user_emb": model.usernum + 1, "fused_feat": model.fused.total_rows}
    for rank in range(n):
        held = json.loads(str(np.load(out_dir / f"rank{rank}.npz")[
            f"{case}:held"]))
        for key, shape in held.items():
            table = key.split("/")[0]
            if table in V:
                assert shape[0] == -(-V[table] // S), (key, shape)
        if packed:
            assert held["item_emb"][0] * S == V["item_emb"]
            assert held["item_emb/acc"] == [V["item_emb"] // S]
        else:
            assert held["item_emb/mu"][0] == -(-V["item_emb"] // S)
            assert "user_emb/nu" in held and "fused_feat/exp_avg" in held


@pytest.mark.parametrize("group,case", _CASES)
def test_process_mesh_steps_match_local_mesh_and_one_device(
        groups, synth_dir, group, case):
    n, seq, _ = GROUPS[group]
    out_dir, _ = _results(groups, group)
    _, one, one_losses = _reference(synth_dir, case, 1)
    _, local, local_losses = _reference(synth_dir, case, n // seq)
    np.testing.assert_allclose(local_losses, one_losses, rtol=1e-5)
    for p, t in one.items():
        np.testing.assert_allclose(local[p].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=p)
    for rank in range(n):
        r = np.load(out_dir / f"rank{rank}.npz")
        np.testing.assert_allclose(r[f"{case}:losses"], one_losses,
                                   rtol=1e-5)
        for p, t in local.items():
            np.testing.assert_allclose(r[f"{case}:param:{p}"], t.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=p)


def test_cli_sharded_multihost_trains_and_serves(groups, synth_dir,
                                                 tmp_path, monkeypatch):
    from tencent_recommendation_2025_tpu_torch.cli import infer as TINF
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    out_dir, outs = _results(groups, "cli")
    assert "mesh: {'pipe': 1, 'data': 2, 'model': 1, 'seq': 1} over 2 " \
        "processes (rank 0)" in outs[0]
    lines = [json.loads(ln) for ln in open(out_dir / "logs" / "train.log")]
    assert lines and all(np.isfinite(ln["loss"]) for ln in lines
                         if "loss" in ln)
    ck = CK.latest_checkpoint(out_dir / "ckpt")
    entries = {e["path"]: e for e in json.loads(
        (ck / "manifest.json").read_text())["leaves"]}
    for path in ("0/item_emb", "1/tables/item_emb/acc", "0/fused_feat",
                 "1/user_emb/exp_avg"):
        shards = entries[path]["shards"]
        assert len(shards) == 2
        assert all((ck / s["file"]).exists() for s in shards)
    assert "file" in entries["0/pos_emb"]
    monkeypatch.setenv("EVAL_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("MODEL_OUTPUT_PATH", str(out_dir / "ckpt"))
    monkeypatch.setenv("EVAL_RESULT_PATH", str(tmp_path / "res"))
    m = TINF.main(["--preset", "sharded_multihost", "--maxlen", "31",
                   "--hidden_units", "16", "--num_blocks", "2",
                   "--num_heads", "2", "--dtype", "float32", "--device",
                   "cpu"])
    gt = json.loads((synth_dir / "ground_truth.json").read_text())
    assert m["n"] == len(gt) and 0.0 <= m["hr"] <= 1.0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]),
            sys.argv[5] if len(sys.argv) > 5 else "")
