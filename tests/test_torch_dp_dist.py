"""Data parallelism across processes (tencent_recommendation_2025_tpu_torch/
parallel/, train/trainer.py) on the CPU: groups of processes joined by
gloo, each process the worker of this file run as a script, against one
process.

- 2 processes (data 2), 4 (data 4) and 4 (data 2 x seq 2): one
  ``make_train_step`` step on a global batch of the synthetic fixture, BCE
  and the sampled softmax with 16 in-batch negatives, leaves the parameters
  equal to the single-process step's, at the same loss; on 2 processes G=2
  too. Every rank's softmax saw the same candidates: the shared negatives
  and the in-batch ones, drawn over the global batch.
- ``cli.train --device cpu --preset sampled_softmax_dp`` under 2 processes
  writes a checkpoint equal to the single-process run's (which trains
  single-device, with tower dedup; the processes without it, with the JAX
  loop's warning): rank 0 its replicated leaves, each process its rows of
  the row-sharded tables, whose pad rows stay zero.

The processes' tables are row-sharded (each process holds its data index's
rows; tests/test_torch_sharded_dist.py checks the layout); they are
compared here whole, all-gathered (``parallel.train.unpad_state``).

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
CLI_ARGS = ["--preset", "sampled_softmax_dp", "--maxlen", "31",
            "--hidden_units", "16", "--num_blocks", "2", "--num_heads", "2",
            "--dtype", "float32", "--device", "cpu", "--num_workers", "1",
            "--batch_size", "8", "--num_epochs", "1", "--dropout_rate", "0"]
#: (name, loss, grad_accum_steps) of the steps each group runs
STEPS = {"bce": ("bce", 1), "softmax": ("sampled_softmax", 1),
         "bce_g2": ("bce", 2)}
GROUPS = {"two": (2, 1, ("bce", "softmax", "bce_g2")),
          "four": (4, 1, ("bce", "softmax")),
          "four_seq": (4, 2, ("bce", "softmax"))}


# ---------------------------------------------------------------------------
# shared by the workers and the tests
# ---------------------------------------------------------------------------

def _train_world(data_dir, step_name):
    """Model, config (hstu_flagship cut to D=16, 2 blocks, L=32, batch 8,
    f32, dropout 0, dense tables, no tower dedup) and the first global batch
    of the fixture, with the shared negatives the host prep samples."""
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
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    loss, G = STEPS[step_name]
    cfg = PRESETS["hstu_flagship"]()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hidden_units=16, num_blocks=2,
                                  num_heads=2, maxlen=31, dtype="float32",
                                  dropout_rate=0.0),
        train=dataclasses.replace(cfg.train, batch_size=8, tower_dedup=False,
                                  loss_type=loss, grad_accum_steps=G,
                                  num_sampled_negatives=16,
                                  num_inbatch_negatives=16))
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
    if loss == "sampled_softmax":
        batch["sampled_neg_ids"] = TR._sample_negatives(
            cfg, data.itemnum, (cfg.train.seed, 97, 1, 0))
    return cfg, model, tables, batch


def _train_step(data_dir, step_name, mesh):
    """Parameters after one step (from the seeded initial state), the step's
    loss and the candidate ids every sampled-softmax loss of it took."""
    from tencent_recommendation_2025_tpu_torch.ops import losses as LS
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg, model, tables, batch = _train_world(data_dir, step_name)
    state = PT.init_sharded_state(model, cfg, mesh, seed=5, device="cpu")
    tabs = TR.device_tables(tables, "cpu")
    step = PT.make_sharded_train_step(model, cfg, mesh)
    seen, loss_fn = [], LS.sampled_softmax_loss

    def spy(query, pos, negs, neg_ids, *a, **kw):
        seen.append(neg_ids.detach().clone())
        return loss_fn(query, pos, negs, neg_ids, *a, **kw)

    LS.sampled_softmax_loss = spy
    try:
        state, m = step(state, TR.put_batch(batch, "cpu"), tabs["mm"], tabs)
    finally:
        LS.sampled_softmax_loss = loss_fn
    if mesh is not None:
        # the row-sharded tables whole, at their rows (all-gathered)
        state = PT.unpad_state(state, model, mesh)
    params = {p: t.detach() for p, t in TR.param_leaves(state.params)}
    cands = torch.cat(seen).numpy() if seen else np.zeros(0)
    return params, float(m["loss"]), cands


# ---------------------------------------------------------------------------
# the worker: one process of a group, run as a script
# ---------------------------------------------------------------------------

def _worker(case, out_dir, data_dir, seq, steps):
    import torch.distributed as dist

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        build_mesh, initialize_distributed)

    torch.set_num_threads(1)
    if case == "cli":
        from tencent_recommendation_2025_tpu_torch.cli import train as TRN

        TRN.main(CLI_ARGS)
        return
    initialize_distributed("cpu")
    mesh = build_mesh(MeshConfig(seq=seq))
    res = {"shape": np.array([mesh.shape["data"], mesh.shape["seq"]])}
    for name in steps.split(","):
        params, loss, cands = _train_step(data_dir, name, mesh)
        res.update({f"{name}:param:{p}": t.numpy()
                    for p, t in params.items()})
        res[f"{name}:loss"] = np.float64(loss)
        res[f"{name}:cands"] = cands
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(n, case, out_dir, data_dir, seq=1, steps="", env_extra=None):
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT), **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), case,
             str(out_dir), str(data_dir), str(seq), steps],
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


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def groups(synth_dir, tmp_path_factory):
    """Every process group, started at once."""
    root = tmp_path_factory.mktemp("dp_dist")
    dirs = {k: root / k for k in list(GROUPS) + ["cli"]}
    for d in dirs.values():
        d.mkdir()
    started = {name: _start(n, "step", dirs[name], synth_dir, seq,
                            ",".join(steps))
               for name, (n, seq, steps) in GROUPS.items()}
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


_ONE = {}


def _one_process(synth_dir, step_name):
    if step_name not in _ONE:
        _ONE[step_name] = _train_step(synth_dir, step_name, None)
    return _ONE[step_name]


_CASES = [(g, s) for g, (_, _, steps) in GROUPS.items() for s in steps]


@pytest.mark.parametrize("group,step_name", _CASES)
def test_process_mesh_step_matches_one_process(groups, synth_dir, group,
                                               step_name):
    """atol 1e-5 is a thousandth of the learning rate: Adam's first step
    divides each gradient by its own magnitude, so a gradient near its eps
    (1e-8) that sums in another order moves by a part of lr."""
    n, seq, _ = GROUPS[group]
    out_dir, _ = _results(groups, group)
    params, loss, cands = _one_process(synth_dir, step_name)
    for rank in range(n):
        r = np.load(out_dir / f"rank{rank}.npz")
        assert tuple(r["shape"]) == (n // seq, seq)
        assert abs(float(r[f"{step_name}:loss"]) - loss) <= 1e-5 * abs(loss)
        for p, t in params.items():
            np.testing.assert_allclose(r[f"{step_name}:param:{p}"],
                                       t.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=p)
        # the shared negatives and the in-batch candidates, drawn over the
        # global batch: the same ids on every rank as in one process
        np.testing.assert_array_equal(r[f"{step_name}:cands"], cands)
    if STEPS[step_name][0] == "sampled_softmax":
        assert len(cands) == 16 + 16


def test_cli_train_two_processes_checkpoint_matches_one(groups, synth_dir,
                                                        tmp_path, capsys,
                                                        monkeypatch):
    from tencent_recommendation_2025_tpu_torch.bridge import _flatten
    from tencent_recommendation_2025_tpu_torch.cli import train as TRN
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    out_dir, outs = _results(groups, "cli")
    assert "mesh: {'pipe': 1, 'data': 2, 'model': 1, 'seq': 1} over 2 " \
        "processes (rank 0)" in outs[0]
    assert "WARNING: train.tower_dedup needs a single-process mesh" \
        in outs[0]
    monkeypatch.setenv("TRAIN_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("TRAIN_LOG_PATH", str(tmp_path / "logs"))
    monkeypatch.setenv("TRAIN_CKPT_PATH", str(tmp_path / "ckpt"))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    TRN.main(CLI_ARGS)
    assert "WARNING: preset wants 8 devices but only 1 present — training " \
        "single-device" in capsys.readouterr().out
    one_ck = CK.latest_checkpoint(tmp_path / "ckpt")
    two_ck = CK.latest_checkpoint(out_dir / "ckpt")
    assert two_ck.name.split(".")[0] == one_ck.name.split(".")[0]

    def losses(path):
        return [json.loads(ln)["loss"] for ln in open(path / "train.log")
                if "loss" in json.loads(ln)]

    l1, l2 = losses(tmp_path / "logs"), losses(out_dir / "logs")
    assert len(l1) == len(l2) > 1
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    # the parameters to a tenth of the learning rate: Adam divides each
    # gradient by its own magnitude, so an element whose gradient is near 0
    # (and sums in another order: the shards, and tower dedup in the single
    # process only) moves by a part of lr per step
    f1, f2 = (_flatten(CK.load_params(c)[0]) for c in (one_ck, two_ck))
    assert f1.keys() == f2.keys()
    for k in f1:
        a, b = np.asarray(f2[k], np.float32), np.asarray(f1[k], np.float32)
        # the two processes' tables are saved per shard with their pad rows
        assert not a[b.shape[0]:].any()
        np.testing.assert_allclose(a[:b.shape[0]], b, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]),
            sys.argv[5] if len(sys.argv) > 5 else "")
