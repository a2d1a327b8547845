"""The port's process mesh (tencent_recommendation_2025_tpu_torch/parallel/
mesh.py) on the CPU: 2 processes (data 1, seq 2) and 4 (data 2, seq 2)
joined by gloo, each the worker of this file run as a script, against one
process holding the same shards (a local mesh, or no mesh).

- ``encode`` on both ring routes (the per-shard fused units through their
  plain versions, and the unfused ring): every process's output rows and,
  after one all-reduce, the gradients of every leaf equal the local mesh's
  in f32;
- one ``make_train_step`` step on a global batch of the synthetic fixture
  leaves the parameters equal to the single-process step's;
- ``cli.train --device cpu --mesh_seq 2`` under 2 processes writes, from
  rank 0, a checkpoint equal to the single-process run of the same command
  (which trains single-device, with the warning).

Each group of processes has a time limit of its own; the three groups run at
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
GROUP_TIMEOUT = 120
CLI_ARGS = ["--preset", "hstu_flagship", "--mesh_seq", "2", "--maxlen", "31",
            "--hidden_units", "16", "--num_blocks", "2", "--num_heads", "2",
            "--dtype", "float32", "--device", "cpu", "--num_workers", "1",
            "--batch_size", "8", "--num_epochs", "1", "--dropout_rate", "0"]
ENC = dict(B=4, L=64, D=16, H=2)


# ---------------------------------------------------------------------------
# shared by the workers and the tests
# ---------------------------------------------------------------------------

def _model_cfg():
    from tencent_recommendation_2025_tpu_torch.config import ModelConfig

    return ModelConfig(hidden_units=ENC["D"], num_blocks=2,
                       num_heads=ENC["H"], maxlen=ENC["L"] - 1,
                       block_type="hstu", ffn_type="swiglu",
                       dtype="float32", reference_init=False,
                       dropout_rate=0.0)


def _enc_inputs(cfg):
    """Seeded parameters and inputs of the encoder case: left padding of a
    different width per row."""
    from tencent_recommendation_2025_tpu_torch.models import encoder as ENCM

    B, L, D = ENC["B"], ENC["L"], ENC["D"]
    params = ENCM.init_encoder_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(
        (rng.standard_normal((2 * L + 1, D)) * 0.02).astype(np.float32))
    emb = torch.from_numpy(
        (rng.standard_normal((B, L, D)) * 0.1).astype(np.float32))
    tt = np.ones((B, L), np.int64)
    for i in range(B):
        tt[i, :(i * 7) % (L // 2)] = 0
    seq = torch.from_numpy(rng.integers(1, 50, (B, L)) * tt)
    return params, emb, seq, torch.from_numpy(tt), pos


def _leafify(tree, out):
    if isinstance(tree, dict):
        return {k: _leafify(v, out) for k, v in tree.items()}
    t = tree.clone().requires_grad_(True)
    out.append(t)
    return t


def _encode_grads(mesh, rows, route, S):
    """Output rows and leaf gradients (pos table, embeddings, every block
    leaf) of a weighted sum of the encoder output: each process of a seq
    group back-propagates 1/S of its rows' loss, so the sum over every
    process is the global loss's gradient."""
    from tencent_recommendation_2025_tpu_torch.models import encoder as ENCM
    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    cfg = _model_cfg()
    params, emb, seq, tt, pos = _enc_inputs(cfg)
    leaves = []
    p = _leafify(params, leaves)
    pos = pos.clone().requires_grad_(True)
    e = emb[rows].clone().requires_grad_(True)
    saved = FB.ring_fused_supported
    FB.ring_fused_supported = lambda *a: route == "ring_fused"
    try:
        out = ENCM.encode(p, e, seq[rows], tt[rows], pos, cfg, mesh=mesh)
    finally:
        FB.ring_fused_supported = saved
    w = torch.arange(out.numel(), dtype=out.dtype).reshape(out.shape)
    w = w + rows.start * out[0].numel()
    ((out * w).sum() * 1e-4 / S).backward()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in leaves + [pos]]
    return out.detach(), grads, e.grad


def _train_world(data_dir):
    """Model, config (hstu_flagship cut to the CLI case's widths, BCE, dense
    tables) and the first global batch of the fixture."""
    from tencent_recommendation_2025_tpu_torch.cli import train as TRN
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

    cfg = TRN.build_config(TRN.get_args(CLI_ARGS))
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


def _train_step(data_dir, mesh):
    """Parameters after one train step (from the seeded initial state) and
    the step's loss."""
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    from tencent_recommendation_2025_tpu_torch.parallel import train as PT

    cfg, model, tables, batch = _train_world(data_dir)
    state = TR.init_state(model, cfg, seed=5)
    if mesh is not None:
        # the tables row-sharded over the data shards (2 on four processes)
        state = PT.shard_existing_state(mesh, state)
    tabs = TR.device_tables(tables, "cpu")
    step = TR.make_train_step(model, cfg, mesh)
    state, m = step(state, TR.put_batch(batch, "cpu"), tabs["mm"], tabs)
    if mesh is not None:
        state = PT.unpad_state(state, model, mesh)
    return {p: t.detach() for p, t in TR.param_leaves(state.params)}, \
        float(m["loss"])


# ---------------------------------------------------------------------------
# the worker: one process of a group, run as a script
# ---------------------------------------------------------------------------

def _worker(case, out_dir, data_dir, seq):
    import torch.distributed as dist

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        build_mesh, host_batch_slice, initialize_distributed)

    torch.set_num_threads(1)
    if case == "cli":
        from tencent_recommendation_2025_tpu_torch.cli import train as TRN

        TRN.main(CLI_ARGS)
        return
    initialize_distributed("cpu")
    mesh = build_mesh(MeshConfig(seq=seq))
    rank = mesh.rank
    res = {}
    rows = host_batch_slice(ENC["B"], mesh)
    for route in ("ring_fused", "ring"):
        out, grads, demb = _encode_grads(mesh, rows, route, seq)
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        res[f"{route}_out"] = out.numpy()
        res[f"{route}_grads"] = flat.numpy()
        # the embedding rows' gradient: summed over the seq group
        res[f"{route}_demb"] = mesh.all_reduce(demb, "seq").numpy()
    params, loss = _train_step(data_dir, mesh)
    res.update({f"param:{p}": t.numpy() for p, t in params.items()})
    res["loss"] = np.float64(loss)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(n, case, out_dir, data_dir, seq=2, env_extra=None, cwd=None):
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT), **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), case,
             str(out_dir), str(data_dir), str(seq)],
            env=env, cwd=cwd or ROOT, stdout=subprocess.PIPE,
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
    """All three process groups, started at once."""
    root = tmp_path_factory.mktemp("ring_dist")
    dirs = {k: root / k for k in ("two", "four", "cli")}
    for d in dirs.values():
        d.mkdir()
    cli_env = {"TRAIN_DATA_PATH": str(synth_dir),
               "TRAIN_LOG_PATH": str(dirs["cli"] / "logs"),
               "TRAIN_CKPT_PATH": str(dirs["cli"] / "ckpt")}
    started = {"two": _start(2, "step", dirs["two"], synth_dir),
               "four": _start(4, "step", dirs["four"], synth_dir),
               "cli": _start(2, "cli", dirs["cli"], synth_dir,
                             env_extra=cli_env)}
    return started, dirs


def _results(groups, name):
    started, dirs = groups
    _wait(started[name])
    return dirs[name]


def _flat(grads):
    return np.concatenate([g.reshape(-1).numpy() for g in grads])


@pytest.mark.parametrize("name,n,seq", [("two", 2, 2), ("four", 4, 2)])
@pytest.mark.parametrize("route", ["ring_fused", "ring"])
def test_process_mesh_encode_matches_local_mesh(groups, name, n, seq,
                                                route):
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh

    out_dir = _results(groups, name)
    rows = slice(0, ENC["B"])
    ref_out, ref_grads, ref_demb = _encode_grads(
        local_mesh(MeshConfig(seq=seq)), rows, route, 1)
    dp = n // seq
    per = ENC["B"] // dp
    for rank in range(n):
        r = np.load(out_dir / f"rank{rank}.npz")
        di = rank // seq
        sl = slice(di * per, (di + 1) * per)
        np.testing.assert_allclose(r[f"{route}_out"], ref_out[sl].numpy(),
                                   rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(r[f"{route}_demb"], ref_demb[sl].numpy(),
                                   rtol=2e-3, atol=2e-5)
        np.testing.assert_allclose(r[f"{route}_grads"], _flat(ref_grads),
                                   rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("name,n", [("two", 2), ("four", 4)])
def test_process_mesh_train_step_matches_one_process(groups, synth_dir, name,
                                                     n):
    """atol 1e-5 is 1% of the learning rate: Adam's first step divides each
    gradient by its own magnitude, so a gradient near its eps (1e-8) that
    sums in another order moves by a few thousandths of lr."""
    out_dir = _results(groups, name)
    params, loss = _train_step(synth_dir, None)
    for rank in range(n):
        r = np.load(out_dir / f"rank{rank}.npz")
        assert abs(float(r["loss"]) - loss) <= 1e-5 * abs(loss)
        for p, t in params.items():
            np.testing.assert_allclose(r[f"param:{p}"], t.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=p)


def test_cli_train_two_processes_checkpoint_matches_one(groups, synth_dir,
                                                        tmp_path, capsys,
                                                        monkeypatch):
    from tencent_recommendation_2025_tpu_torch.cli import train as TRN
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    out_dir = _results(groups, "cli")
    monkeypatch.setenv("TRAIN_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("TRAIN_LOG_PATH", str(tmp_path / "logs"))
    monkeypatch.setenv("TRAIN_CKPT_PATH", str(tmp_path / "ckpt"))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    TRN.main(CLI_ARGS)
    assert "WARNING: preset wants 2 devices but only 1 present — training " \
        "single-device" in capsys.readouterr().out
    one, _ = CK.load_params(CK.latest_checkpoint(tmp_path / "ckpt"))
    ck = CK.latest_checkpoint(out_dir / "ckpt")
    two, _ = CK.load_params(ck)
    step_of = lambda c: c.name.split(".")[0]   # noqa: E731
    assert step_of(ck) == step_of(CK.latest_checkpoint(tmp_path / "ckpt"))
    # the step losses agree tightly; the parameters to a tenth of the
    # learning rate (1e-3): Adam divides each gradient by its own
    # magnitude, so an element whose gradient is near 0 (and sums in
    # another order: the ring, and tower dedup in the single process only)
    # moves by a part of lr per step
    def losses(path):
        return [json.loads(ln)["loss"] for ln in open(path / "train.log")
                if "loss" in json.loads(ln)]

    l1, l2 = losses(tmp_path / "logs"), losses(out_dir / "logs")
    assert len(l1) == len(l2) > 1
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    from tencent_recommendation_2025_tpu_torch.bridge import _flatten

    f1, f2 = _flatten(one), _flatten(two)
    assert f1.keys() == f2.keys()
    for k in f1:
        np.testing.assert_allclose(np.asarray(f2[k], np.float32),
                                   np.asarray(f1[k], np.float32), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
