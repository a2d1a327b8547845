"""Pipeline parallelism across processes (tencent_recommendation_2025_tpu_
torch/parallel/pipeline_parallel.py, mesh.py, train.py; train/trainer.py,
checkpoint.py; cli/train.py) on the CPU: groups of processes joined by
gloo, each the worker of this file run as a script.

- 2 processes (pipe 2) and 4 (pipe 2 x data 2): two steps of
  ``sharded_multihost`` cut to D=16, H=2, 2 blocks, L=32, batch 8, 4
  microbatches a data column (sparse ``item_emb``, rowwise Adagrad, the
  sampled softmax, f32, dropout 0.2) leave every parameter, gathered
  whole, the losses and the gradient metrics equal to a local mesh's of
  the same shape (loss rtol 1e-5, ``grad_max`` / ``grad_mean`` rtol 1e-4;
  the parameters rtol 2e-3 / atol 2e-5, the JAX tests' bound
  after a step): the activations and their cotangents cross the stages by
  point-to-point sends, and the dropout masks ride with the rows. Each
  rank holds its stage's block of every stacked block leaf and of its
  AdamW moments, and its table shard, V / (pipe x data) rows, and gets
  them back bitwise from a checkpoint of the state loaded onto the mesh.
- ``cli.train --preset hstu_flagship --device cpu --mesh_pipe 2
  --pp_microbatches 4`` under 4 processes (pipe 2 x data 2): one epoch
  with finite losses, whose checkpoint (the block leaves whole) loads in
  one process (``train.checkpoint.load_checkpoint``) and in the JAX
  package's loader with equal leaves.

The groups run at once, started by a module fixture, each with a time
limit of its own, so that a deadlocked schedule fails instead of
hanging."""

import dataclasses
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
SMALL = ["--maxlen", "31", "--hidden_units", "16", "--num_blocks", "2",
         "--dtype", "float32", "--device", "cpu", "--num_workers", "1",
         "--batch_size", "8", "--num_epochs", "1"]
#: name -> (processes, pipe)
GROUPS = {"pipe2": (2, 2), "pipe2_data2": (4, 2)}
STEPS = 2
MICROBATCHES = 4


def _world(data_dir):
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

    cfg = PRESETS["sharded_multihost"]()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hidden_units=16, num_blocks=2,
                                  num_heads=2, maxlen=31, dtype="float32",
                                  dropout_rate=0.2),
        train=dataclasses.replace(cfg.train, batch_size=8, tower_dedup=False,
                                  num_sampled_negatives=16))
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
    return cfg, model, tables, next(iter(loader.epoch(1)))


def _steps(data_dir, mesh, ckpt_dir=None):
    """(the shapes this process holds, the parameters after STEPS steps
    whole, the losses, each step's (grad_max, grad_mean)). With ``ckpt_dir`` the state is saved there and
    loaded back onto ``mesh``: whether every parameter and AdamW moment
    this process holds came back bitwise joins the shapes (key
    ``resumed``)."""
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        table_shards
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg, model, tables, batch = _world(data_dir)
    state = PT.init_sharded_state(model, cfg, mesh, seed=5, device="cpu")
    b = TR.augment_batch_sparse(batch, cfg, model.itemnum, (0, 1),
                                n_table_shards=table_shards(mesh),
                                usernum=model.usernum)
    tabs = TR.device_tables(tables, "cpu")
    step = TR.make_train_step(model, cfg, mesh)
    losses, grad_metrics = [], []
    for _ in range(STEPS):
        state, m = step(state, TR.put_batch(b, "cpu"), tabs["mm"], tabs)
        losses.append(float(m["loss"]))
        grad_metrics.append([float(m["grad_max"]), float(m["grad_mean"])])
    held = {}
    for p, t in TR.param_leaves(state.params):
        held[p] = list(t.shape)
        st = state.opt.state.get(t, {})
        if "exp_avg" in st:
            held[f"{p}/exp_avg"] = list(st["exp_avg"].shape)
    held.update({f"{n}/{k}": list(t.shape)
                 for n, o in state.tables.items() for k, t in o.items()})
    if ckpt_dir is not None:
        from tencent_recommendation_2025_tpu_torch.train import \
            checkpoint as CK

        CK.save_checkpoint(ckpt_dir, state, STEPS, mesh=mesh,
                           model_config=model.cfg)
        back, _ = CK.load_checkpoint(ckpt_dir, model, cfg, mesh=mesh)
        held["resumed"] = back.layout == state.layout and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                TR.param_leaves(state.params), TR.param_leaves(back.params)))
        for (_, a), (_, b) in zip(TR.dense_leaves(state.params, cfg),
                                  TR.dense_leaves(back.params, cfg)):
            sa, sb = state.opt.state[a], back.opt.state[b]
            held["resumed"] &= all(torch.equal(sa[k], sb[k])
                                   for k in ("exp_avg", "exp_avg_sq"))
    state = PT.unpad_state(state, model, mesh)
    params = {p: t.detach().float() for p, t in TR.param_leaves(state.params)}
    return held, params, losses, grad_metrics


def _worker(kind, out_dir, data_dir, pipe):
    import torch.distributed as dist

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        build_mesh, initialize_distributed)

    torch.set_num_threads(1)
    if kind == "cli":
        from tencent_recommendation_2025_tpu_torch.cli import train as TRN

        TRN.main(["--preset", "hstu_flagship", *SMALL, "--mesh_pipe",
                  str(pipe), "--pp_microbatches", str(MICROBATCHES)])
        return
    initialize_distributed("cpu")
    mesh = build_mesh(MeshConfig(pipe=pipe, pp_microbatches=MICROBATCHES))
    held, params, losses, grad_metrics = _steps(data_dir, mesh,
                                                Path(out_dir) / "ckpt")
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", held=json.dumps(held),
             losses=np.asarray(losses),
             grad_metrics=np.asarray(grad_metrics),
             **{f"param:{p}": t.numpy() for p, t in params.items()})
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(n, kind, out_dir, data_dir, pipe, env_extra=None):
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT), **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), kind,
             str(out_dir), str(data_dir), str(pipe)],
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


def _cli_env(d, data_dir):
    return {"TRAIN_DATA_PATH": str(data_dir),
            "TRAIN_LOG_PATH": str(d / "logs"),
            "TRAIN_CKPT_PATH": str(d / "ckpt")}


@pytest.fixture(scope="module")
def groups(synth_dir, tmp_path_factory):
    """Every process group, started at once."""
    root = tmp_path_factory.mktemp("pp_dist")
    dirs = {k: root / k for k in list(GROUPS) + ["cli"]}
    for d in dirs.values():
        d.mkdir()
    started = {name: _start(n, "step", dirs[name], synth_dir, pipe)
               for name, (n, pipe) in GROUPS.items()}
    started["cli"] = _start(4, "cli", dirs["cli"], synth_dir, 2,
                            env_extra=_cli_env(dirs["cli"], synth_dir))
    return started, dirs, {}


def _results(groups, name):
    started, dirs, outs = groups
    if name not in outs:
        outs[name] = _wait(started[name])
    return dirs[name], outs[name]


_REF = {}


def _reference(synth_dir, shape):
    """A local mesh's run."""
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh

    key = tuple(sorted(shape.items()))
    if key not in _REF:
        _REF[key] = _steps(synth_dir, local_mesh(MeshConfig(
            pp_microbatches=MICROBATCHES, **shape)))
    return _REF[key]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5,
                               err_msg=what)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_process_mesh_steps_match_local_mesh(groups, synth_dir, group):
    n, pipe = GROUPS[group]
    out_dir, _ = _results(groups, group)
    _, local, local_losses, local_gm = _reference(
        synth_dir, dict(pipe=pipe, data=n // pipe))
    for rank in range(n):
        r = np.load(out_dir / f"rank{rank}.npz")
        np.testing.assert_allclose(r["losses"], local_losses, rtol=1e-5)
        # grad_max and grad_mean over the whole leaves: each stage's block
        # gradients reduced over its pipe group, the tables over all shards
        np.testing.assert_allclose(r["grad_metrics"], local_gm, rtol=1e-4,
                                   err_msg=f"rank {rank}")
        for p, t in local.items():
            _close(r[f"param:{p}"], t.numpy(), p)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_each_rank_holds_only_its_stage(groups, synth_dir, group):
    """A rank's stacked block leaves and their AdamW moments hold its
    stage's NB / P blocks; the other replicated leaves are whole; the
    learned tables hold V / (pipe x data) rows. A checkpoint of the state,
    loaded back onto the mesh (``load_checkpoint(mesh=)``), gives every
    block and moment back bitwise."""
    n, P = GROUPS[group]
    out_dir, _ = _results(groups, group)
    _, whole, _, _ = _reference(synth_dir, dict(pipe=P, data=n // P))
    for rank in range(n):
        held = json.loads(str(np.load(out_dir / f"rank{rank}.npz")["held"]))
        assert held.pop("resumed") is True, rank
        for key, shape in held.items():
            p = key[:-len("/exp_avg")] if key.endswith("/exp_avg") else key
            name = p.split("/")[0]
            if name in ("item_emb", "user_emb", "fused_feat") \
                    or p.startswith("item_emb/"):
                assert shape[0] * n >= whole[name].shape[0], (rank, key)
                continue
            want = list(whole[p].shape)
            if p.startswith("blocks/"):
                want[0] //= P
            assert shape == want, (rank, key, shape, want)


def test_cli_trains_on_a_pipe_mesh(groups, synth_dir):
    """4 processes, ``--mesh_pipe 2``: pipe 2 x data 2, finite losses; the
    checkpoint holds the block leaves whole and the table per shard, and
    loads in one process and in the JAX loader with equal leaves."""
    import jax
    import jax.numpy as jnp

    from tencent_recommendation_2025_tpu.train import checkpoint as JCK
    from tencent_recommendation_2025_tpu_torch.bridge import (
        _flatten, _nest, params_from_jax)
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    out_dir, outs = _results(groups, "cli")
    assert "mesh: {'pipe': 2, 'data': 2, 'model': 1, 'seq': 1} over 4 " \
        "processes (rank 0)" in outs[0]
    assert "training single-device" not in outs[0]
    lines = [json.loads(ln) for ln in open(out_dir / "logs" / "train.log")]
    assert lines and all(np.isfinite(ln["loss"]) for ln in lines)
    ck = CK.latest_checkpoint(out_dir / "ckpt")
    entries = {e["path"]: e for e in json.loads(
        (ck / "manifest.json").read_text())["leaves"]}
    assert len(entries["0/item_emb"]["shards"]) == 4
    for p in ("0/blocks/hstu/uvqk/w", "1/blocks/ffn/w2/exp_avg"):
        assert "file" in entries[p] and entries[p]["shape"][0] == 2, p
    got = _flatten(params_from_jax(ck))
    # one process, the port's loader
    from tencent_recommendation_2025_tpu_torch.cli import train as TRN
    from tencent_recommendation_2025_tpu_torch.data.featurizer import \
        FusedVocab
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg = TRN.build_config(TRN.get_args(["--preset", "hstu_flagship",
                                         *SMALL]))
    data = TencentGRData(synth_dir, mm_emb_ids=cfg.features.mm_emb_ids)
    schema = FeatureSchema.from_indexer(data.indexer,
                                        cfg.features.mm_emb_ids,
                                        cfg.features.array_cap)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    state, meta = CK.load_checkpoint(ck, model, cfg)
    assert state.layout is None and state.step == meta["global_step"]
    for p, t in TR.param_leaves(state.params):
        np.testing.assert_array_equal(t.detach().numpy(),
                                      got[p][:len(t)].numpy(), err_msg=p)
    # the JAX package's loader
    template = _nest({e["path"]: jnp.zeros(tuple(e["shape"]), jnp.float32
                                           if e["dtype"] == "float32"
                                           else jnp.int32)
                      for e in entries.values()})
    jstate, _ = JCK.load_checkpoint(ck, template)
    jflat = {"/".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(jstate)}
    for p in got:
        np.testing.assert_array_equal(jflat[f"0/{p}"], got[p].numpy(),
                                      err_msg=p)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
