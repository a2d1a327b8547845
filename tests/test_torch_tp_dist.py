"""Tensor parallelism across processes (tencent_recommendation_2025_tpu_
torch/parallel/mesh.py, partition.py, train.py; train/trainer.py,
checkpoint.py; cli/train.py) on the CPU: groups of processes joined by
gloo, each the worker of this file run as a script.

- 2 processes (model 2) and 4 (data 2 x model 2): two steps of
  ``sharded_multihost`` cut to D=16, H=2, 2 blocks, L=32, batch 8 (sparse
  ``item_emb``, rowwise Adagrad, the sampled softmax, dropout off, f32)
  leave every parameter, gathered whole, and the losses equal to a local
  mesh's of the same shape and to one device's (loss rtol 1e-5; the
  parameters rtol 2e-3 / atol 2e-5, the JAX tests' bound after a step);
  each rank holds its model slice of every tensor-parallel leaf and of its
  AdamW moments (the packed ``uvqk`` and ``w13`` by part) and its table
  shard, V / (data x model) rows, and gets them back bitwise from a
  checkpoint of the state loaded onto the mesh.
- ``cli.train --preset sharded_multihost --device cpu`` under 4 processes,
  without ``--mesh_model``: the preset's model = 2, the rest on data (data
  2 x model 2); one epoch, whose per-shard checkpoint (tensor-parallel
  leaves whole) equals the same CLI run on a local mesh of that shape in
  one process (loss and parameters at the bound above), loads in one
  process (``train.checkpoint.load_checkpoint``) and in the JAX package's
  loader.

The groups run at once, started by a module fixture, each with a time
limit of its own."""

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
         "--num_heads", "2", "--dtype", "float32", "--device", "cpu",
         "--num_workers", "1", "--batch_size", "8", "--num_epochs", "1",
         "--dropout_rate", "0.0"]
#: name -> (processes, model)
GROUPS = {"model2": (2, 2), "data2_model2": (4, 2)}
STEPS = 2


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
                                  dropout_rate=0.0),
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
    whole, the losses). With ``ckpt_dir`` the state is saved there and
    loaded back onto ``mesh``: whether every parameter and AdamW moment
    this process holds came back bitwise joins the shapes (key
    ``resumed``)."""
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        table_shards
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg, model, tables, batch = _world(data_dir)
    state = PT.init_sharded_state(model, cfg, mesh, seed=5, device="cpu") \
        if mesh is not None else TR.init_state(model, cfg, seed=5)
    b = TR.augment_batch_sparse(batch, cfg, model.itemnum, (0, 1),
                                n_table_shards=table_shards(mesh),
                                usernum=model.usernum)
    tabs = TR.device_tables(tables, "cpu")
    step = TR.make_train_step(model, cfg, mesh)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, TR.put_batch(b, "cpu"), tabs["mm"], tabs)
        losses.append(float(m["loss"]))
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
    if mesh is not None:
        state = PT.unpad_state(state, model, mesh)
    params = {p: t.detach().float() for p, t in TR.param_leaves(state.params)}
    return held, params, losses


def _worker(kind, out_dir, data_dir, model):
    import torch.distributed as dist

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        build_mesh, initialize_distributed)

    torch.set_num_threads(1)
    if kind == "cli":
        from tencent_recommendation_2025_tpu_torch.cli import train as TRN

        TRN.main(["--preset", "sharded_multihost", *SMALL])
        return
    initialize_distributed("cpu")
    mesh = build_mesh(MeshConfig(model=model))
    held, params, losses = _steps(data_dir, mesh, Path(out_dir) / "ckpt")
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", held=json.dumps(held),
             losses=np.asarray(losses),
             **{f"param:{p}": t.numpy() for p, t in params.items()})
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(n, kind, out_dir, data_dir, model=1, env_extra=None):
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT), **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), kind,
             str(out_dir), str(data_dir), str(model)],
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
    root = tmp_path_factory.mktemp("tp_dist")
    dirs = {k: root / k for k in list(GROUPS) + ["cli"]}
    for d in dirs.values():
        d.mkdir()
    started = {name: _start(n, "step", dirs[name], synth_dir, model)
               for name, (n, model) in GROUPS.items()}
    started["cli"] = _start(4, "cli", dirs["cli"], synth_dir,
                            env_extra=_cli_env(dirs["cli"], synth_dir))
    return started, dirs, {}


def _results(groups, name):
    started, dirs, outs = groups
    if name not in outs:
        outs[name] = _wait(started[name])
    return dirs[name], outs[name]


_REF = {}


def _reference(synth_dir, shape):
    """One device's run (``shape`` None) or a local mesh's."""
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh

    key = None if shape is None else tuple(sorted(shape.items()))
    if key not in _REF:
        mesh = None if shape is None else local_mesh(MeshConfig(**shape))
        _REF[key] = _steps(synth_dir, mesh)
    return _REF[key]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5,
                               err_msg=what)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_process_mesh_steps_match_local_mesh_and_one_device(
        groups, synth_dir, group):
    n, model = GROUPS[group]
    out_dir, _ = _results(groups, group)
    shape = dict(data=n // model, model=model)
    _, one, one_losses = _reference(synth_dir, None)
    _, local, local_losses = _reference(synth_dir, shape)
    np.testing.assert_allclose(local_losses, one_losses, rtol=1e-5)
    for p, t in one.items():
        _close(local[p].numpy(), t.numpy(), p)
    for rank in range(n):
        r = np.load(out_dir / f"rank{rank}.npz")
        np.testing.assert_allclose(r["losses"], local_losses, rtol=1e-5)
        for p, t in local.items():
            _close(r[f"param:{p}"], t.numpy(), p)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_each_rank_holds_only_its_slices(groups, synth_dir, group):
    """A rank's tensor-parallel leaves and their AdamW moments are 1 / M of
    the whole along the rule's dim (JAX ``PARAM_RULES``); the replicated
    leaves are whole; the learned tables hold V / (data x model) rows. A
    checkpoint of the state, loaded back onto the mesh
    (``load_checkpoint(mesh=)``), gives every slice and moment back
    bitwise."""
    from tencent_recommendation_2025_tpu_torch.parallel import \
        partition as PP

    n, M = GROUPS[group]
    out_dir, _ = _results(groups, group)
    whole, _, _ = _reference(synth_dir, None)
    dims = PP.model_dims({p: torch.empty(s) for p, s in whole.items()
                          if "/exp_avg" not in p})
    assert {"blocks/hstu/uvqk/w", "blocks/ffn/w2", "itemdnn/w",
            "mm_proj/81/b"} <= set(dims)
    for rank in range(n):
        held = json.loads(str(np.load(out_dir / f"rank{rank}.npz")["held"]))
        # saved (tensor-parallel leaves gathered whole) and loaded back
        # onto the mesh (cut to the slices again), bitwise
        assert held.pop("resumed") is True, rank
        for key, shape in held.items():
            p = key[:-len("/exp_avg")] if key.endswith("/exp_avg") else key
            want = list(whole[key])
            if p in dims:
                want[dims[p]] //= M
            elif p.split("/")[0] in ("item_emb", "user_emb", "fused_feat"):
                want[0] = -(-want[0] // n)
            assert shape == want, (rank, key, shape, want)


def _cli_local(synth_dir, tmp_path, monkeypatch):
    """cli.train in this process on a local mesh of data 2 x model 2 (the
    process group mocked, as tests/test_torch_mesh_presets_cli.py does)."""
    from tencent_recommendation_2025_tpu_torch.cli import train as TRN
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel import mesh as PM

    built = []

    def build(cfg):
        built.append(cfg)
        return PM.local_mesh(MeshConfig(data=2, model=cfg.model))

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(PM, "initialize_distributed", lambda device: True)
    monkeypatch.setattr(PM, "build_mesh", build)
    for k, v in _cli_env(tmp_path, synth_dir).items():
        monkeypatch.setenv(k, v)
    TRN.main(["--preset", "sharded_multihost", *SMALL])
    assert [c.model for c in built] == [2]
    return tmp_path


def test_cli_sharded_multihost_trains_on_its_model_axis(
        groups, synth_dir, tmp_path, monkeypatch):
    """4 processes, no --mesh_model: data 2 x model 2, each rank writing
    its table extents; the checkpoint equals the local mesh's run, loads
    in one process and in the JAX loader."""
    import jax

    from tencent_recommendation_2025_tpu.train import checkpoint as JCK
    from tencent_recommendation_2025_tpu_torch.bridge import (
        _flatten, params_from_jax)
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    out_dir, outs = _results(groups, "cli")
    assert "mesh: {'pipe': 1, 'data': 2, 'model': 2, 'seq': 1} over 4 " \
        "processes (rank 0)" in outs[0]
    assert "training single-device" not in outs[0]
    ck = CK.latest_checkpoint(out_dir / "ckpt")
    entries = {e["path"]: e for e in json.loads(
        (ck / "manifest.json").read_text())["leaves"]}
    assert len(entries["0/item_emb"]["shards"]) == 4
    for p in ("0/blocks/hstu/uvqk/w", "1/blocks/ffn/w2/exp_avg",
              "0/itemdnn/w"):
        assert "file" in entries[p]          # whole, written by rank 0
    local = CK.latest_checkpoint(_cli_local(synth_dir, tmp_path,
                                            monkeypatch) / "ckpt")
    assert local.name.split(".valid")[0] == ck.name.split(".valid")[0]
    got = _flatten(params_from_jax(ck))
    want = _flatten(params_from_jax(local))
    assert got.keys() == want.keys()
    for p in want:
        _close(got[p].float().numpy(), want[p].float().numpy(), p)
    # one process, the port's loader and the JAX package's
    cfg, model, _, _ = _world(synth_dir)
    state, meta = CK.load_checkpoint(ck, model, cfg)
    assert state.layout is None and state.step == meta["global_step"]
    assert tuple(state.params["blocks"]["hstu"]["uvqk"]["w"].shape) == \
        (2, 16, 64)
    import jax.numpy as jnp

    from tencent_recommendation_2025_tpu_torch.bridge import _nest

    template = _nest({e["path"]: jnp.zeros(tuple(e["shape"]), jnp.float32
                                           if e["dtype"] == "float32"
                                           else jnp.int32)
                      for e in entries.values()})
    jstate, _ = JCK.load_checkpoint(ck, template)
    jflat = {"/".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(jstate)}
    for p in ("blocks/hstu/uvqk/w", "blocks/ffn/w13", "itemdnn/w"):
        np.testing.assert_array_equal(jflat[f"0/{p}"], got[p].numpy(),
                                      err_msg=p)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
