"""Per-shard checkpoints of a row-sharded train state (tencent_recommendation_
2025_tpu_torch/train/checkpoint.py) in the JAX package's manifest format
(tests/test_resilience.py:431):

- a state on a local mesh of 4 data shards writes every table leaf (the
  tables, their AdamW moments, the sparse table's row state) as one file
  per row extent under ``"shards"``, the shard-pad rows kept; a kill
  mid-write leaves only the ``.tmp`` staging directory;
- the JAX ``load_checkpoint`` reads the port's sharded checkpoint into an
  unsharded template of the same tree (its shard-pad rows cut), and the
  port reads a JAX-written sharded train state, on one device and onto a
  mesh;
- loaded onto a process mesh, a table leaf is read for the process's row
  extent only: its shard files by memory map, no other's;
- a state saved on 4 shards resumes on 2 and on one device: the same
  parameters and optimizer state, and the next step's loss and parameters
  equal to the 4 shards' own next step (loss rtol 1e-5, parameters rtol /
  atol 1e-5).

``sharded_multihost`` cut to D=16, 2 blocks, L=32, batch 8, BCE, dropout
off, f32, the item table sparse (lazy Adam), the user and feature tables
dense."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import MeshConfig as JMesh
from tencent_recommendation_2025_tpu.config import PRESETS as JPRESETS
from tencent_recommendation_2025_tpu.data.featurizer import \
    FusedVocab as JFused
from tencent_recommendation_2025_tpu.data.readers import TencentGRData as JData
from tencent_recommendation_2025_tpu.data.schema import FeatureSchema as JSch
from tencent_recommendation_2025_tpu.models.baseline import \
    SeqRecModel as JModel
from tencent_recommendation_2025_tpu.parallel import mesh as JM
from tencent_recommendation_2025_tpu.parallel import train as JPT
from tencent_recommendation_2025_tpu.train import checkpoint as JCK
from tencent_recommendation_2025_tpu_torch.bridge import _nest
from tencent_recommendation_2025_tpu_torch.config import PRESETS, MeshConfig
from tencent_recommendation_2025_tpu_torch.data.dataset import TrainSampler
from tencent_recommendation_2025_tpu_torch.data.featurizer import (
    FusedVocab, build_item_tables)
from tencent_recommendation_2025_tpu_torch.data.pipeline import TrainLoader
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.parallel import train as TPT
from tencent_recommendation_2025_tpu_torch.parallel.mesh import local_mesh
from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)

MODEL = dict(hidden_units=16, num_blocks=2, num_heads=2, maxlen=31,
             dropout_rate=0.0, dtype="float32")
TRAIN = dict(batch_size=8, loss_type="bce", tower_dedup=False,
             table_optimizer="lazy_adam")


def _cfg(presets):
    cfg = presets["sharded_multihost"]()
    return cfg.replace(model=dataclasses.replace(cfg.model, **MODEL),
                       train=dataclasses.replace(cfg.train, **TRAIN),
                       mesh=dataclasses.replace(cfg.mesh, data=4, model=1))


@pytest.fixture(scope="module")
def world(synth_dir):
    cfg = _cfg(PRESETS)
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    tab = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                            data.mm_emb_dict, data.indexer_i_rev)
    loader = TrainLoader(TrainSampler(data, schema, cfg.model.maxlen),
                         np.arange(16), 8, seed=2)
    return dict(cfg=cfg, model=model, tabs=TTR.device_tables(tab, "cpu"),
                raw=list(loader.epoch(1)))


def _step(w, state, mesh, i):
    cfg, model = w["cfg"], w["model"]
    S = 1 if mesh is None else mesh.shape["data"]
    b = TTR.augment_batch_sparse(w["raw"][i], cfg, model.itemnum, (0, i),
                                 n_table_shards=S)
    state, m = TTR.make_train_step(model, cfg, mesh)(
        state, TTR.put_batch(b, "cpu"), w["tabs"]["mm"], w["tabs"])
    return state, float(m["loss"])


def _whole(w, state, mesh):
    """{tree path: tensor} of a state at the tables' rows."""
    if mesh is not None:
        state = TPT.unpad_state(state, w["model"], mesh)
    return {p: t.detach().clone() for p, t in CK._state_tensors(
        state).items()}


@pytest.fixture(scope="module")
def saved(world, tmp_path_factory):
    """A state trained one step on a local mesh of 4, saved; and its next
    step's loss and state."""
    mesh = local_mesh(MeshConfig(data=4))
    state = TPT.init_sharded_state(world["model"], world["cfg"], mesh,
                                   seed=5, device="cpu")
    state, _ = _step(world, state, mesh, 0)
    root = tmp_path_factory.mktemp("sharded_ckpt")
    path = CK.save_checkpoint(root, state, 1, 0.5,
                              model_config=world["model"].cfg, mesh=mesh)
    before = _whole(world, state, mesh)
    state, loss = _step(world, state, mesh, 1)
    return dict(root=root, path=path, before=before, loss=loss,
                after=_whole(world, state, mesh))


def test_manifest_lists_one_file_per_extent(world, saved):
    entries = {e["path"]: e for e in json.loads(
        (saved["path"] / "manifest.json").read_text())["leaves"]}
    m = world["model"]
    for path, rows in (("0/item_emb", m.itemnum + 1),
                       ("1/tables/item_emb/mu", m.itemnum + 1),
                       ("0/fused_feat", m.fused.total_rows),
                       ("1/user_emb/exp_avg_sq", m.usernum + 1)):
        e = entries[path]
        assert "file" not in e and len(e["shards"]) == 4, path
        padded = 4 * -(-rows // 4)
        assert e["shape"][0] == padded
        for s, sh in enumerate(e["shards"]):
            lo, hi = s * padded // 4, (s + 1) * padded // 4
            assert sh["index"][0] == [lo, hi]
            i = int(sh["file"].split(".")[0].split("_")[1])
            assert sh["file"] == f"leaf_{i:05d}." + "_".join(
                f"{a}-{b}" for a, b in sh["index"]) + ".npy"
            assert np.load(saved["path"] / sh["file"]).shape[0] == hi - lo
    assert "file" in entries["0/pos_emb"] and "shards" not in entries["2"]


def test_kill_mid_write_leaves_only_tmp(world, saved):
    mesh = local_mesh(MeshConfig(data=4))
    state = TPT.init_sharded_state(world["model"], world["cfg"], mesh,
                                   seed=5, device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        CK.save_checkpoint(saved["root"], state, 9, 0.1, mesh=mesh,
                           _fault_after_files=5)
    assert CK.latest_checkpoint(saved["root"]) == saved["path"]
    assert any(d.name.endswith(".tmp") and d.name.startswith("global_step9")
               for d in saved["root"].iterdir())


def test_jax_loader_reads_the_port_sharded_checkpoint(saved):
    """Into a template of the same tree at the tables' rows: the JAX
    loader reassembles the extents and cuts the shard-pad rows."""
    want = saved["before"]
    template = _nest({p: jnp.zeros(tuple(t.shape), jnp.float32)
                      if t.is_floating_point() else jnp.zeros((), jnp.int32)
                      for p, t in want.items()})
    got, meta = JCK.load_checkpoint(saved["path"], template)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(got)}
    assert flat.keys() == want.keys()
    for p, t in want.items():
        np.testing.assert_array_equal(flat[p], t.numpy(), err_msg=p)
    assert meta["global_step"] == 1


def _jax_saved(world, root):
    """A JAX train state on a data mesh of 4 fake devices, saved per
    shard; its unpadded parameters."""
    jcfg = _cfg(JPRESETS)
    m = world["model"]
    jdata = JData(world["synth_dir"], mm_emb_ids=("81",))
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    jm = JModel(cfg=jcfg.model, schema=jschema, fused=JFused.build(jschema),
                usernum=m.usernum, itemnum=m.itemnum)
    mesh = JM.build_mesh(JMesh(data=4), devices=jax.devices()[:4])
    state, _ = JPT.init_sharded_state(jm, jcfg, mesh)
    path = JCK.save_checkpoint(root, state, 3, 0.25,
                               model_config=jcfg.model)
    template = jm.init(jax.random.key(jcfg.train.seed))
    return path, jax.tree.map(np.asarray,
                              JPT.unpad_state(state, template).params)


def test_port_reads_a_jax_sharded_checkpoint(world, synth_dir, tmp_path):
    if jax.device_count() < 4:
        pytest.skip("needs 4 fake devices")
    world = dict(world, synth_dir=synth_dir)
    path, want = _jax_saved(world, tmp_path)
    entries = {e["path"]: e for e in json.loads(
        (path / "manifest.json").read_text())["leaves"]}
    assert "shards" in entries["0/item_emb"]
    one, meta = CK.load_checkpoint(path, world["model"], world["cfg"])
    assert one.layout is None and one.step == 0
    assert meta["global_step"] == 3
    from tencent_recommendation_2025_tpu_torch.bridge import _flatten

    flat = _flatten(one.params)
    for p, a in _flatten(want).items():
        np.testing.assert_array_equal(flat[p].detach().numpy(), a,
                                      err_msg=p)
    two, _ = CK.load_checkpoint(path, world["model"], world["cfg"],
                                mesh=local_mesh(MeshConfig(data=2)))
    assert two.layout == ("local", 2)
    got = _whole(world, two, local_mesh(MeshConfig(data=2)))
    for p, t in CK._state_tensors(one).items():
        np.testing.assert_array_equal(got[p].numpy(), t.detach().numpy(),
                                      err_msg=p)


class _Process:
    """A stand-in for a process of a process mesh: the load reads no
    collective."""

    process = True

    def __init__(self, data, index):
        self.shape = {"pipe": 1, "data": data, "model": 1, "seq": 1}
        self.data_index = index


def test_process_mesh_load_reads_its_extent_only(world, saved,
                                                 monkeypatch):
    """Saved on 4 shards, loaded by process 0 of 2: each table leaf's rows
    [0, V / 2) from the extents 0 and 1 by memory map, the extents 2 and 3
    never opened; the rows equal the whole state's."""
    opened = []
    load = np.load

    def spy(f, *a, **k):
        opened.append((Path(f).name, k.get("mmap_mode")))
        return load(f, *a, **k)

    monkeypatch.setattr(CK.np, "load", spy)
    mesh = _Process(2, 0)
    state, _ = CK.load_checkpoint(saved["path"], world["model"],
                                  world["cfg"], mesh=mesh)
    monkeypatch.setattr(CK.np, "load", load)
    assert state.layout == ("process", 2, 0)
    tables = [f for f, _ in opened if f.count(".") == 2]
    assert tables and all(mode == "r" for f, mode in opened
                          if f.count(".") == 2)
    lows = {f.split(".")[1].split("_")[0] for f in tables}
    m = world["model"]
    for rows in (m.itemnum + 1, m.usernum + 1, m.fused.total_rows):
        padded = 4 * -(-rows // 4)
        assert f"{2 * padded // 4}-{3 * padded // 4}" not in lows
        assert f"{3 * padded // 4}-{padded}" not in lows
    for p, t in CK._state_tensors(state).items():
        want = saved["before"][p]
        if t.dim() and t.shape[0] != want.shape[0]:
            want = want[:t.shape[0]]
        np.testing.assert_array_equal(t.detach().numpy(), want.numpy(),
                                      err_msg=p)


@pytest.mark.parametrize("shards", [2, 1])
def test_state_saved_on_four_resumes_on_fewer(world, saved, shards):
    mesh = local_mesh(MeshConfig(data=shards)) if shards > 1 else None
    state, meta = CK.load_checkpoint(saved["path"], world["model"],
                                     world["cfg"], mesh=mesh)
    assert state.step == 1
    got = _whole(world, state, mesh)
    assert got.keys() == saved["before"].keys()
    for p, t in saved["before"].items():
        np.testing.assert_array_equal(got[p].numpy(), t.numpy(), err_msg=p)
    state, loss = _step(world, state, mesh, 1)
    np.testing.assert_allclose(loss, saved["loss"], rtol=1e-5)
    after = _whole(world, state, mesh)
    for p, t in saved["after"].items():
        np.testing.assert_allclose(after[p].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=p)
