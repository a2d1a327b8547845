"""Row-sharded static item-feature tables on a data mesh (tencent_
recommendation_2025_tpu_torch/parallel/train.py ``shard_tables``,
parallel/sharded_embedding.py ``StaticTable`` / ``static_lookup``) against
the JAX package's ``shard_tables`` on the fake CPU devices of conftest.py.

- ``shard_tables`` row-shards exactly the leaves JAX does (2-D, more than
  64 rows), padded to a multiple of the table shards; the others stay whole
  at their shapes.
- The static take equals the whole table's take bitwise (``torch.equal``),
  for int32 and f32 tables whose rows are not a multiple of the shards,
  with a non-zero row 0, at ids 0, inside, V - 1 and past V. Past V it
  reads the real last row, as one device does; the JAX mesh's clip reads a
  zero pad row there (asserted).
- One step of hstu_flagship (BCE) and of sampled_softmax_dp (the sampled
  softmax with in-batch negatives; the stacked tower-dedup plan on the
  data-only mesh), cut to D=32, 2 blocks, L=32, batch 16, f32, dropout off,
  on local meshes of data 4 and of data 2 x seq 2, with the static tables
  sharded: loss and gradients against the JAX sharded step with
  ``shard_tables`` at tests/test_torch_dp.py's tolerances (loss rtol 2e-5;
  gradients rtol 2e-3 / atol 2e-5). The JAX step's item-id lookups take
  XLA's gather there, so the port's all-to-all is off too, as in
  tests/test_torch_dp.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import MeshConfig as JMesh
from tencent_recommendation_2025_tpu.config import PRESETS as JPRESETS
from tencent_recommendation_2025_tpu.data.featurizer import \
    FusedVocab as JFused
from tencent_recommendation_2025_tpu.data.featurizer import \
    build_item_tables as jbuild
from tencent_recommendation_2025_tpu.data.readers import TencentGRData as JData
from tencent_recommendation_2025_tpu.data.schema import FeatureSchema as JSch
from tencent_recommendation_2025_tpu.models.baseline import \
    SeqRecModel as JModel
from tencent_recommendation_2025_tpu.parallel import mesh as JM
from tencent_recommendation_2025_tpu.parallel import partition as JP
from tencent_recommendation_2025_tpu.parallel import train as JPT
from tencent_recommendation_2025_tpu.train import trainer as JTR
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.config import PRESETS, MeshConfig
from tencent_recommendation_2025_tpu_torch.data.dataset import TrainSampler
from tencent_recommendation_2025_tpu_torch.data.featurizer import (
    FusedVocab, build_item_tables)
from tencent_recommendation_2025_tpu_torch.data.pipeline import TrainLoader
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models import embedding as TE
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.ops import losses as TLS
from tencent_recommendation_2025_tpu_torch.parallel import \
    sharded_embedding as TSE
from tencent_recommendation_2025_tpu_torch.parallel import train as TPT
from tencent_recommendation_2025_tpu_torch.parallel.mesh import local_mesh
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)

requires_4 = pytest.mark.skipif(jax.device_count() < 4,
                                reason="needs 4 fake devices")

B = 16
MODEL = dict(hidden_units=32, num_blocks=2, maxlen=31, dropout_rate=0.0,
             dtype="float32")
MESHES = {"data4": dict(data=4), "data2xseq2": dict(data=2, seq=2)}
PRESET_NAMES = ("hstu_flagship", "sampled_softmax_dp")
NEG_KEY = (0, 97, 1, 0)       # the host prep's key of the shared negatives
KEY = 7                       # the JAX step's key


def _jmesh(shape):
    return JM.build_mesh(JMesh(**shape), devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def world(synth_dir):
    jdata = JData(synth_dir, mm_emb_ids=("81",))
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    jtab = jbuild(jdata.item_feat_dict, jdata.itemnum, jschema,
                  jdata.mm_emb_dict, jdata.indexer_i_rev)
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    tab = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                            data.mm_emb_dict, data.indexer_i_rev)
    sampler = TrainSampler(data, schema, MODEL["maxlen"])
    batch = next(iter(TrainLoader(sampler, np.arange(len(sampler)), B,
                                  seed=1).epoch(1)))
    return dict(jdata=jdata, jschema=jschema, jtab=jtab, data=data,
                schema=schema, tab=tab, batch=batch)


# ---------------------------------------------------------------------------
# shard_tables and the static take
# ---------------------------------------------------------------------------

def _tables(rng, V):
    """A static table tree: ``sparse`` [V, 14] int32 and ``mm`` [V, 32]
    f32 with non-zero rows 0, a small 2-D table and a 3-D ``array``."""
    return {"sparse": rng.integers(1, 50, (V, 14)).astype(np.int32),
            "array": rng.integers(0, 9, (V, 3, 8)).astype(np.int32),
            "small": rng.standard_normal((64, 8)).astype(np.float32),
            "mm": {"81": rng.standard_normal((V, 32)).astype(np.float32)}}


@requires_4
@pytest.mark.parametrize("shape", sorted(MESHES))
def test_shard_tables_keeps_the_jax_leaves_and_shapes(shape):
    """The same leaves sharded as JAX's (a row-sharded NamedSharding), at
    JAX's padded shapes; the 3-D table and the 64-row one whole."""
    rng = np.random.default_rng(0)
    tables = _tables(rng, 1001)
    jt = JPT.shard_tables(_jmesh(MESHES[shape]),
                          jax.tree.map(jnp.asarray, tables))
    tt = TPT.shard_tables(local_mesh(MeshConfig(**MESHES[shape])), tables,
                          "cpu")
    jl = jax.tree_util.tree_leaves_with_path(jt)
    tl = {tuple(k.key for k in p): v for p, v in
          jax.tree_util.tree_leaves_with_path(
              tt, is_leaf=lambda x: isinstance(x, TSE.StaticTable))}
    assert len(jl) == len(tl) == 4
    S = MESHES[shape]["data"]
    for path, leaf in jl:
        key = tuple(k.key for k in path)
        got = tl[key]
        sharded = not leaf.sharding.is_fully_replicated
        assert isinstance(got, TSE.StaticTable) == sharded, key
        assert tuple(got.shape) == leaf.shape, key
        if sharded:
            assert got.rows == 1001 and leaf.shape[0] == S * -(-1001 // S)
            assert len(got.blocks) == S
            np.testing.assert_array_equal(got.whole.numpy(),
                                          np.asarray(leaf))
    assert sorted(k for k, v in tl.items()
                  if isinstance(v, TSE.StaticTable)) == [("mm", "81"),
                                                         ("sparse",)]


@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_static_take_equals_the_whole_take(shape, dtype):
    """1001 rows over 4 or 2 table shards (pad rows at the end), row 0 not
    zero; ids 0, inside, V - 1, past V and far past it. The take equals
    the whole table's, bitwise; on a process mesh's formula too (each
    shard's owned rows, zeros elsewhere, summed over the shards)."""
    rng = np.random.default_rng(1)
    V = 1001
    table = torch.from_numpy(rng.integers(1, 50, (V, 14)).astype(np.int32)
                             if dtype == "int32" else
                             rng.standard_normal((V, 32)).astype(np.float32))
    assert table[0].abs().sum() > 0
    ids = torch.tensor([[0, 1, 500, V - 1], [V, V + 3, 10 ** 8, 250]],
                       dtype=torch.int32)
    mesh = local_mesh(MeshConfig(**MESHES[shape]))
    st = TSE.static_table(table, mesh)
    assert st.rows == V and st.whole.shape[0] % len(st.blocks) == 0
    want = table[ids.long().clamp(0, V - 1)]
    got = TE.static_take(st, ids)
    assert got.dtype == table.dtype and torch.equal(got, want)
    assert torch.equal(got[1, :3], table[V - 1].expand(3, -1))
    assert torch.equal(TE.static_take(table, ids), want)
    idx = ids.long().clamp(0, V - 1)
    summed = sum(TSE.owned_rows(b, idx, s * st.rows_per_shard)
                 for s, b in enumerate(st.blocks))
    assert torch.equal(summed, want)


@requires_4
def test_jax_mesh_take_past_the_table_reads_a_pad_row():
    """Fault 2 of the reference: after JAX ``shard_tables`` pads a table to
    the shards, an id past its rows clips to the last pad row (zeros) on
    the mesh, where one device clips to the last real row; the port's
    static take on the mesh reads the real last row."""
    rng = np.random.default_rng(2)
    V = 1001
    table = rng.standard_normal((V, 32)).astype(np.float32) + 3.0
    ids = np.array([V - 1, V, 10 ** 6], np.int32)
    jt = JPT.shard_tables(_jmesh(MESHES["data4"]),
                          {"mm": jnp.asarray(table)})["mm"]
    jtake = np.asarray(jnp.take(jt, jnp.asarray(ids), axis=0, mode="clip"))
    one = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0,
                              mode="clip"))
    np.testing.assert_array_equal(jtake[0], table[V - 1])
    assert not jtake[1:].any()
    np.testing.assert_array_equal(one[1:], table[[V - 1, V - 1]])
    st = TSE.static_table(torch.from_numpy(table),
                          local_mesh(MeshConfig(data=4)))
    np.testing.assert_array_equal(
        TE.static_take(st, torch.from_numpy(ids)).numpy(), one)


# ---------------------------------------------------------------------------
# the mesh step with sharded static tables against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _spmd_gather(monkeypatch):
    """Both packages' item-id lookups by the sharded gather, not the
    all-to-all, whose buckets overflow at the fixture's 100 items."""
    monkeypatch.setattr(JModel, "_ep_override", lambda *a: None)
    monkeypatch.setattr(SeqRecModel, "_ep_override", lambda *a, **k: None)


def _cfg(presets, preset, shape):
    cfg = presets[preset]()
    train = dict(batch_size=B, lr=1e-2,
                 tower_dedup=preset == "sampled_softmax_dp"
                 and "seq" not in shape)
    if preset == "sampled_softmax_dp":
        train.update(num_sampled_negatives=16, num_inbatch_negatives=8)
    return cfg.replace(model=dataclasses.replace(cfg.model, **MODEL),
                       train=dataclasses.replace(cfg.train, **train),
                       mesh=dataclasses.replace(cfg.mesh, **dict(
                           dict(data=1, seq=1), **shape)))


def _path(kp):
    return "/".join(str(k.key) for k in kp)


def _jax_loss_and_grads(w, jmodel, jcfg, jbatch, jmesh):
    """The JAX mesh loss and its gradients (at the unpadded rows) from
    ``init_sharded_state``, the static tables through ``shard_tables``;
    the in-batch draw's indices."""
    state, _ = JPT.init_sharded_state(jmodel, jcfg, jmesh)
    template = jmodel.init(jax.random.key(jcfg.train.seed))
    params0 = jax.tree.map(np.asarray,
                           JPT.unpad_state(state, template).params)
    tables = JPT.shard_tables(jmesh, JTR.device_tables(w["jtab"]))
    bsh = JPT.shard_batch(jmesh, jbatch)
    rng = jax.random.fold_in(jax.random.key(KEY), 0)

    def loss_fn(p):
        return JTR.compute_loss(jmodel, p, bsh, tables["mm"], tables, jcfg,
                                train=True, rng=rng, mesh=jmesh)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    grads = {_path(kp): np.asarray(v) for kp, v in
             jax.tree_util.tree_leaves_with_path(
                 JP.unpad_like(grads, template))}
    idx = None
    n = jcfg.train.num_inbatch_negatives
    if jcfg.train.loss_type == "sampled_softmax" and n > 0:
        inb = jax.random.split(rng, 3)[2]
        idx = np.asarray(jax.random.randint(inb, (n,), 0,
                                            jbatch["pos"].size))
    return params0, float(loss), grads, idx


@requires_4
@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_mesh_step_with_sharded_static_tables_matches_jax(world, preset,
                                                          shape, monkeypatch):
    shp = MESHES[shape]
    jcfg, cfg = _cfg(JPRESETS, preset, shp), _cfg(PRESETS, preset, shp)
    jmodel = JModel(cfg=jcfg.model, schema=world["jschema"],
                    fused=JFused.build(world["jschema"]),
                    usernum=world["jdata"].usernum,
                    itemnum=world["jdata"].itemnum)
    model = SeqRecModel(cfg=cfg.model, schema=world["schema"],
                        fused=FusedVocab.build(world["schema"]),
                        usernum=world["data"].usernum,
                        itemnum=world["data"].itemnum)
    jb, tb = dict(world["batch"]), dict(world["batch"])
    if cfg.train.loss_type == "sampled_softmax":
        jb["sampled_neg_ids"] = tb["sampled_neg_ids"] = \
            TTR._sample_negatives(cfg, model.itemnum, NEG_KEY)
    if cfg.train.tower_dedup:
        jb = JTR.augment_batch_dedup(jb, jcfg, world["jtab"], model.itemnum,
                                     step_key=NEG_KEY,
                                     n_data_shards=shp["data"])
        tb = TTR.augment_batch_dedup(tb, cfg, world["tab"], model.itemnum,
                                     step_key=NEG_KEY,
                                     n_data_shards=shp["data"])
    params0, jloss, jgrads, idx = _jax_loss_and_grads(
        world, jmodel, jcfg, jb, _jmesh(shp))

    mesh = local_mesh(MeshConfig(**shp))
    tabs = TPT.shard_tables(mesh, TTR.device_tables(world["tab"], "cpu"))
    assert isinstance(tabs["sparse"], TSE.StaticTable)
    assert isinstance(tabs["mm"]["81"], TSE.StaticTable)
    seen = []
    lookup = TSE.static_lookup
    monkeypatch.setattr(TE, "static_lookup",
                        lambda t, ids: seen.append(ids.shape) or lookup(t,
                                                                        ids))
    if idx is not None:
        monkeypatch.setattr(TLS, "inbatch_draw",
                            lambda n, total, gen, dev: torch.tensor(idx))
    state = TPT.shard_existing_state(
        mesh, TTR.init_state(model, cfg, params=params_from_jax(params0)))
    state, m = TPT.make_sharded_train_step(model, cfg, mesh)(
        state, TTR.put_batch(tb, "cpu"), tabs["mm"], tabs)
    assert seen, "no static lookup ran"
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=2e-5)
    grads = {p: t.grad for p, t in TTR.param_leaves(state.params)}
    assert grads.keys() == jgrads.keys()
    for name, g in grads.items():
        ref = jgrads[name]
        if g.shape[0] > ref.shape[0]:          # a row-sharded table's pad
            assert not g[ref.shape[0]:].any()
            g = g[:ref.shape[0]]
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-3, atol=2e-5,
                                   err_msg=name)
