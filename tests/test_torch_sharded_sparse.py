"""Sparse tables row-sharded on a data mesh (tencent_recommendation_2025_tpu_
torch/ops/sparse_table.py, train/trainer.py) and the dense data mesh's
all-to-all, against the JAX package on the 8 fake CPU devices of
conftest.py:

- ``host_shard_plan`` and ``shard_capacity`` bitwise equal to the JAX
  functions, the capacity overflow raising the same message
  (tests/test_sparse_table.py:617); the port's row plan of an unpacked
  table (no groups) is the JAX plan's lids, gpos and pos;
- the packed sharded step (``TABLE_PACK_MIN_ROWS`` patched to 1 in both
  packages, rowwise Adagrad), 3 steps on a data mesh of 8: the losses, the
  table and the accumulator against the JAX mesh step's
  (tests/test_sparse_table.py:542: losses rtol 1e-5, the table rtol 1e-5 /
  atol 1e-6, the accumulator rtol 1e-5 / atol 1e-7);
- the unpacked ``lazy_adam`` sparse step on data 8 against the JAX mesh
  step (tests/test_sparse_table.py:240), the table and its moments at the
  same tolerances, and its ``grad_max`` / ``grad_mean`` (over the padded
  row-sharded leaves, as JAX's) at rtol 1e-4;
- the stacked tower dedup with a sparse table on data 8
  (tests/test_tower_dedup.py:291): loss and table against the JAX mesh
  step's;
- the dense data-mesh step routed through the all-to-all
  (tests/test_parallel.py:223): ``ep_overflow`` 0 in its metrics, the a2a
  taken, the loss equal to the single device's at rtol 2e-5; and
  ``train_loop`` on that mesh writing ``Tables/ep_overflow`` each step,
  with the JAX loop's warning where ids overflowed.

``sharded_multihost`` cut to D=32, 2 blocks, L=32, batch 8 (a row a data
shard), dropout off, f32; the port runs a local mesh of 8 data shards."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import MeshConfig as JMesh
from tencent_recommendation_2025_tpu.config import PRESETS as JPRESETS
from tencent_recommendation_2025_tpu.data.dataset import \
    TrainSampler as JSampler
from tencent_recommendation_2025_tpu.data.featurizer import \
    FusedVocab as JFused, build_item_tables as jbuild
from tencent_recommendation_2025_tpu.data.pipeline import \
    TrainLoader as JLoader
from tencent_recommendation_2025_tpu.data.readers import TencentGRData as JData
from tencent_recommendation_2025_tpu.data.schema import FeatureSchema as JSch
from tencent_recommendation_2025_tpu.models.baseline import \
    SeqRecModel as JModel
from tencent_recommendation_2025_tpu.ops import sparse_table as JST
from tencent_recommendation_2025_tpu.parallel import mesh as JM
from tencent_recommendation_2025_tpu.parallel import train as JPT
from tencent_recommendation_2025_tpu.train import trainer as JTR
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.config import PRESETS, MeshConfig
from tencent_recommendation_2025_tpu_torch.data.featurizer import (
    FusedVocab, build_item_tables)
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.ops import sparse_table as TST
from tencent_recommendation_2025_tpu_torch.parallel import \
    sharded_embedding as TSE
from tencent_recommendation_2025_tpu_torch.parallel import train as TPT
from tencent_recommendation_2025_tpu_torch.parallel.mesh import local_mesh
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)

requires_8 = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 fake devices")

S, B = 8, 8
MODEL = dict(hidden_units=32, num_blocks=2, maxlen=31, dropout_rate=0.0,
             dtype="float32")
TRAIN = dict(batch_size=B, loss_type="bce", l2_emb=0.0, tower_dedup=False,
             num_sampled_negatives=16)


def _cfgs(**train):
    out = []
    for presets in (JPRESETS, PRESETS):
        cfg = presets["sharded_multihost"]()
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model, **MODEL),
            train=dataclasses.replace(cfg.train, **dict(TRAIN, **train)),
            mesh=dataclasses.replace(cfg.mesh, data=S, model=1)))
    return out


@pytest.fixture(scope="module")
def world(synth_dir):
    jdata = JData(synth_dir, mm_emb_ids=("81",))
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    loader = JLoader(JSampler(jdata, jschema, MODEL["maxlen"]),
                     np.arange(len(jdata.seq)), B, seed=1, num_workers=2)
    return dict(
        jdata=jdata, jschema=jschema, schema=schema, data=data,
        jtab=jbuild(jdata.item_feat_dict, jdata.itemnum, jschema,
                    jdata.mm_emb_dict, jdata.indexer_i_rev),
        tab=build_item_tables(data.item_feat_dict, data.itemnum, schema,
                              data.mm_emb_dict, data.indexer_i_rev),
        raw=next(iter(loader.epoch(1))),
        mesh=JM.build_mesh(JMesh(data=S)))


def _models(w, jcfg, cfg):
    jm = JModel(cfg=jcfg.model, schema=w["jschema"],
                fused=JFused.build(w["jschema"]), usernum=w["jdata"].usernum,
                itemnum=w["jdata"].itemnum)
    m = SeqRecModel(cfg=cfg.model, schema=w["schema"],
                    fused=FusedVocab.build(w["schema"]),
                    usernum=w["data"].usernum, itemnum=w["data"].itemnum)
    return jm, m


def _prep(TR, w, cfg, model, tab, shards):
    key = (cfg.train.seed, 97, 1, 0)
    b = dict(w["raw"])
    if cfg.train.tower_dedup:
        b = TR.augment_batch_dedup(b, cfg, tab, model.itemnum, step_key=key,
                                   n_data_shards=shards)
    return TR.augment_batch_sparse(b, cfg, model.itemnum, key,
                                   n_table_shards=shards,
                                   usernum=model.usernum)


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_mesh_steps(w, jcfg, jm, batch, steps):
    """The JAX package's sharded step from its init_sharded_state: its
    unpadded initial parameters, and per step the loss, parameters and
    table optimizer state (numpy)."""
    mesh = w["mesh"]
    state, tx = JPT.init_sharded_state(jm, jcfg, mesh)
    template = jm.init(jax.random.key(jcfg.train.seed))
    params0 = jax.tree.map(np.asarray, JPT.unpad_state(
        state, template).params)
    tables = JPT.shard_tables(mesh, JTR.device_tables(w["jtab"]))
    step = JPT.make_sharded_train_step(jm, tx, jcfg, mesh)
    out = []
    for _ in range(steps):
        state, m = step(state, JPT.shard_batch(mesh, batch), tables["mm"],
                        tables, jax.random.key(23))
        out.append((float(m["loss"]), _leaves(state.params),
                    _leaves(state.opt_state["tables"]),
                    {k: float(m[k]) for k in ("grad_max", "grad_mean")}))
    return params0, out


def _port_mesh_steps(w, cfg, m, params, batch, steps, mesh):
    state = TTR.init_state(m, cfg, params=params)
    if mesh is not None:
        state = TPT.shard_existing_state(mesh, state)
    tabs = TTR.device_tables(w["tab"], "cpu")
    step = TTR.make_train_step(m, cfg, mesh)
    out = []
    for _ in range(steps):
        state, met = step(state, TTR.put_batch(batch, "cpu"), tabs["mm"],
                          tabs)
        out.append((float(met["loss"]),
                    {p: t.detach().float().clone()
                     for p, t in TTR.param_leaves(state.params)},
                    {f"{n}/{k}": v.float().clone()
                     for n, o in state.tables.items() for k, v in o.items()},
                    met))
    return out


def _close(got, want, rtol, atol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = want.reshape(-1, *got.shape[1:]) if got.ndim > 1 else want
    n = want.shape[0]
    # the port's rows past the JAX leaf's are shard padding: zero
    assert not got[n:].any(), what
    np.testing.assert_allclose(got[:n], want[:got.shape[0]], rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the host plans
# ---------------------------------------------------------------------------

def _plan_inputs():
    V, R = 64 * 32, 16
    yield np.array([0, 5, 511, 512, 513, 1030, 2000, V, V, V], np.int64), \
        V, R, 4, 1.0
    rng = np.random.default_rng(4)
    for shards in (2, 4, 8):
        u = np.unique(rng.integers(0, V, 300))
        uids = np.full(512, V, np.int64)
        uids[:len(u)] = u
        yield uids, V, R, shards, 1.35


@pytest.mark.parametrize("case", range(4))
def test_host_shard_plan_bitwise_equal_to_jax(case):
    uids, V, R, shards, slack = list(_plan_inputs())[case]
    cap = TST.shard_capacity(len(uids), shards, slack=slack)
    assert cap == JST.shard_capacity(len(uids), shards, slack=slack)
    want = JST.host_shard_plan(uids, V, R, shards, cap)
    got = TST.host_shard_plan(uids, V, R, shards, cap)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rows = TST.host_shard_plan(uids, V, None, shards, cap)
    assert set(rows) == {"lids", "gpos", "pos"}
    for k in rows:
        np.testing.assert_array_equal(rows[k], want[k], err_msg=k)


@pytest.mark.parametrize("cap,shards", [(5, 1), (1000, 3), (5000, 8),
                                        (0, 4)])
def test_shard_capacity_equal_to_jax(cap, shards):
    for slack in (1.0, 1.35, 2.0):
        assert TST.shard_capacity(cap, shards, slack) == \
            JST.shard_capacity(cap, shards, slack)


def test_shard_plan_overflow_raises_as_jax():
    V, R = 64 * 32, 16
    uids = np.arange(1025, dtype=np.int64)
    msgs = []
    for mod in (JST, TST):
        with pytest.raises(ValueError, match="train.sparse_shard_slack") as e:
            mod.host_shard_plan(uids, V, R, 1, 1024)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_sharded_prep_emits_the_shard_plan(world):
    """augment_batch_sparse(n_table_shards=8): the JAX prep's per-shard plan
    of a packed table, bitwise; a table below packed scale pads to a
    multiple of 8 rows, its sentinel, with the row plan."""
    jcfg, cfg = _cfgs()
    jm, m = _models(world, jcfg, cfg)
    tb = _prep(TTR, world, cfg, m, world["tab"], S)
    V8 = S * -(-(m.itemnum + 1) // S)
    assert tb["touched_uids"].max() == V8
    assert {"tshard_lids", "tshard_gpos", "tshard_pos"} <= set(tb)
    assert "tshard_groups" not in tb and "scatter_groups" not in tb
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JST, "TABLE_PACK_MIN_ROWS", 1)
        mp.setattr(TST, "TABLE_PACK_MIN_ROWS", 1)
        jb = _prep(JTR, world, jcfg, jm, world["jtab"], S)
        tb = _prep(TTR, world, cfg, m, world["tab"], S)
    for k in ("touched_uids", "tshard_lids", "tshard_gpos", "tshard_groups",
              "tshard_slot_src", "tshard_pos"):
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


# ---------------------------------------------------------------------------
# the sharded sparse steps
# ---------------------------------------------------------------------------

@requires_8
def test_packed_sharded_steps_match_jax_mesh(world, monkeypatch):
    monkeypatch.setattr(JST, "TABLE_PACK_MIN_ROWS", 1)
    monkeypatch.setattr(TST, "TABLE_PACK_MIN_ROWS", 1)
    jcfg, cfg = _cfgs(table_optimizer="rowwise_adagrad")
    jm, m = _models(world, jcfg, cfg)
    jb = _prep(JTR, world, jcfg, jm, world["jtab"], S)
    tb = _prep(TTR, world, cfg, m, world["tab"], S)
    params0, ref = _jax_mesh_steps(world, jcfg, jm, jb, 3)
    Vp = TST.padded_table_rows(m.itemnum + 1)
    assert tuple(params0["item_emb"].shape[1:]) == (8, 128)
    port = _port_mesh_steps(world, cfg, m, params_from_jax(params0), tb, 3,
                            local_mesh(MeshConfig(data=S)))
    np.testing.assert_allclose([p[0] for p in port], [r[0] for r in ref],
                               rtol=1e-5)
    _, params, topt, _ = ref[-1]
    got = port[-1][1]["item_emb"]
    assert tuple(got.shape) == (Vp, MODEL["hidden_units"])   # no shard pad
    _close(got, params["item_emb"], 1e-5, 1e-6, "item_emb")
    _close(port[-1][2]["item_emb/acc"], topt["item_emb/acc"], 1e-5, 1e-7,
           "acc")


@requires_8
def test_unpacked_lazy_adam_sharded_step_matches_jax_mesh(world):
    jcfg, cfg = _cfgs(table_optimizer="lazy_adam")
    jm, m = _models(world, jcfg, cfg)
    jb = _prep(JTR, world, jcfg, jm, world["jtab"], S)
    tb = _prep(TTR, world, cfg, m, world["tab"], S)
    params0, ref = _jax_mesh_steps(world, jcfg, jm, jb, 2)
    port = _port_mesh_steps(world, cfg, m, params_from_jax(params0), tb, 2,
                            local_mesh(MeshConfig(data=S)))
    np.testing.assert_allclose([p[0] for p in port], [r[0] for r in ref],
                               rtol=1e-5)
    # the gradient metrics over the padded row-sharded leaves, as JAX's
    for p, r in zip(port, ref):
        for k, v in r[3].items():
            np.testing.assert_allclose(float(p[3][k]), v, rtol=1e-4,
                                       err_msg=k)
    _, params, topt, _ = ref[-1]
    _close(port[-1][1]["item_emb"], params["item_emb"], 1e-5, 1e-6,
           "item_emb")
    for k in ("mu", "nu"):
        _close(port[-1][2][f"item_emb/{k}"], topt[f"item_emb/{k}"], 1e-5,
               1e-7, k)


@requires_8
def test_stacked_dedup_with_sparse_table_matches_jax_mesh(world):
    jcfg, cfg = _cfgs(tower_dedup=True, loss_type="sampled_softmax",
                      table_optimizer="rowwise_adagrad")
    jm, m = _models(world, jcfg, cfg)
    jb = _prep(JTR, world, jcfg, jm, world["jtab"], S)
    tb = _prep(TTR, world, cfg, m, world["tab"], S)
    assert tb["dedup_uids"].shape[0] == S and "dedup" in tb["sparse_plans"]
    params0, ref = _jax_mesh_steps(world, jcfg, jm, jb, 1)
    port = _port_mesh_steps(world, cfg, m, params_from_jax(params0), tb, 1,
                            local_mesh(MeshConfig(data=S)))
    np.testing.assert_allclose(port[0][0], ref[0][0], rtol=1e-5)
    _close(port[0][1]["item_emb"], ref[0][1]["item_emb"], 2e-3, 2e-5,
           "item_emb")


def test_dense_data_mesh_step_takes_the_a2a(world, monkeypatch):
    """BCE with dense tables on a local data mesh of 8: the item-id lookups
    take the all-to-all, no id overflows, and the loss is the single
    device's."""
    jcfg, cfg = _cfgs(sparse_tables=())
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, lr=1e-2))
    _, m = _models(world, jcfg, cfg)
    params = m.init(torch.Generator().manual_seed(3))
    batch = dict(world["raw"])
    calls = []
    real = TSE.sharded_lookup_a2a

    def spy(*a, **k):
        calls.append(a[2].shape)
        return real(*a, **k)

    import tencent_recommendation_2025_tpu_torch.models.baseline as TB

    monkeypatch.setattr(TB, "sharded_lookup_a2a", spy)
    one = _port_mesh_steps(world, cfg, m, params, batch, 1, None)
    assert not calls
    mesh = _port_mesh_steps(world, cfg, m, params, batch, 1,
                            local_mesh(MeshConfig(data=S)))
    # the sequence, the final positives and the negatives of 8 shards
    assert len(calls) == 3 * S
    assert int(mesh[0][3]["ep_overflow"]) == 0
    assert "ep_overflow" not in one[0][3]
    np.testing.assert_allclose(mesh[0][0], one[0][0], rtol=2e-5)


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def epoch(self, e):
        return iter(self.batches)


def test_train_loop_writes_ep_overflow(world, monkeypatch, capsys):
    """train_loop on a local data mesh of 8 with dense tables writes
    Tables/ep_overflow each step and prints the JAX loop's warning where it
    is above 0 (the a2a's capacity factor cut to 1/4 here, so that ids
    overflow)."""
    import tencent_recommendation_2025_tpu_torch.models.baseline as TB
    from tencent_recommendation_2025_tpu_torch.train import telemetry as TT

    real = TSE.sharded_lookup_a2a
    monkeypatch.setattr(TB, "sharded_lookup_a2a", lambda *a, **k: real(
        *a, capacity_factor=0.25, **k))

    jcfg, cfg = _cfgs(sparse_tables=())
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, log_every=1))
    _, m = _models(world, jcfg, cfg)
    kept = {}

    class Scalars:
        def __init__(self, log_dir):
            pass

        def scalar(self, tag, value, step):
            kept.setdefault(tag, []).append(value)

        def close(self):
            pass

    monkeypatch.setattr(TT, "TBWriter", Scalars)
    TTR.train_loop(m, cfg, _Loader([world["raw"]] * 2), None, world["tab"],
                   num_epochs=1, mesh=local_mesh(MeshConfig(data=S)),
                   device="cpu")
    got = kept["Tables/ep_overflow"]
    assert len(got) == 2 and all(v >= 0 for v in got)
    out = capsys.readouterr().out
    for step, v in enumerate(got, start=1):
        warned = f"WARNING step {step}: {v} ids overflowed their a2a " \
            "shard bucket" in out
        assert warned == (v > 0)
    assert max(got) > 0
