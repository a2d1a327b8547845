"""The port's sparse-table training step (tencent_recommendation_2025_tpu_torch/
train/trainer.py) against the JAX package's ``augment_batch_sparse`` +
``make_train_step`` on the CPU, from the same bridged parameters and batches:
``sharded_multihost`` cut to D=32, 2 blocks, --maxlen 31 (L=32), batch 4,
dropout off, single device, with each table optimizer, BCE and the sampled
softmax (host-sampled negatives), tower dedup on and off, ``user_emb``
sparse too, and the packed-scale twin (``TABLE_PACK_MIN_ROWS`` patched to 1
in both packages), whose group write-back takes the plain version of the
group-scatter kernel here. Tolerances: the loss at rtol 1e-4; gradients,
tables and the table optimizer state at rtol 2e-4, atol 2e-5 times the
largest magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from tencent_recommendation_2025_tpu.train import trainer as JTR
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.config import PRESETS
from tencent_recommendation_2025_tpu_torch.data.featurizer import (
    FusedVocab, build_item_tables)
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.ops import sparse_table as TST
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)

MODEL = dict(hidden_units=32, num_blocks=2, maxlen=31, dropout_rate=0.0,
             dtype="float32")
TRAIN = dict(batch_size=4)
BCE = dict(loss_type="bce", l2_emb=1e-3)
CASES = {
    "adagrad-softmax-dedup": {},          # the preset as it is
    "adam-softmax": dict(table_optimizer="lazy_adam", tower_dedup=False),
    "adagrad-bce-dedup-user": dict(sparse_tables=("item_emb", "user_emb"),
                                   **BCE),
    "adam-bce": dict(table_optimizer="lazy_adam", tower_dedup=False, **BCE),
}


def _cfgs(model=None, **train):
    out = []
    for presets in (JPRESETS, PRESETS):
        cfg = presets["sharded_multihost"]()
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model, **dict(MODEL, **(model or
                                                                  {}))),
            train=dataclasses.replace(cfg.train, **dict(TRAIN, **train))))
    return out


@pytest.fixture(scope="module")
def world(synth_dir):
    jdata = JData(synth_dir, mm_emb_ids=("81",))
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    loader = JLoader(JSampler(jdata, jschema, MODEL["maxlen"]),
                     np.arange(len(jdata.seq)), 4, seed=1, num_workers=2)
    return dict(
        jdata=jdata, jschema=jschema, schema=schema, data=data,
        jtab=jbuild(jdata.item_feat_dict, jdata.itemnum, jschema,
                    jdata.mm_emb_dict, jdata.indexer_i_rev),
        tab=build_item_tables(data.item_feat_dict, data.itemnum, schema,
                              data.mm_emb_dict, data.indexer_i_rev),
        raw=[b for _, b in zip(range(3), loader.epoch(1))])


def _models(w, jcfg, cfg):
    jm = JModel(cfg=jcfg.model, schema=w["jschema"],
                fused=JFused.build(w["jschema"]), usernum=w["jdata"].usernum,
                itemnum=w["jdata"].itemnum)
    m = SeqRecModel(cfg=cfg.model, schema=w["schema"],
                    fused=FusedVocab.build(w["schema"]),
                    usernum=w["data"].usernum, itemnum=w["data"].itemnum)
    return jm, m


def _prep(TR, w, cfg, model, tab):
    """The train loop's host prep of each raw batch: dedup first, then the
    sparse prep, keyed (seed, 97, epoch, batch index)."""
    out = []
    for i, b in enumerate(w["raw"]):
        key = (cfg.train.seed, 97, 1, i)
        if cfg.train.tower_dedup:
            b = TR.augment_batch_dedup(b, cfg, tab, model.itemnum,
                                       step_key=key)
        out.append(TR.augment_batch_sparse(b, cfg, model.itemnum, key,
                                           usernum=model.usernum))
    return out


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_sparse_grads(jm, jcfg, params, batch, dtab):
    """The JAX sparse step's loss and dense gradients (its own gather and
    GatheredRows loss, differentiated as the step does)."""
    batch = dict(jax.device_put(batch))
    D = jcfg.model.hidden_units
    sparse = jcfg.train.sparse_tables
    rows_map, meta = {}, {}
    for name in sparse:
        sfx = JTR._sfx(name)
        plans = batch.pop("sparse_plans" + sfx)
        uids = batch.pop("touched_uids" + sfx)
        if "scatter_groups" + sfx in batch:
            plan = {k: batch.pop(f"scatter_{k}{sfx}")
                    for k in ("groups", "slot_src", "uid_pos")}
            rows = JST.gather_rows_grouped(params[name], uids, plan, D)[0].rows
        else:
            rows = JST.gather_rows(params[name], uids, dim=D).rows
        rows_map[name], meta[name] = rows, (uids, plans)
    dense = {k: v for k, v in params.items() if k not in sparse}

    def loss_fn(dense, rows_map):
        p = dict(dense)
        for name in sparse:
            p[name] = JST.GatheredRows(meta[name][0], rows_map[name],
                                       meta[name][1])
        return JTR.compute_loss(jm, p, batch, dtab["mm"], dtab, jcfg,
                                train=True, rng=jax.random.key(0))[0]

    loss, (grads, _) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        dense, rows_map)
    return float(loss), _leaves(grads)


def _jax_run(w, jcfg, jm, batches):
    """Bridged starting parameters (biases and LN params off their init),
    the JAX step-1 loss and dense gradients, and the loss, parameters and
    table optimizer state after each of the JAX package's steps."""
    tx = JTR.make_optimizer(jcfg)
    st = JTR.init_state(jm, tx, 3, cfg=jcfg)
    rng = np.random.default_rng(8)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.05,
                                        a.dtype)
        if str(path[-1].key) in ("b", "bias", "scale", "rab") else a,
        st.params)
    st = JTR.TrainState(jparams, st.opt_state, st.step)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    dtab = JTR.device_tables(w["jtab"])
    loss0, grads0 = _jax_sparse_grads(jm, jcfg, jparams, batches[0], dtab)
    step = JTR.make_train_step(jm, tx, jcfg)
    after = []
    for b in batches:
        st, m = step(st, jax.device_put(b), dtab["mm"], dtab,
                     jax.random.key(0))
        after.append((float(m["loss"]), _leaves(st.params),
                      _leaves(st.opt_state["tables"])))
    return params, loss0, grads0, after


def _port_run(w, cfg, model, params, batches):
    state = TTR.init_state(model, cfg, params=params)
    tabs = TTR.device_tables(w["tab"], "cpu")
    step = TTR.make_train_step(model, cfg)
    out = []
    for b in batches:
        state, m = step(state, TTR.put_batch(b, "cpu"), tabs["mm"], tabs)
        out.append((float(m["loss"]), int(m["touched_rows"]),
                    {p: t.grad.clone()
                     for p, t in TTR.dense_leaves(state.params, cfg)},
                    {p: t.detach().float().clone()
                     for p, t in TTR.param_leaves(state.params)},
                    {f"{n}/{k}": v.float().clone()
                     for n, o in state.tables.items() for k, v in o.items()}))
    return out


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    atol = 2e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=2e-4,
                               atol=atol, err_msg=what)


def _check_against_jax(port, jax_ref, sparse):
    _, loss0, grads0, after = jax_ref
    np.testing.assert_allclose(port[0][0], loss0, rtol=1e-4)
    assert port[0][2].keys() == grads0.keys()
    for name, g in port[0][2].items():
        _close(g.numpy(), grads0[name], name)
    for i in (0, 2):             # after steps 1 and 3
        loss, params, topt = after[i]
        np.testing.assert_allclose(port[i][0], loss, rtol=1e-4)
        for name in sparse:
            _close(port[i][3][name].numpy(),
                   params[name].reshape(port[i][3][name].shape), name)
        assert port[i][4].keys() == topt.keys()
        for k, v in port[i][4].items():
            _close(v.numpy(), topt[k].reshape(v.shape), k)


@pytest.mark.parametrize("case", list(CASES))
def test_sparse_steps_match_jax(world, case):
    """Loss and dense gradients of step 1, then the loss, the sparse tables
    and their optimizer state after steps 1 and 3."""
    jcfg, cfg = _cfgs(**CASES[case])
    jm, m = _models(world, jcfg, cfg)
    jb = _prep(JTR, world, jcfg, jm, world["jtab"])
    tb = _prep(TTR, world, cfg, m, world["tab"])
    assert [sorted(b) for b in tb] == [sorted(b) for b in jb]
    ref = _jax_run(world, jcfg, jm, jb)
    port = _port_run(world, cfg, m, ref[0], tb)
    assert port[0][1] > 0
    _check_against_jax(port, ref, cfg.train.sparse_tables)


@pytest.mark.parametrize("table_dtype,opt", [("float32", "lazy_adam"),
                                             ("bfloat16", "rowwise_adagrad")])
def test_packed_twin_matches_unpacked_and_jax(world, monkeypatch,
                                              table_dtype, opt):
    """With TABLE_PACK_MIN_ROWS = 1 in both packages the item table pads to
    Vp rows and writes back whole groups; the port's packed step equals its
    unpacked step on the same rows, and the JAX packed step (a bf16 table to
    one bf16 step of the table's largest value: the rows' gradient rounds to
    bf16)."""
    orig = TST.TABLE_PACK_MIN_ROWS
    monkeypatch.setattr(JST, "TABLE_PACK_MIN_ROWS", 1)
    monkeypatch.setattr(TST, "TABLE_PACK_MIN_ROWS", 1)
    jcfg, cfg = _cfgs(model=dict(table_dtype=table_dtype),
                      table_optimizer=opt, tower_dedup=False, **BCE)
    jm, m = _models(world, jcfg, cfg)
    V = m.itemnum + 1
    Vp = TST.padded_table_rows(V)
    tb = _prep(TTR, world, cfg, m, world["tab"])
    assert "scatter_groups" in tb[0] and tb[0]["touched_uids"].max() == Vp
    ref = _jax_run(world, jcfg, jm, _prep(JTR, world, jcfg, jm,
                                          world["jtab"]))
    assert tuple(ref[0]["item_emb"].shape) == (Vp, MODEL["hidden_units"])
    assert not ref[0]["item_emb"][V:].any()
    packed = _port_run(world, cfg, m, ref[0], tb)
    if table_dtype == "float32":
        _check_against_jax(packed, ref, ("item_emb",))
    else:
        for i in (0, 2):
            want = ref[3][i][1]["item_emb"].reshape(Vp, -1)
            got = packed[i][3]["item_emb"].numpy()
            np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                       atol=2 ** -8 * np.abs(want).max())
            np.testing.assert_allclose(packed[i][0], ref[3][i][0], rtol=1e-4)
    monkeypatch.setattr(TST, "TABLE_PACK_MIN_ROWS", orig)
    params = dict(ref[0], item_emb=ref[0]["item_emb"][:V])
    unpacked = _port_run(world, cfg, m, params,
                         _prep(TTR, world, cfg, m, world["tab"]))
    for p, u in zip(packed, unpacked):
        np.testing.assert_allclose(p[0], u[0], rtol=1e-6)
        assert torch.equal(p[3]["item_emb"][:V], u[3]["item_emb"])
        assert not p[3]["item_emb"][V:].any()
        for k, v in u[4].items():
            assert torch.equal(p[4][k][:V], v), k


def test_packed_scale_table_must_train_sparsely(world, monkeypatch):
    monkeypatch.setattr(TST, "TABLE_PACK_MIN_ROWS", 1)
    _, cfg = _cfgs(sparse_tables=())
    _, m = _models(world, *_cfgs())
    with pytest.raises(ValueError, match="must train sparsely"):
        TTR.make_train_step(m, cfg)
    TTR.make_train_step(m, cfg.replace(model=dataclasses.replace(
        cfg.model, pack_big_tables=False)))


def test_packed_scale_raw_batch_raises(world, monkeypatch):
    """A packed-scale item table writes back only through its host group
    plan: a batch without one (the device-dedup fallback) is refused, not
    written row by row; the same batch after augment_batch_sparse trains."""
    monkeypatch.setattr(TST, "TABLE_PACK_MIN_ROWS", 1)
    _, cfg = _cfgs(**CASES["adam-bce"])
    _, m = _models(world, *_cfgs(**CASES["adam-bce"]))
    params = TTR.init_state(m, cfg, seed=3).params
    assert params["item_emb"].shape[0] == TST.padded_table_rows(m.itemnum + 1)
    with pytest.raises(ValueError, match="needs its host group plan"):
        _port_run(world, cfg, m, params, world["raw"][:1])
    out = _port_run(world, cfg, m, params,
                    _prep(TTR, world, cfg, m, world["tab"])[:1])
    assert out[0][1] > 0


def test_device_dedup_fallback_equals_host_prep(world):
    """A batch that ships no touched_uids dedups on the device
    (unique_touched, searchsorted lookups): the same step as the host prep's
    (the JAX package's host-versus-device case)."""
    _, cfg = _cfgs(**CASES["adam-bce"])
    _, m = _models(world, *_cfgs(**CASES["adam-bce"]))
    params = TTR.init_state(m, cfg, seed=3).params
    prepped = _prep(TTR, world, cfg, m, world["tab"])
    a = _port_run(world, cfg, m, params, prepped[:1])
    b = _port_run(world, cfg, m, params, world["raw"][:1])
    np.testing.assert_allclose(a[0][0], b[0][0], rtol=1e-6)
    assert a[0][1] == b[0][1]
    torch.testing.assert_close(a[0][3]["item_emb"], b[0][3]["item_emb"],
                               rtol=1e-6, atol=1e-7)
