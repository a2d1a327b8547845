"""Data parallelism in one process: the port's local mesh of 8 data shards
(tencent_recommendation_2025_tpu_torch/parallel/, train/trainer.py) against
the JAX package's sharded step on the 8 fake CPU devices of conftest.py, in
f32 with dropout off, at the JAX package's tolerances (loss rtol 2e-5,
gradients rtol 2e-3 / atol 2e-5: tests/test_parallel.py:188,
tests/test_tower_dedup.py:178; parameters after a step rtol 1e-5 / atol
1e-6: tests/test_grad_accum.py:96).

- One step of hstu_flagship cut to D=32, 2 blocks, L=32, batch 16 (2 rows a
  shard), BCE and the sampled softmax with 8 in-batch negatives, tower
  dedup off and on (the stacked [8, cap] plan): the port's step from the
  JAX ``init_sharded_state`` parameters (``unpad_state``, bridged) against
  JAX's ``make_sharded_train_step`` (its loss) and the gradients of its
  loss on the mesh. The in-batch candidates take JAX's draw (torch cannot
  reproduce jax.random). The JAX step's dense-table lookups take XLA's SPMD
  gather, as tests/test_parallel.py:188's do, and the port's its sharded
  gather (``sharded_lookup``): the explicit all-to-all (``_ep_override``)
  has static buckets that overflow at the fixture's 100 items (ids returned
  as zeros), which would make the reference inexact; the all-to-all is
  held to JAX's in tests/test_torch_sharded_embedding.py. The port's
  tables are row-sharded, padded to the 8 shards: their gradients are
  compared at the real rows, the pad rows' zero.
- ``shard_batch``: each data shard's rows those JAX places on its device.
- The stacked plan's arrays bitwise equal to JAX ``augment_batch_dedup(
  n_data_shards=8)``'s; under the sampled softmax no ``negs`` plan.
- G=2 on the data mesh equal to G=1 and to JAX.
- The local mesh's global loss: the sampled softmax's draws on 4 data
  shards, and on 2 data x 2 seq shards, equal the single device's.
- ``analytic_step_flops`` equal to JAX's for every preset, dedup on and off,
  1 and 8 data shards; ``device_peak_flops`` None on the CPU and
  ``Performance/mfu`` written exactly where a peak is known."""

import dataclasses

import jax
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
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.ops import losses as TLS
from tencent_recommendation_2025_tpu_torch.parallel import train as TPT
from tencent_recommendation_2025_tpu_torch.parallel.mesh import local_mesh
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)

requires_8 = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 fake devices")

S, B = 8, 16
MODEL = dict(hidden_units=32, num_blocks=2, maxlen=31, dropout_rate=0.0,
             dtype="float32")
TRAIN = dict(batch_size=B, tower_dedup=False, lr=1e-2)
SOFTMAX = dict(loss_type="sampled_softmax", num_sampled_negatives=16,
               num_inbatch_negatives=8)
KEY = 7                       # the JAX step's key
NEG_KEY = (0, 97, 1, 0)       # the host prep's key of the shared negatives


def _cfg(presets, loss, dedup, G=1):
    cfg = presets["hstu_flagship"]()
    train = dict(TRAIN, tower_dedup=dedup, grad_accum_steps=G,
                 **(SOFTMAX if loss == "softmax" else {}))
    return cfg.replace(model=dataclasses.replace(cfg.model, **MODEL),
                       train=dataclasses.replace(cfg.train, **train),
                       mesh=dataclasses.replace(cfg.mesh, data=S))


@pytest.fixture(autouse=True)
def _spmd_gather(monkeypatch):
    """Both packages' item-id lookups by the sharded gather, not the
    all-to-all, whose buckets overflow at the fixture's 100 items."""
    monkeypatch.setattr(JModel, "_ep_override", lambda *a: None)
    monkeypatch.setattr(SeqRecModel, "_ep_override", lambda *a, **k: None)


@pytest.fixture(scope="module")
def world(synth_dir):
    jdata = JData(synth_dir, mm_emb_ids=("81",))
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    from tencent_recommendation_2025_tpu.data.featurizer import \
        build_item_tables as jbuild

    jtab = jbuild(jdata.item_feat_dict, jdata.itemnum, jschema,
                  jdata.mm_emb_dict, jdata.indexer_i_rev)
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    tab = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                            data.mm_emb_dict, data.indexer_i_rev)
    cfg = _cfg(PRESETS, "bce", False)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    batch = next(iter(TrainLoader(sampler, np.arange(len(sampler)), B,
                                  seed=1).epoch(1)))
    return dict(jdata=jdata, jschema=jschema, jtab=jtab, data=data,
                schema=schema, tab=tab, batch=batch,
                mesh=JM.build_mesh(JMesh(data=S)))


def _models(w, jcfg, cfg):
    jmodel = JModel(cfg=jcfg.model, schema=w["jschema"],
                    fused=JFused.build(w["jschema"]),
                    usernum=w["jdata"].usernum, itemnum=w["jdata"].itemnum)
    model = SeqRecModel(cfg=cfg.model, schema=w["schema"],
                        fused=FusedVocab.build(w["schema"]),
                        usernum=w["data"].usernum, itemnum=w["data"].itemnum)
    return jmodel, model


def _batches(w, loss, dedup, jmodel, jcfg, cfg):
    """(JAX batch, port batch): the shared negatives from the host prep's
    key, and with dedup each package's own stacked prep."""
    jb, tb = dict(w["batch"]), dict(w["batch"])
    if loss == "softmax":
        neg = TTR._sample_negatives(cfg, jmodel.itemnum, NEG_KEY)
        jb["sampled_neg_ids"] = tb["sampled_neg_ids"] = neg
    if dedup:
        jb = JTR.augment_batch_dedup(jb, jcfg, w["jtab"], jmodel.itemnum,
                                     step_key=NEG_KEY, n_data_shards=S)
        tb = TTR.augment_batch_dedup(tb, cfg, w["tab"], jmodel.itemnum,
                                     step_key=NEG_KEY, n_data_shards=S)
    return jb, tb


def _path(kp):
    return "/".join(str(k.key) for k in kp)


_JAX_STEPS = {}


def _jax_step(w, jmodel, jcfg, jbatch, case):
    """The JAX sharded step from its init_sharded_state on the 8-device
    data mesh: (its unpadded initial parameters, its loss, the gradients of
    that loss, their in-batch draw's indices); once per ``case``."""
    if case not in _JAX_STEPS:
        _JAX_STEPS[case] = _run_jax_step(w, jmodel, jcfg, jbatch)
    return _JAX_STEPS[case]


def _run_jax_step(w, jmodel, jcfg, jbatch):
    mesh = w["mesh"]
    state, tx = JPT.init_sharded_state(jmodel, jcfg, mesh)
    template = jmodel.init(jax.random.key(jcfg.train.seed))
    params0 = jax.tree.map(np.asarray,
                           JPT.unpad_state(state, template).params)
    tables = JPT.shard_tables(mesh, JTR.device_tables(w["jtab"]))
    bsh = JPT.shard_batch(mesh, jbatch)
    key = jax.random.key(KEY)
    rng = jax.random.fold_in(key, 0)

    def loss_fn(p):
        return JTR.compute_loss(jmodel, p, bsh, tables["mm"], tables, jcfg,
                                train=True, rng=rng, mesh=mesh)[0]

    _, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    grads = {_path(kp): np.asarray(v) for kp, v in
             jax.tree_util.tree_leaves_with_path(
                 JP.unpad_like(grads, template))}
    step = JPT.make_sharded_train_step(jmodel, tx, jcfg, mesh)
    _, m = step(state, bsh, tables["mm"], tables, key)
    assert int(m.get("ep_overflow", 0)) == 0
    n = jcfg.train.num_inbatch_negatives
    idx = None
    if jcfg.train.loss_type == "sampled_softmax" and n > 0:
        inb = jax.random.split(rng, 3)[2]
        idx = np.asarray(jax.random.randint(inb, (n,), 0,
                                            jbatch["pos"].size))
    return params0, float(m["loss"]), grads, idx


def _port_step(model, cfg, params, batch, tab, mesh, idx=None):
    """The port's step on ``mesh`` from ``params``: (state after, loss,
    gradients by leaf); the in-batch draw replaced by ``idx``."""
    state = TPT.shard_existing_state(
        mesh, TTR.init_state(model, cfg, params=params)) \
        if mesh is not None else TTR.init_state(model, cfg, params=params)
    tabs = TTR.device_tables(tab, "cpu")
    saved = TLS.inbatch_draw
    if idx is not None:
        TLS.inbatch_draw = lambda n, total, gen, dev: torch.tensor(idx)
    try:
        step = TPT.make_sharded_train_step(model, cfg, mesh) \
            if mesh is not None else TTR.make_train_step(model, cfg)
        state, m = step(state, TTR.put_batch(batch, "cpu"), tabs["mm"],
                        tabs)
    finally:
        TLS.inbatch_draw = saved
    grads = {p: t.grad.clone() for p, t in TTR.param_leaves(state.params)}
    return state, float(m["loss"]), grads


def _rows_of(g, rows):
    """A row-sharded table's gradient, padded to the data shards, at the
    table's ``rows``: its pad rows take none."""
    if g.shape[0] > rows:
        assert not g[rows:].any()
        g = g[:rows]
    return g


def _check_grads(grads, ref):
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(_rows_of(g, ref[name].shape[0]).numpy(),
                                   ref[name], rtol=2e-3, atol=2e-5,
                                   err_msg=name)


@requires_8
@pytest.mark.parametrize("dedup", [False, True], ids=["dense", "dedup"])
@pytest.mark.parametrize("loss", ["bce", "softmax"])
def test_local_data_mesh_step_matches_jax_sharded_step(world, loss, dedup):
    jcfg, cfg = _cfg(JPRESETS, loss, dedup), _cfg(PRESETS, loss, dedup)
    jmodel, model = _models(world, jcfg, cfg)
    jb, tb = _batches(world, loss, dedup, jmodel, jcfg, cfg)
    params0, jloss, jgrads, idx = _jax_step(world, jmodel, jcfg, jb,
                                            (loss, dedup))
    mesh = local_mesh(MeshConfig(data=S))
    state, tloss, grads = _port_step(model, cfg, params_from_jax(params0),
                                     tb, world["tab"], mesh, idx)
    np.testing.assert_allclose(tloss, jloss, rtol=2e-5)
    _check_grads(grads, jgrads)
    assert state.step == 1


@requires_8
def test_shard_batch_takes_the_rows_jax_places_on_each_device(world):
    """parallel.train.shard_batch: data shard d's rows are the block the
    JAX package's batch sharding puts on device d of the data mesh; the
    shared negatives stay whole."""
    batch = dict(world["batch"], sampled_neg_ids=np.arange(
        1, B + 1, dtype=np.int32))
    placed = JPT.shard_batch(world["mesh"], batch)
    mesh = local_mesh(MeshConfig(data=S))
    tb = TTR.put_batch(batch, "cpu")
    for k in ("seq", "pos", "token_type", "sample_valid"):
        seen = set()
        for shard in placed[k].addressable_shards:
            rows = shard.index[0]
            d = rows.start // (B // S)
            got = TPT.shard_batch(mesh, tb, d)
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(shard.data), err_msg=k)
            assert torch.equal(got["sampled_neg_ids"],
                               tb["sampled_neg_ids"])
            seen.add(d)
        assert seen == set(range(S))


@pytest.mark.parametrize("loss", ["bce", "softmax"])
def test_stacked_dedup_plan_matches_jax(world, loss):
    """augment_batch_dedup(n_data_shards=8): every array bitwise equal to
    the JAX prep's; [8, cap] ids at the per-shard capacity; under the
    sampled softmax no negs plan (the shared negatives tower directly)."""
    jcfg, cfg = _cfg(JPRESETS, loss, True), _cfg(PRESETS, loss, True)
    jmodel, _ = _models(world, jcfg, cfg)
    jb, tb = _batches(world, loss, True, jmodel, jcfg, cfg)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]),
                                      err_msg=k)
    cap = TTR.tower_dedup_capacity(cfg, jmodel.itemnum, S)
    assert cap == JTR.tower_dedup_capacity(jcfg, jmodel.itemnum, S)
    assert tb["dedup_uids"].shape == (S, cap)
    assert ("dedup_negs_idx" in tb) == (loss == "bce")


@requires_8
def test_grad_accum_on_data_mesh_matches_g1_and_jax(world):
    """G=2 on the local data mesh: each microbatch (strided rows) split in
    blocks over the 8 shards, one row each. Its loss and gradients equal
    JAX's whole-batch ones (BCE, no draw: the same at any G) and G=1's;
    ``itemdnn/w`` after the step equals G=1's at the JAX test's tolerance
    (tests/test_grad_accum.py:96 holds that leaf: Adam's first step divides
    each gradient by its own magnitude, so an element whose gradient sums to
    a few ulps moves by a part of lr)."""
    jcfg, cfg = _cfg(JPRESETS, "bce", False), _cfg(PRESETS, "bce", False)
    jmodel, model = _models(world, jcfg, cfg)
    jb, tb = _batches(world, "bce", False, jmodel, jcfg, cfg)
    params0, jloss, jgrads, _ = _jax_step(world, jmodel, jcfg, jb,
                                          ("bce", False))
    params = params_from_jax(params0)
    mesh = local_mesh(MeshConfig(data=S))
    s1, l1, g1 = _port_step(model, cfg, params, tb, world["tab"], mesh)
    cfg2 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                 grad_accum_steps=2))
    s2, l2, g2 = _port_step(model, cfg2, params, tb, world["tab"], mesh)
    assert l2 == pytest.approx(l1, rel=1e-5)
    np.testing.assert_allclose(l2, jloss, rtol=2e-5)
    _check_grads(g2, jgrads)
    for name, g in g2.items():
        ref = g1[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)
    np.testing.assert_allclose(s2.params["itemdnn"]["w"].detach().numpy(),
                               s1.params["itemdnn"]["w"].detach().numpy(),
                               rtol=1e-5, atol=1e-6)


_LOCAL = {"data4": (dict(data=4), False), "data4-dedup": (dict(data=4), True),
          "data2xseq2": (dict(data=2, seq=2), False)}


@pytest.mark.parametrize("case", sorted(_LOCAL))
def test_local_data_mesh_is_the_global_step(world, case):
    """A local mesh (4 data shards of 4 rows, with and without the stacked
    plan; 2 of 8 rows, each through a ring of 2 seq shards) against the
    single device, the sampled softmax's own draws (shared negatives and
    in-batch candidates from the step's generator, the same on every
    shard): the same loss and gradients; the loss and n_mask are the
    global batch's."""
    shape, dedup = _LOCAL[case]
    cfg = _cfg(PRESETS, "softmax", dedup)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, num_inbatch_negatives=16))
    _, model = _models(world, _cfg(JPRESETS, "softmax", False), cfg)
    params = model.init(torch.Generator().manual_seed(3))
    one = four = dict(world["batch"])
    if dedup:
        one = TTR.augment_batch_dedup(one, cfg, world["tab"], model.itemnum,
                                      step_key=NEG_KEY)
        four = TTR.augment_batch_dedup(four, cfg, world["tab"],
                                       model.itemnum, step_key=NEG_KEY,
                                       n_data_shards=shape["data"])
    s1, l1, g1 = _port_step(model, cfg, params, one, world["tab"], None)
    s4, l4, g4 = _port_step(model, cfg, params, four, world["tab"],
                            local_mesh(MeshConfig(**shape)))
    assert l4 == pytest.approx(l1, rel=1e-6)
    for name in g1:
        np.testing.assert_allclose(
            _rows_of(g4[name], g1[name].shape[0]).numpy(), g1[name].numpy(),
            rtol=1e-4, atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# analytic FLOPs and the mfu scalar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_analytic_step_flops_matches_jax(world, preset, dedup, shards):
    jcfg, cfg = JPRESETS[preset](), PRESETS[preset]()
    jmodel, model = _models(world, jcfg, cfg)
    want = JTR.analytic_step_flops(jcfg, jmodel, tower_dedup=dedup,
                                   n_data_shards=shards)
    got = TTR.analytic_step_flops(cfg, model, tower_dedup=dedup,
                                  n_data_shards=shards)
    assert got == want and got > 0


def test_mfu_scalar_only_where_a_peak_is_known(world, monkeypatch):
    """On the CPU there is no peak and no Performance/mfu; where the card's
    peak is known (stood in for here) the scalar is the analytic FLOPs
    over the step time and the peak."""
    assert TTR.device_peak_flops("cpu") is None
    assert TTR.device_peak_flops("cuda", "float32") is None
    cfg = _cfg(PRESETS, "bce", False)
    _, model = _models(world, _cfg(JPRESETS, "bce", False), cfg)
    seen = {}

    class Writer:
        def __init__(self, d):
            pass

        def scalar(self, tag, value, step):
            seen.setdefault(tag, []).append(value)

        def close(self):
            pass

    class Loader:
        def __len__(self):
            return 2

        def epoch(self, e):
            return iter([world["batch"]] * 2)

    monkeypatch.setattr(TTR.T, "TBWriter", Writer)
    TTR.train_loop(model, cfg, Loader(), None, world["tab"], num_epochs=1,
                   verbose=False, device="cpu")
    assert "Performance/step_time" in seen and "Performance/mfu" not in seen
    seen.clear()
    monkeypatch.setattr(TTR, "device_peak_flops", lambda dev, dt: 1e12)
    TTR.train_loop(model, cfg, Loader(), None, world["tab"], num_epochs=1,
                   verbose=False, device="cpu")
    flops = TTR.analytic_step_flops(cfg, model, tower_dedup=False)
    want = [flops / t / 1e12 for t in seen["Performance/step_time"]]
    np.testing.assert_allclose(seen["Performance/mfu"], want, rtol=1e-12)
