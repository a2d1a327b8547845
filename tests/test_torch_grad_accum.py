"""Gradient accumulation in the port's train step (tencent_recommendation_
2025_tpu_torch/train/trainer.py, ``train.grad_accum_steps``): G strided
microbatches whose losses go backward weighted by their masked-position
counts give the whole batch's step, on the CPU in f32 with dropout off.

- The port's G = 2 and 4 against its G = 1, at the JAX package's own
  tolerances (tests/test_grad_accum.py: loss rel 1e-6, parameters rtol
  1e-5 / atol 1e-7), for BCE, the sampled softmax with N == B shared
  negatives, and the L2 penalty.
- The port's G = 2 step against the JAX G = 2 step from bridged parameters
  (hstu_flagship cut to D=16, 2 blocks, L=32, batch 4), through the dense
  route and the fused route's plain versions at B/G rows, at
  tests/test_torch_train.py's tolerances.
- The guards: sparse tables, tower dedup, microbatches that a data mesh
  cannot split."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import PRESETS as JPRESETS
from tencent_recommendation_2025_tpu.data.featurizer import \
    FusedVocab as JFused, build_item_tables as jbuild
from tencent_recommendation_2025_tpu.data.readers import TencentGRData as JData
from tencent_recommendation_2025_tpu.data.schema import FeatureSchema as JSch
from tencent_recommendation_2025_tpu.models.baseline import \
    SeqRecModel as JModel
from tencent_recommendation_2025_tpu.train import trainer as JTR
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.config import (
    PRESETS, Config, MeshConfig, ModelConfig, TrainConfig)
from tencent_recommendation_2025_tpu_torch.data.dataset import TrainSampler
from tencent_recommendation_2025_tpu_torch.data.featurizer import (
    FusedVocab, build_item_tables)
from tencent_recommendation_2025_tpu_torch.data.pipeline import (
    TrainLoader, train_val_split)
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models import encoder as TENC
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.parallel.mesh import local_mesh
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small(synth_dir):
    """The port's twin of conftest's small_setup (D=32, 2 blocks of 2
    heads, maxlen 20, batch 8) and the first batch of epoch 0."""
    cfg = Config(model=ModelConfig(hidden_units=32, num_blocks=2, num_heads=2,
                                   maxlen=20, dtype="float32"),
                 train=TrainConfig(batch_size=8, num_epochs=1))
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    tr, _ = train_val_split(len(sampler), 0.1, 0)
    batch = next(iter(TrainLoader(sampler, tr, 8, seed=0).epoch(0)))
    return dict(cfg=cfg, schema=schema, data=data, batch=batch,
                tables=build_item_tables(data.item_feat_dict, data.itemnum,
                                         schema, data.mm_emb_dict,
                                         data.indexer_i_rev))


def _cfg(small, **kw):
    base = small["cfg"]
    return base.replace(
        model=dataclasses.replace(base.model, dropout_rate=0.0),
        train=dataclasses.replace(base.train, lr=1e-2, weight_decay=0.0,
                                  **kw))


def _run(small, cfg, batch):
    model = SeqRecModel(cfg=cfg.model, schema=small["schema"],
                        fused=FusedVocab.build(small["schema"]),
                        usernum=small["data"].usernum,
                        itemnum=small["data"].itemnum)
    tabs = TTR.device_tables(small["tables"], "cpu")
    state = TTR.init_state(model, cfg, device="cpu")
    step = TTR.make_train_step(model, cfg)
    return step(state, TTR.put_batch(batch, "cpu"), tabs["mm"], tabs)


def _check_params(s1, s2):
    for (name, a), (_, b) in zip(TTR.param_leaves(s1.params),
                                 TTR.param_leaves(s2.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("loss_type", ["bce", "sampled_softmax"])
def test_accum_matches_monolithic(small, loss_type, G):
    kw = dict(loss_type=loss_type)
    batch = small["batch"]
    if loss_type == "sampled_softmax":
        # N == B: the shared negatives reach every microbatch whole (split
        # by key, not by shape)
        n = small["cfg"].train.batch_size
        kw["num_sampled_negatives"] = n
        batch = dict(batch,
                     sampled_neg_ids=np.arange(1, n + 1, dtype=np.int32))
    s1, m1 = _run(small, _cfg(small, grad_accum_steps=1, **kw), batch)
    sg, mg = _run(small, _cfg(small, grad_accum_steps=G, **kw), batch)
    assert float(m1["loss"]) == pytest.approx(float(mg["loss"]), rel=1e-6)
    assert float(mg["n_mask"]) == float(m1["n_mask"]) > 0
    assert s1.step == sg.step == 1
    _check_params(s1, sg)


def test_accum_with_l2_penalty_exact(small):
    """The L2 penalty is the same in every microbatch: the weighted combine
    gives it and its gradient exactly."""
    s1, m1 = _run(small, _cfg(small, grad_accum_steps=1, l2_emb=1e-3),
                  small["batch"])
    s4, m4 = _run(small, _cfg(small, grad_accum_steps=4, l2_emb=1e-3),
                  small["batch"])
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-6)
    np.testing.assert_allclose(s1.params["item_emb"].detach().numpy(),
                               s4.params["item_emb"].detach().numpy(),
                               rtol=1e-5, atol=1e-7)


def test_accum_batch_must_split(small):
    with pytest.raises(ValueError, match="microbatches"):
        _run(small, _cfg(small, grad_accum_steps=3), small["batch"])


# ---------------------------------------------------------------------------
# against the JAX G = 2 step
# ---------------------------------------------------------------------------

JMODEL = dict(hidden_units=16, num_blocks=2, maxlen=31, dropout_rate=0.0,
              dtype="float32")
JTRAIN = dict(batch_size=4, tower_dedup=False, grad_accum_steps=2)


def _flagship(presets):
    cfg = presets["hstu_flagship"]()
    return cfg.replace(model=dataclasses.replace(cfg.model, **JMODEL),
                       train=dataclasses.replace(cfg.train, **JTRAIN))


@pytest.fixture(scope="module")
def jax_world(synth_dir, small):
    jcfg, cfg = _flagship(JPRESETS), _flagship(PRESETS)
    jdata = JData(synth_dir, mm_emb_ids=("81",))
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    jtab = jbuild(jdata.item_feat_dict, jdata.itemnum, jschema,
                  jdata.mm_emb_dict, jdata.indexer_i_rev)
    jmodel = JModel(cfg=jcfg.model, schema=jschema,
                    fused=JFused.build(jschema), usernum=jdata.usernum,
                    itemnum=jdata.itemnum)
    data, schema = small["data"], small["schema"]
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    batch = next(iter(TrainLoader(sampler, np.arange(len(sampler)), 4,
                                  seed=1).epoch(1)))
    tx = JTR.make_optimizer(jcfg)
    jstate = JTR.init_state(jmodel, tx, 3, cfg=jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    dtab = JTR.device_tables(jtab)
    g1 = jcfg.replace(train=dataclasses.replace(jcfg.train,
                                                grad_accum_steps=1))

    def loss_fn(p):
        return JTR.compute_loss(jmodel, p, jax.device_put(batch), dtab["mm"],
                                dtab, g1, train=True,
                                rng=jax.random.key(0))[0]

    loss0, grads0 = jax.jit(jax.value_and_grad(loss_fn))(jstate.params)
    grads0 = {"/".join(str(k.key) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_leaves_with_path(grads0)}
    jstate, m = JTR.make_train_step(jmodel, tx, jcfg)(
        jstate, jax.device_put(batch), dtab["mm"], dtab, jax.random.key(0))
    after = {"/".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(
                 jstate.params)}
    return dict(cfg=cfg, model=model, batch=batch, params=params,
                tables=small["tables"], loss0=float(loss0),
                loss=float(m["loss"]), grads0=grads0, after=after)


@pytest.mark.parametrize("route", [None, "fused"])
def test_accum_matches_jax(jax_world, route, monkeypatch):
    """The port's G = 2 step from the JAX parameters: its loss and the
    parameters after it against the JAX G = 2 step's, its gradient leaves
    (the microbatches' weighted mean) against the JAX whole-batch
    gradients; the fused route takes its plain versions at 2 rows."""
    w = jax_world
    if route is not None:
        monkeypatch.setattr(TENC, "block_route", lambda *a: route)
    state = TTR.init_state(w["model"], w["cfg"], params=w["params"])
    tabs = TTR.device_tables(w["tables"], "cpu")
    state, m = TTR.make_train_step(w["model"], w["cfg"])(
        state, TTR.put_batch(w["batch"], "cpu"), tabs["mm"], tabs)
    np.testing.assert_allclose(w["loss"], w["loss0"], rtol=1e-6)
    np.testing.assert_allclose(float(m["loss"]), w["loss"], rtol=1e-4)
    for name, p in TTR.param_leaves(state.params):
        ref = w["grads0"][name]
        atol = 2e-5 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=2e-4, atol=atol,
                                   err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), w["after"][name],
                                   rtol=1e-4, atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_accum_guards(small):
    """As the JAX step's: sparse tables and tower dedup are refused, and on
    a data mesh each microbatch's rows must divide the data axis; G > 1
    takes seq and data meshes."""
    with pytest.raises(ValueError, match="tower_dedup"):
        TTR.check_supported(_cfg(small, grad_accum_steps=2,
                                 tower_dedup=True))
    with pytest.raises(ValueError, match="dense tables only"):
        TTR.check_supported(_cfg(small, grad_accum_steps=2,
                                 sparse_tables=("item_emb",)))
    cfg = _cfg(small, grad_accum_steps=2)
    TTR.check_supported(cfg)
    TTR.check_supported(cfg, local_mesh(MeshConfig(seq=2)))
    TTR.check_supported(cfg, local_mesh(MeshConfig(data=4)))
    # batch 8 at G=2: microbatches of 4 rows, which 8 data shards cannot
    # split
    with pytest.raises(ValueError, match="must divide the data axis"):
        TTR.check_supported(cfg, local_mesh(MeshConfig(data=8)))
    TTR.check_supported(_cfg(small), local_mesh(MeshConfig(seq=2)))
