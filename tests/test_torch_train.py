"""The port's training step (tencent_recommendation_2025_tpu_torch/train/
trainer.py) against the JAX package's, from the same bridged parameters and
the same batch, on the CPU in f32 with dropout off: hstu_flagship cut to
D=16, 2 blocks, --maxlen 255 (L=256), batch 4, with tower dedup. The JAX CPU
takes its dense XLA path; the port takes its dense route, and its fused
route through the plain versions of the fused block kernels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from tencent_recommendation_2025_tpu.ops import losses as JL
from tencent_recommendation_2025_tpu.train import trainer as JTR
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.config import PRESETS
from tencent_recommendation_2025_tpu_torch.data.featurizer import (
    FusedVocab, build_item_tables)
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models import encoder as TENC
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.ops import losses as TL
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)

MODEL = dict(hidden_units=16, num_blocks=2, maxlen=255, dropout_rate=0.0,
             dtype="float32")
TRAIN = dict(batch_size=4)


def _cfg(presets, **train):
    cfg = presets["hstu_flagship"]()
    return cfg.replace(model=dataclasses.replace(cfg.model, **MODEL),
                       train=dataclasses.replace(cfg.train,
                                                 **dict(TRAIN, **train)))


@pytest.fixture(scope="module")
def world(synth_dir):
    jcfg, cfg = _cfg(JPRESETS), _cfg(PRESETS)
    jdata = JData(synth_dir, mm_emb_ids=("81",))
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    jtab = jbuild(jdata.item_feat_dict, jdata.itemnum, jschema,
                  jdata.mm_emb_dict, jdata.indexer_i_rev)
    jmodel = JModel(cfg=jcfg.model, schema=jschema,
                    fused=JFused.build(jschema), usernum=jdata.usernum,
                    itemnum=jdata.itemnum)
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    tab = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                            data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    tx = JTR.make_optimizer(jcfg)
    jstate = JTR.init_state(jmodel, tx, 3, cfg=jcfg)
    rng = np.random.default_rng(8)
    # biases and LN params off their init, so that every term matters
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.05,
                                        a.dtype)
        if str(path[-1].key) in ("b", "bias", "scale", "rab") else a,
        jstate.params)
    jstate = JTR.TrainState(jparams, tx.init(jparams), jstate.step)
    sampler = JSampler(jdata, jschema, 255)
    loader = JLoader(sampler, np.arange(len(sampler)), 4, seed=1,
                     num_workers=2)
    raw = [b for _, b in zip(range(3), loader.epoch(1))]
    batches = [JTR.augment_batch_dedup(b, jcfg, jtab, jdata.itemnum)
               for b in raw]
    dtab = JTR.device_tables(jtab)

    def loss_fn(p):
        return JTR.compute_loss(jmodel, p, jax.device_put(batches[0]),
                                dtab["mm"], dtab, jcfg, train=True,
                                rng=jax.random.key(0))[0]

    loss0, grads0 = jax.value_and_grad(loss_fn)(jparams)
    # the JAX step donates its state: copy the parameters out first
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    jstep = JTR.make_train_step(jmodel, tx, jcfg)
    losses, after = [], []
    for batch in batches:
        jstate, m = jstep(jstate, jax.device_put(batch), dtab["mm"], dtab,
                          jax.random.key(0))
        losses.append(float(m["loss"]))
        after.append(_jax_leaves(jstate.params))
    return dict(cfg=cfg, model=model, tab=tab, raw=raw, batches=batches,
                params=params, loss0=float(loss0),
                grads0=_jax_leaves(grads0), losses=losses, after=after)


def _port_step(w, batch, params=None, route=None, monkeypatch=None):
    if route is not None:
        monkeypatch.setattr(TENC, "block_route", lambda *a: route)
    state = TTR.init_state(w["model"], w["cfg"],
                           params=params if params is not None
                           else w["params"])
    tabs = TTR.device_tables(w["tab"], "cpu")
    step = TTR.make_train_step(w["model"], w["cfg"])
    return step(state, TTR.put_batch(batch, "cpu"), tabs["mm"], tabs)


def _grad_leaves(params):
    return {p: t.grad for p, t in TTR.param_leaves(params)}


def _jax_leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _check_grads(got, ref):
    assert got.keys() == ref.keys()
    for name, g in got.items():
        r = ref[name]
        atol = 2e-5 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("route", [None, "fused"])
def test_one_step_matches_jax(world, route, monkeypatch):
    """Loss, every gradient leaf, and the parameters after one AdamW step,
    through the port's dense route (default on the CPU) and its fused
    route (the plain versions of both fused block kernels)."""
    w = world
    batch = w["batches"][0]
    assert "dedup_uids" in batch and batch["seq"].shape == (4, 256)
    state, metrics = _port_step(w, batch, route=route,
                                monkeypatch=monkeypatch)
    np.testing.assert_allclose(float(metrics["loss"]), w["loss0"], rtol=1e-4)
    np.testing.assert_allclose(w["losses"][0], w["loss0"], rtol=1e-6)
    _check_grads(_grad_leaves(state.params), w["grads0"])
    for name, p in TTR.param_leaves(state.params):
        np.testing.assert_allclose(p.detach().numpy(), w["after"][0][name],
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_three_steps_match_jax(world):
    w = world
    state = TTR.init_state(w["model"], w["cfg"], params=w["params"])
    tabs = TTR.device_tables(w["tab"], "cpu")
    step = TTR.make_train_step(w["model"], w["cfg"])
    for batch, ref in zip(w["batches"], w["losses"]):
        state, m = step(state, TTR.put_batch(batch, "cpu"), tabs["mm"], tabs)
        np.testing.assert_allclose(float(m["loss"]), ref, rtol=1e-4)
    assert state.step == 3
    for name, p in TTR.param_leaves(state.params):
        np.testing.assert_allclose(p.detach().numpy(), w["after"][-1][name],
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_dedup_prep_matches_jax(world):
    """The port's host prep gives the JAX package's arrays, key for key."""
    w = world
    for raw, ref in zip(w["raw"], w["batches"]):
        got = TTR.augment_batch_dedup(raw, w["cfg"], w["tab"],
                                      w["model"].itemnum)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_dedup_equals_dense_towers(world, capsys):
    """The tower-dedup batch trains exactly as the per-position towers do;
    a batch past the dedup capacity warns and trains dense."""
    w = world
    s_dedup, m_dedup = _port_step(w, w["batches"][1])
    g_dedup = _grad_leaves(s_dedup.params)
    state, m_dense = _port_step(w, w["raw"][1])
    np.testing.assert_allclose(float(m_dedup["loss"]),
                               float(m_dense["loss"]), rtol=1e-5)
    _check_grads(_grad_leaves(state.params),
                 {k: v.numpy() for k, v in g_dedup.items()})
    tiny = w["cfg"].replace(train=dataclasses.replace(
        w["cfg"].train, tower_dedup_cap_frac=1e-4))
    TTR._DEDUP_FALLBACKS["n"] = 0
    out = TTR.augment_batch_dedup(w["raw"][1], tiny, w["tab"],
                                  w["model"].itemnum)
    assert "dedup_uids" not in out and "seq_item_sparse" in out
    assert "tower-dedup fallback #1" in capsys.readouterr().out
    _, m_fb = _port_step(w, out)
    np.testing.assert_allclose(float(m_fb["loss"]), float(m_dense["loss"]),
                               rtol=1e-6)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_optimizer_matches_optax(schedule):
    cfg = PRESETS["hstu_flagship"]()
    over = {} if schedule == "constant" else dict(
        lr_schedule="cosine", lr_warmup_steps=2, lr_total_steps=5)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **over))
    jcfg = JPRESETS["hstu_flagship"]()
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **over))
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape)
                          .astype(np.float32), p0) for _ in range(3)]
    tx = JTR.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, p0)
    jo = tx.init(jp)
    params = params_from_jax(p0)
    state = TTR.init_state(None, cfg, params=params)
    for step, g in enumerate(grads):
        upd, jo = tx.update(jax.tree.map(jnp.asarray, g), jo, jp)
        jp = optax.apply_updates(jp, upd)
        for (_, t), (_, gt) in zip(TTR.param_leaves(state.params),
                                   TTR.param_leaves(params_from_jax(g))):
            t.grad = gt
        for group in state.opt.param_groups:
            group["lr"] = TTR.lr_at_step(cfg.train, step)
        state.opt.step()
        assert TTR.lr_at_step(cfg.train, step) == pytest.approx(
            float(JTR.lr_at_step(jcfg.train, step)), rel=1e-6)
    ref = _jax_leaves(jp)
    for name, t in TTR.param_leaves(state.params):
        np.testing.assert_allclose(t.detach().numpy(), ref[name], rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    pos = (rng.standard_normal((4, 9)) * 3).astype(np.float32)
    neg = (rng.standard_normal((4, 9)) * 3).astype(np.float32)
    mask = rng.random((4, 9)) > 0.3
    ref = JL.reference_bce_loss(jnp.asarray(pos), jnp.asarray(neg),
                                jnp.asarray(mask))
    got = TL.reference_bce_loss(torch.from_numpy(pos), torch.from_numpy(neg),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    table = rng.standard_normal((11, 8)).astype(np.float32)
    np.testing.assert_allclose(
        TL.l2_emb_penalty(torch.from_numpy(table), 1e-3).item(),
        float(JL.l2_emb_penalty(jnp.asarray(table), 1e-3)), rtol=1e-6)
    empty = TL.reference_bce_loss(torch.from_numpy(pos),
                                  torch.from_numpy(neg),
                                  torch.zeros((4, 9), dtype=torch.bool))
    assert empty.item() == 0.0


def test_dense_remat_redraws_the_same_dropout_masks(world):
    """The dense route checkpoints each block in training; its recompute
    must draw the masks the forward drew, so the gradients with and without
    the checkpoint are equal (dropout 0.2)."""
    w = world
    cfg = dataclasses.replace(w["model"].cfg, dropout_rate=0.2)
    b = TTR.put_batch(w["raw"][0], "cpu")
    grads = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat_blocks=remat)
        state = TTR.init_state(w["model"], w["cfg"], params=w["params"])
        x = torch.randn(b["seq"].shape + (c.hidden_units,),
                        generator=torch.Generator().manual_seed(0))
        out = TENC.encode(state.params, x, b["seq"], b["token_type"],
                          state.params["pos_emb"], c, train=True,
                          gen=torch.Generator().manual_seed(5))
        out.square().sum().backward()
        grads.append({p: t.grad for p, t in TTR.param_leaves(state.params)
                      if t.grad is not None})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 10
    for name, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][name], rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{name}: {m}")
