"""The reference's own models on the port: ``baseline`` (softmax MHA, ReLU
FFN, post-LN), ``baseline_o1`` (one head, SwiGLU FFN, post-LN) and
``hstu_mini`` (pre-norm HSTU, ReLU FFN), cut to D=32 and 2 blocks, against
the JAX package from bridged parameters, on the CPU in f32 with dropout
off: the encoder's output, the queries, and one training step (loss, every
gradient, the parameters after one AdamW step).

At --maxlen 101 (L=102) both packages run dense. At --maxlen 255 (L=256)
the JAX CPU runs dense and the port takes its "core" route (monkeypatched
``block_route``) through the plain versions of the flash MHA and HSTU
attention kernels, checkpointed as on the card; hstu_mini also at --maxlen
511 (L=512) with the whole-sequence ceiling cut to 128, where the chunked
HSTU attention wrappers (and their 256-row bias-tile bucket check) take
over.

The LN scales and biases, every bias and ``rab`` are moved off their init:
``reference_init`` zeroes the LN scales, and under post-LN every block's
output would then be its LN bias, so a comparison would hold zeros to
zeros."""

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
from tencent_recommendation_2025_tpu.train import trainer as JTR
from tencent_recommendation_2025_tpu.train.checkpoint import \
    save_checkpoint as jsave
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.config import PRESETS
from tencent_recommendation_2025_tpu_torch.data.featurizer import (
    FusedVocab, build_item_tables)
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models import encoder as TENC
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.ops import flash_attention as TFA
from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as THA
from tencent_recommendation_2025_tpu_torch.train import checkpoint as TCK
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)

PRESET_NAMES = ("baseline", "baseline_o1", "hstu_mini")
#: (maxlen, port route): L=102 dense on both; L=256 the port's core route
ROUTES = ((101, "dense"), (255, "core"))
#: and hstu_mini at L=512 on the core route, with the whole-sequence
#: ceiling cut to 128: past ``_use_long``, the chunked kernels' shapes
CASES = [(p, m, r) for p in PRESET_NAMES for m, r in ROUTES] \
    + [("hstu_mini", 511, "core")]


def _cfg(presets, name, maxlen):
    cfg = presets[name]()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, hidden_units=32, num_blocks=2,
                                  maxlen=maxlen, dropout_rate=0.0,
                                  dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=4))


_WORLDS = {}


def _world(synth_dir, name, maxlen):
    """JAX and port models of one preset at one window, bridged parameters
    (LN, biases and rab off their init), one batch, and the JAX package's
    encoder output, loss, gradients and parameters after one AdamW step."""
    key = (name, maxlen)
    if key in _WORLDS:
        return _WORLDS[key]
    jcfg, cfg = _cfg(JPRESETS, name, maxlen), _cfg(PRESETS, name, maxlen)
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
    rng = np.random.default_rng(11)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                                        a.dtype)
        if str(path[-1].key) in ("b", "bias", "scale", "rab") else a,
        jmodel.init(jax.random.key(4)))
    loader = JLoader(JSampler(jdata, jschema, maxlen), np.arange(32), 4,
                     seed=1, num_workers=2)
    batch = next(iter(loader.epoch(1)))
    dtab = JTR.device_tables(jtab)
    jb = jax.device_put(batch)

    def loss_fn(p):
        return JTR.compute_loss(jmodel, p, jb, dtab["mm"], dtab, jcfg,
                                train=True, rng=jax.random.key(0))[0]

    tx = JTR.make_optimizer(jcfg)

    @jax.jit   # one compile, not one per primitive
    def reference(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, _ = tx.update(grads, tx.init(p), p)
        return (loss, grads, optax.apply_updates(p, upd),
                jmodel.log2feats(p, jb, dtab["mm"]))

    loss, grads, after, feats = reference(jparams)
    w = dict(cfg=cfg, model=model, tab=tab, batch=batch, jparams=jparams,
             params=params_from_jax(jax.tree.map(np.asarray, jparams)),
             feats=np.asarray(feats), loss=float(loss),
             grads=_jax_leaves(grads), after=_jax_leaves(after))
    _WORLDS[key] = w
    return w


def _jax_leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _route(monkeypatch, route):
    monkeypatch.setattr(TENC, "block_route", lambda *a: route)
    monkeypatch.setattr(THA, "MAX_WHOLESEQ_L", 128)


@pytest.mark.parametrize("name,maxlen,route", CASES)
def test_encode_and_predict_match(synth_dir, monkeypatch, name, maxlen,
                                  route):
    w = _world(synth_dir, name, maxlen)
    _route(monkeypatch, route)
    b = TTR.put_batch(w["batch"], "cpu")
    mm = {"81": torch.from_numpy(w["tab"].mm["81"])}
    assert b["seq"].shape == (4, maxlen + 1)
    before = (TFA.flash_mha_fwd.launches, THA.hstu_attention_fwd.launches)
    feats = w["model"].log2feats(w["params"], b, mm)
    np.testing.assert_allclose(feats.detach().numpy(), w["feats"],
                               rtol=1e-4, atol=1e-4)
    q = w["model"].predict(w["params"], b, mm)
    np.testing.assert_allclose(q.numpy(), w["feats"][:, -1], rtol=1e-4,
                               atol=1e-4)
    # CPU tensors take the plain versions, which count no launch
    assert (TFA.flash_mha_fwd.launches,
            THA.hstu_attention_fwd.launches) == before


@pytest.mark.parametrize("name,maxlen,route", CASES)
def test_one_step_matches(synth_dir, monkeypatch, name, maxlen, route):
    """Loss, every gradient leaf and the parameters after one AdamW step
    (``baseline``: l2_emb 1e-3 and weight decay 0.01; the non-dedup step of
    all three presets)."""
    w = _world(synth_dir, name, maxlen)
    assert not w["cfg"].train.tower_dedup
    _route(monkeypatch, route)
    state = TTR.init_state(w["model"], w["cfg"], params=w["params"])
    tabs = TTR.device_tables(w["tab"], "cpu")
    step = TTR.make_train_step(w["model"], w["cfg"])
    state, metrics = step(state, TTR.put_batch(w["batch"], "cpu"),
                          tabs["mm"], tabs)
    np.testing.assert_allclose(float(metrics["loss"]), w["loss"], rtol=1e-4)
    got = {p: t.grad for p, t in TTR.param_leaves(state.params)}
    assert got.keys() == w["grads"].keys()
    for leaf, g in got.items():
        ref = w["grads"][leaf]
        atol = 2e-5 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-4, atol=atol,
                                   err_msg=leaf)
    for leaf, p in TTR.param_leaves(state.params):
        np.testing.assert_allclose(p.detach().numpy(), w["after"][leaf],
                                   rtol=1e-4, atol=1e-4, err_msg=leaf)


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_reference_init_zeroes_ln_scales(synth_dir, name):
    """The port's init copies the reference quirk: with ``reference_init``
    (both parity presets) every LN scale starts at 0, so under post-LN every
    query starts as the last LN's bias (0); hstu_mini starts at scale 1.
    The tree and shapes are the JAX init's."""
    w = _world(synth_dir, name, 101)
    model, cfg = w["model"], w["model"].cfg    # the preset's reference_init
    params = model.init(torch.Generator().manual_seed(0))
    scales = [params["last_ln"]["scale"], params["blocks"]["attn_ln"]["scale"],
              params["blocks"]["ffn_ln"]["scale"]]
    want = 0.0 if cfg.reference_init else 1.0
    assert cfg.reference_init == (name != "hstu_mini")
    assert all(bool((s == want).all()) for s in scales)
    assert ("attn" in params["blocks"]) == (cfg.block_type == "mha")
    shapes = {p: tuple(t.shape) for p, t in TTR.param_leaves(params)}
    assert shapes == {p: tuple(t.shape)
                      for p, t in TTR.param_leaves(w["params"])}
    if cfg.reference_init:
        q = model.predict(params, TTR.put_batch(w["batch"], "cpu"),
                          {"81": torch.from_numpy(w["tab"].mm["81"])})
        assert not q.any()


@pytest.mark.parametrize("name,L,route", [
    ("baseline", 102, "dense"), ("baseline", 256, "core"),
    ("baseline", 1024, "core"), ("baseline", 2048, "dense"),
    ("baseline_o1", 1024, "core"), ("hstu_mini", 129, "dense"),
    ("hstu_mini", 256, "core"), ("hstu_mini", 1024, "core"),
    ("hstu_mini", 2048, "core"), ("hstu_mini", 16384, "core"),
    ("hstu_flagship", 1024, "fused")])
def test_block_route_mirrors_make_attention_cores(name, L, route):
    """Routes on the card, as the JAX package chooses between its fused
    block, its standalone HSTU attention, flash MHA and dense XLA; on the
    CPU every route is dense."""
    cfg = PRESETS[name]().model
    assert TENC.block_route(cfg, L, "cuda") == route
    assert TENC.block_route(cfg, L, "cpu") == "dense"


def test_block_route_raises_for_chunked_hstu_attention():
    """An HSTU shape past the whole-sequence kernels (_use_long) takes the
    chunked HSTU attention kernels on the card (the core route, at any
    head width: a head of 512 passes the kernels' input check); MHA past the flash gate runs dense; a wider MHA runs dense from
    a shorter L."""
    mini = PRESETS["hstu_mini"]().model
    assert THA._use_long(2048, 64) and not THA._use_long(1024, 64)
    assert TENC.block_route(mini, 2048, "cuda") == "core"
    wide = dataclasses.replace(mini, hidden_units=128)
    assert THA._use_long(1024, 128)
    assert TENC.block_route(wide, 1024, "cuda") == "core"
    THA.check_attention_inputs("k", 1, torch.zeros((1, 1024, 512)))
    mha = dataclasses.replace(PRESETS["baseline"]().model, hidden_units=128)
    assert TENC.block_route(mha, 512, "cuda") == "core"
    assert TENC.block_route(mha, 1024, "cuda") == "dense"


def test_jax_checkpoint_bridges_mha_leaves_and_checks_config(synth_dir,
                                                             tmp_path):
    """A JAX-written ``baseline`` checkpoint reaches the port with its
    ``blocks/attn/{q,k,v,o}/{w,b}`` leaves unchanged; it loads into its own
    preset's model and fails the config check for ``baseline_o1``'s."""
    w = _world(synth_dir, "baseline", 101)
    jsave(tmp_path, w["jparams"], 5,
          model_config=_cfg(JPRESETS, "baseline", 101).model)
    ck = TCK.latest_checkpoint(tmp_path)
    attn = params_from_jax(ck)["blocks"]["attn"]
    assert sorted(attn) == ["k", "o", "q", "v"]
    for n in "qkvo":
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(
                attn[n][leaf].numpy(),
                np.asarray(w["jparams"]["blocks"]["attn"][n][leaf]))
    params, meta = TCK.load_params(ck, w["model"])
    assert meta["model_config"]["block_type"] == "mha"
    o1 = _world(synth_dir, "baseline_o1", 101)["model"]
    with pytest.raises(ValueError, match="num_heads"):
        TCK.load_params(ck, o1)
