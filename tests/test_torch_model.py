"""The port's SeqRecModel.predict / encode_items against the JAX package's,
from bridged parameters, at a small HSTU/SwiGLU config (D=32, 2 blocks,
L=256) in f32: the JAX CPU takes its dense path and the port its plain
one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import ModelConfig as JModelConfig
from tencent_recommendation_2025_tpu.data.dataset import \
    TestSampler as JTestSampler
from tencent_recommendation_2025_tpu.data.featurizer import \
    FusedVocab as JFused, build_item_tables as jbuild
from tencent_recommendation_2025_tpu.data.pipeline import \
    TestLoader as JTestLoader
from tencent_recommendation_2025_tpu.data.readers import TencentGRData as JData
from tencent_recommendation_2025_tpu.data.schema import FeatureSchema as JSch
from tencent_recommendation_2025_tpu.models.baseline import \
    SeqRecModel as JModel
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.config import ModelConfig
from tencent_recommendation_2025_tpu_torch.data.featurizer import \
    FusedVocab, build_item_tables
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models import embedding as TE
from tencent_recommendation_2025_tpu_torch.models import encoder as TENC
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel

torch.set_num_threads(2)

KW = dict(hidden_units=32, num_blocks=2, num_heads=2, maxlen=255,
          block_type="hstu", ffn_type="swiglu", dtype="float32",
          reference_init=False)


@pytest.fixture(scope="module")
def models(synth_dir):
    jdata = JData(synth_dir, mm_emb_ids=("81",), split="test")
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    jfused = JFused.build(jschema)
    jtab = jbuild(jdata.item_feat_dict, jdata.itemnum, jschema,
                  jdata.mm_emb_dict, jdata.indexer_i_rev)
    jmodel = JModel(cfg=JModelConfig(**KW), schema=jschema, fused=jfused,
                    usernum=jdata.usernum, itemnum=jdata.itemnum)
    data = TencentGRData(synth_dir, mm_emb_ids=("81",), split="test")
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    tab = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                            data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=ModelConfig(**KW), schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    jparams = jmodel.init(jax.random.key(5))
    rng = np.random.default_rng(6)
    # biases and LN params off their init, so that every term matters
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.05,
                                        a.dtype)
        if str(path[-1].key) in ("b", "bias", "scale") else a, jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    batch = next(iter(JTestLoader(JTestSampler(jdata, jschema, 255), 16,
                                  num_workers=2)))[0]
    return dict(jm=jmodel, jp=jparams, jt=jtab, m=model, p=tparams, t=tab,
                batch=batch)


def test_predict_matches(models):
    w = models
    b = w["batch"]
    assert b["seq"].shape[1] == 256
    assert TENC.block_route(w["m"].cfg, 256, "cpu") == "dense"
    ref = w["jm"].predict(w["jp"], {k: jnp.asarray(v) for k, v in b.items()},
                          {"81": jnp.asarray(w["jt"].mm["81"])})
    out = w["m"].predict(w["p"], {k: torch.from_numpy(v)
                                  for k, v in b.items()},
                         {"81": torch.from_numpy(w["t"].mm["81"])})
    assert out.shape == (16, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_fused_route_matches(models):
    """The encoder's fused route on CPU tensors (the plain version of the
    fused block kernel, operands of every block built at once) gives the
    JAX queries too."""
    w = models
    b = {k: torch.from_numpy(v) for k, v in w["batch"].items()}
    ref = w["jm"].predict(w["jp"], {k: jnp.asarray(v)
                                    for k, v in w["batch"].items()},
                          {"81": jnp.asarray(w["jt"].mm["81"])})
    fe = TE.fuse_sequence(w["p"], b, {"81": torch.from_numpy(w["t"].mm["81"])},
                          w["m"].fused, w["m"].schema, w["m"].cfg)
    out = TENC.encode(w["p"], fe, b["seq"], b["token_type"],
                      w["p"]["pos_emb"], w["m"].cfg, route="fused")[:, -1]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_encode_items_matches(models):
    w = models
    n = w["m"].itemnum + 1
    ids = np.arange(n, dtype=np.int32)
    sp, ar = w["t"].sparse[ids], w["t"].array[ids]
    mm = w["t"].mm["81"][ids]
    ref = w["jm"].encode_items(w["jp"], jnp.asarray(ids), jnp.asarray(sp),
                               jnp.asarray(ar), {"81": jnp.asarray(mm)})
    out = w["m"].encode_items(w["p"], torch.from_numpy(ids),
                              torch.from_numpy(sp), torch.from_numpy(ar),
                              {"81": torch.from_numpy(mm)})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_unported_encoder_branches_raise(models):
    w = models
    b = {k: torch.from_numpy(v) for k, v in w["batch"].items()}
    fe = torch.zeros(b["seq"].shape + (32,))
    with pytest.raises(TypeError, match="is not a mesh"):
        TENC.encode(w["p"], fe, b["seq"], b["token_type"],
                    w["p"]["pos_emb"], w["m"].cfg, mesh=object())
    # the training forward is ported: it runs on both routes
    for route in ("dense", "fused"):
        out = TENC.encode(w["p"], fe, b["seq"], b["token_type"],
                          w["p"]["pos_emb"], w["m"].cfg, train=True,
                          gen=torch.Generator().manual_seed(0), route=route)
        assert out.shape == fe.shape and torch.isfinite(out).all()
    # softmax-MHA blocks are ported (tests/test_torch_parity_presets.py),
    # and so are the chunked standalone HSTU attention kernels (Queue 2 rows
    # 15-17): an HSTU block the fused gate refuses takes the core route at
    # every long L
    relu = dataclasses.replace(w["m"].cfg, ffn_type="relu")
    for L in (256, 4096):
        assert TENC.block_route(relu, L, "cuda") == "core"


def test_init_shapes_match_jax(models):
    """The port's seeded init has the JAX init's tree, shapes and dtypes."""
    w = models
    mine = w["m"].init(torch.Generator().manual_seed(0))
    ref = params_from_jax(jax.tree.map(np.asarray, w["jp"]))

    def shapes(t, pre=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(shapes(v, f"{pre}{k}/"))
            return out
        return {pre: (tuple(t.shape), t.dtype)}

    assert shapes(mine) == shapes(ref)
    assert not mine["item_emb"][0].any() and mine["item_emb"][1:].any()
    again = w["m"].init(torch.Generator().manual_seed(0))
    assert torch.equal(again["blocks"]["hstu"]["rab"],
                       mine["blocks"]["hstu"]["rab"])
    # the bf16 compute config serves the same parameters
    bf = dataclasses.replace(w["m"].cfg, dtype="bfloat16")
    q = dataclasses.replace(w["m"], cfg=bf).predict(
        w["p"], {k: torch.from_numpy(v) for k, v in w["batch"].items()},
        {"81": torch.from_numpy(w["t"].mm["81"])})
    assert q.dtype == torch.bfloat16 and torch.isfinite(q.float()).all()
