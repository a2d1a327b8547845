"""The port's copied data layer and fusion towers against the JAX package's,
on the session's synthetic fixture (``synth_dir``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import ModelConfig as JModelConfig
from tencent_recommendation_2025_tpu.data import dataset as JD
from tencent_recommendation_2025_tpu.data import featurizer as JF
from tencent_recommendation_2025_tpu.data import pipeline as JP
from tencent_recommendation_2025_tpu.data import readers as JR
from tencent_recommendation_2025_tpu.data.schema import \
    FeatureSchema as JSchema
from tencent_recommendation_2025_tpu.models import embedding as JE
from tencent_recommendation_2025_tpu.models.baseline import \
    SeqRecModel as JModel
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.config import ModelConfig
from tencent_recommendation_2025_tpu_torch.data import dataset as TD
from tencent_recommendation_2025_tpu_torch.data import featurizer as TF
from tencent_recommendation_2025_tpu_torch.data import pipeline as TP
from tencent_recommendation_2025_tpu_torch.data import readers as TR
from tencent_recommendation_2025_tpu_torch.data.schema import \
    FeatureSchema as TSchema
from tencent_recommendation_2025_tpu_torch.models import embedding as TE

torch.set_num_threads(2)

MAXLEN = 20


def _layer(R, F, Schema, synth_dir, split):
    data = R.TencentGRData(synth_dir, mm_emb_ids=("81",), split=split)
    schema = Schema.from_indexer(data.indexer, mm_emb_ids=("81",),
                                 array_cap=8)
    fused = F.FusedVocab.build(schema)
    tables = F.build_item_tables(data.item_feat_dict, data.itemnum, schema,
                                 data.mm_emb_dict, data.indexer_i_rev)
    return data, schema, fused, tables


@pytest.fixture(scope="module")
def layers(synth_dir):
    return {split: (_layer(JR, JF, JSchema, synth_dir, split),
                    _layer(TR, TF, TSchema, synth_dir, split))
            for split in ("train", "test")}


def _test_batches(D, P, data, schema, maxlen=MAXLEN):
    loader = P.TestLoader(D.TestSampler(data, schema, maxlen), 8,
                          num_workers=2)
    return list(loader)


def test_data_layer_matches(layers):
    for split, (j, t) in layers.items():
        (jdata, jschema, jfused, jtab), (tdata, tschema, tfused, ttab) = j, t
        assert dict(jschema.vocab) == dict(tschema.vocab)
        assert dataclasses.asdict(jfused) == dataclasses.asdict(tfused)
        np.testing.assert_array_equal(jtab.sparse, ttab.sparse)
        np.testing.assert_array_equal(jtab.array, ttab.array)
        np.testing.assert_array_equal(jtab.mm["81"], ttab.mm["81"])
    (jdata, jschema, _, _), (tdata, tschema, _, _) = layers["test"]
    jb = _test_batches(JD, JP, jdata, jschema)
    tb = _test_batches(TD, TP, tdata, tschema)
    assert len(jb) == len(tb) > 1
    for (ja, ju, jn), (ta, tu, tn) in zip(jb, tb):
        assert ju == tu and jn == tn
        assert ja.keys() == ta.keys()
        for k in ja:
            np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
    (jdata, jschema, _, _), (tdata, tschema, _, _) = layers["train"]
    js = JD.TrainSampler(jdata, jschema, MAXLEN)
    ts = TD.TrainSampler(tdata, tschema, MAXLEN)
    for uid in range(min(6, len(js))):
        a = js.sample(uid, np.random.default_rng(uid))
        b = ts.sample(uid, np.random.default_rng(uid))
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), err_msg=f.name)


@pytest.fixture(scope="module")
def towers(layers):
    (jdata, jschema, jfused, jtab), (tdata, tschema, tfused, ttab) = \
        layers["test"]
    kw = dict(hidden_units=32, num_blocks=1, num_heads=2, maxlen=MAXLEN,
              block_type="hstu", ffn_type="swiglu", dtype="float32",
              reference_init=False)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    jmodel = JModel(cfg=jcfg, schema=jschema, fused=jfused,
                    usernum=jdata.usernum, itemnum=jdata.itemnum)
    jparams = jmodel.init(jax.random.key(3))
    rng = np.random.default_rng(4)
    # non-zero biases so every term of the towers is exercised
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.05,
                                  a.dtype) if a.ndim == 1 else a, jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    # a window long enough to hold whole sequences, user tokens included
    batch = _test_batches(JD, JP, jdata, jschema, maxlen=63)[0][0]
    assert (batch["token_type"] == 2).any()
    return dict(jp=jparams, tp=tparams, jcfg=jcfg, tcfg=tcfg, js=jschema,
                ts=tschema, jf=jfused, tf=tfused, jt=jtab, tt=ttab,
                batch=batch)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5,
                               atol=1e-6)


def test_item_tower_matches(towers):
    w, b = towers, towers["batch"]
    ids = np.where(b["token_type"] == 1, b["seq"], 0)
    jmm = JE.gather_mm({"81": jnp.asarray(w["jt"].mm["81"])},
                       jnp.asarray(ids), w["js"])
    ref = JE.item_tower(w["jp"], jnp.asarray(ids),
                        jnp.asarray(b["seq_item_sparse"]),
                        jnp.asarray(b["seq_item_array"]), jmm, w["jf"],
                        w["js"], w["jcfg"])
    tmm = TE.gather_mm({"81": torch.from_numpy(w["tt"].mm["81"])},
                       torch.from_numpy(ids), w["ts"])
    out = TE.item_tower(w["tp"], torch.from_numpy(ids),
                        torch.from_numpy(b["seq_item_sparse"]),
                        torch.from_numpy(b["seq_item_array"]), tmm, w["tf"],
                        w["ts"], w["tcfg"])
    _close(ref, out)


def test_user_tower_matches(towers):
    w, b = towers, towers["batch"]
    is_u = b["token_type"] == 2
    ids = np.where(is_u, b["seq"], 0)
    sp = b["seq_user_sparse"] * is_u[..., None]
    ar = b["seq_user_array"] * is_u[..., None, None]
    ref = JE.user_tower(w["jp"], jnp.asarray(ids), jnp.asarray(sp),
                        jnp.asarray(ar), w["jf"], w["jcfg"])
    out = TE.user_tower(w["tp"], torch.from_numpy(ids),
                        torch.from_numpy(sp), torch.from_numpy(ar), w["tf"],
                        w["tcfg"])
    _close(ref, out)


def test_fuse_sequence_matches(towers):
    w, b = towers, towers["batch"]
    ref = JE.fuse_sequence(w["jp"], {k: jnp.asarray(v) for k, v in b.items()},
                           {"81": jnp.asarray(w["jt"].mm["81"])}, w["jf"],
                           w["js"], w["jcfg"])
    out = TE.fuse_sequence(w["tp"], {k: torch.from_numpy(v)
                                     for k, v in b.items()},
                           {"81": torch.from_numpy(w["tt"].mm["81"])},
                           w["tf"], w["ts"], w["tcfg"])
    _close(ref, out)


def test_out_of_vocab_ids_follow_the_one_hot_forward(towers):
    """Ids above a small vocabulary give zero rows, as the JAX one-hot
    forward does; id 0 is the padding row."""
    w = towers
    fused = w["tf"]
    fids = fused.feature_ids[:3]
    offs = [fused.offsets[fused.slot(f)] for f in fids]
    sizes = list(fused.group_sizes(fids))
    ids = np.array([[0, 1, sizes[2]], [sizes[0] + 1, sizes[1], 5000]],
                   np.int32)
    ref = JE.fused_feature_lookup(
        jnp.asarray(w["jp"]["fused_feat"]), jnp.asarray(ids),
        jnp.asarray(offs, jnp.int32), vocab_sizes=(tuple(offs), tuple(sizes)))
    out = TE.fused_feature_lookup(w["tp"]["fused_feat"],
                                  torch.from_numpy(ids), offs, sizes=sizes)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    assert not out[0, 0].any() and not out[1, 0].any()


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_out_of_range_id_gradient_matches_jax(dtype):
    """An id past the table's end reads the last row in both packages, and
    its gradient is dropped in both (JAX ``_zst_bwd``: scatter mode 'drop');
    id 0 sends none either."""
    V, D = 7, 4
    rng = np.random.default_rng(21)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = np.array([[0, 1, V - 1, V], [V + 5, 3, 3, 0]], np.int32)
    cot = rng.standard_normal((2, 4, D)).astype(np.float32)
    jdt = None if dtype is None else jnp.bfloat16
    tdt = None if dtype is None else torch.bfloat16

    def f(t):
        out = JE.masked_take(t, jnp.asarray(ids), dtype=jdt)
        return (out.astype(jnp.float32) * cot).sum(), out

    (_, jout), jgrad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    out = TE.masked_take(tt, torch.from_numpy(ids), dtype=tdt)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.float().detach().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    # with a bf16 lookup the JAX package sums a row's cotangents in bf16 (its
    # scatter runs in the cotangent's dtype), the port in f32: one bf16 step
    tol = 1e-6 if dtype is None else 2.0 ** -8
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), rtol=tol,
                               atol=tol)
    # the last row gets only id V-1's cotangent; row 0 none
    last = cot[0, 2] if dtype is None else \
        torch.from_numpy(cot[0, 2]).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(tt.grad[V - 1].numpy(), last)
    assert not tt.grad[0].any()
