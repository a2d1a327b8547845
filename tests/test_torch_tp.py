"""Tensor parallelism on local meshes (tencent_recommendation_2025_tpu_torch/
parallel/partition.py, mesh.py, sharded_embedding.py; models/; train/)
against the JAX package on the 8 fake CPU devices of conftest.py:

- the partition rules: every leaf of every preset gets the JAX rules' spec
  (tests/test_parallel.py:173, for all leaves), and ``whole_params(
  shard_params(p))`` is ``p`` bitwise, the packed ``uvqk`` and ``w13``
  split per part;
- ``sharded_lookup`` / ``static_lookup`` of a table row-sharded over data 4
  x model 2 equal the JAX ``sharded_lookup`` on that mesh (values, and the
  gradient; tests/test_parallel.py:32, :43);
- one train step on a local mesh with model > 1 (here the flagship's;
  tests/test_torch_tp_steps.py the other presets') against the single
  device's port step (loss rtol 1e-5, the dense gradients rtol 2e-4 /
  atol 2e-5) and against the JAX package's mesh step (tests/
  test_parallel.py:188; loss rtol 1e-5, the parameters after the step
  rtol 2e-3 / atol 2e-5): ``sharded_multihost`` cut to 2 blocks, D=32,
  H=4 with sparse ``item_emb`` and the stacked tower dedup on data 4 x
  model 2 (tests/test_tower_dedup.py:335); the flagship cut to D=32 (H=1,
  H % M != 0) on model 2 and on data 1 x model 2 x seq 2; ``baseline``
  (MHA, post-LN, ReLU FFN) on model 2, and on model 4 against the single
  device;
- dropout on: model 2 draws the single device's masks (the flagship and
  ``baseline``, both H % M cases), loss and gradients as above.

L=32 (``--maxlen 31``), batch 8, f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

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
from tencent_recommendation_2025_tpu.parallel import mesh as JM
from tencent_recommendation_2025_tpu.parallel import partition as JP
from tencent_recommendation_2025_tpu.parallel import sharded_embedding as JSE
from tencent_recommendation_2025_tpu.parallel import train as JPT
from tencent_recommendation_2025_tpu.train import trainer as JTR
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.config import PRESETS, MeshConfig
from tencent_recommendation_2025_tpu_torch.data.featurizer import (
    FusedVocab, build_item_tables)
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.parallel import partition as TP
from tencent_recommendation_2025_tpu_torch.parallel import \
    sharded_embedding as TSE
from tencent_recommendation_2025_tpu_torch.parallel import train as TPT
from tencent_recommendation_2025_tpu_torch.parallel.mesh import local_mesh
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)

requires_8 = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 fake devices")

B = 8
#: name -> (preset, mesh shape, model overrides, train overrides, whether
#: the JAX mesh step is compared too); this file runs the flagship's,
#: tests/test_torch_tp_steps.py the others (each JAX mesh step compiles
#: for about 12 s on the CPU: two files keep each one short)
CASES = {
    "sharded_multihost_d4m2": (
        "sharded_multihost", dict(data=4, model=2),
        dict(hidden_units=32, num_heads=4),
        dict(tower_dedup=True, num_sampled_negatives=16), True),
    "flagship_m2": ("hstu_flagship", dict(model=2), dict(hidden_units=32),
                    dict(tower_dedup=False), True),
    "flagship_m2s2": ("hstu_flagship", dict(model=2, seq=2),
                      dict(hidden_units=32), dict(tower_dedup=False), True),
    "baseline_m2": ("baseline", dict(model=2),
                    dict(hidden_units=32, reference_init=False), {}, True),
    "baseline_m4": ("baseline", dict(model=4),
                    dict(hidden_units=32, reference_init=False), {}, False),
}
HERE = ("flagship_m2", "flagship_m2s2")
MODEL = dict(num_blocks=2, maxlen=31, dropout_rate=0.0, dtype="float32")


def _cfgs(preset, shape, model, train):
    out = []
    for presets in (JPRESETS, PRESETS):
        cfg = presets[preset]()
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model, **dict(MODEL, **model)),
            train=dataclasses.replace(cfg.train, batch_size=B, **train),
            mesh=dataclasses.replace(cfg.mesh, **dict(
                dict(data=1, model=1, seq=1), **shape))))
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
        raw=next(iter(loader.epoch(1))))


def _models(w, jcfg, cfg):
    jm = JModel(cfg=jcfg.model, schema=w["jschema"],
                fused=JFused.build(w["jschema"]), usernum=w["jdata"].usernum,
                itemnum=w["jdata"].itemnum)
    m = SeqRecModel(cfg=cfg.model, schema=w["schema"],
                    fused=FusedVocab.build(w["schema"]),
                    usernum=w["data"].usernum, itemnum=w["data"].itemnum)
    return jm, m


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# the partition rules
# ---------------------------------------------------------------------------

@requires_8
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_leaf_gets_the_jax_spec(world, preset):
    """Every leaf of every preset: the port's spec is the JAX rules' (the
    tables on (pipe, data, model), the tower DNNs column-split, the
    attention's o row-split, ...; tests/test_parallel.py:173), and
    ``whole_params(shard_params(p))`` is ``p`` bitwise on a local mesh of
    model 2."""
    jcfg, cfg = (c.replace(model=dataclasses.replace(
        c.model, num_blocks=2, maxlen=31)) for c in
        (JPRESETS[preset](), PRESETS[preset]()))
    jm, m = _models(world, jcfg, cfg)
    mesh8 = JM.build_mesh(JMesh(data=4, model=2))
    jparams = jax.eval_shape(jm.init, jax.random.key(0))
    want = {"/".join(str(k.key) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_leaves_with_path(
                JP.param_shardings(mesh8, jparams),
                is_leaf=lambda x: isinstance(x, NamedSharding))}
    params = m.init(torch.Generator().manual_seed(0))
    got = TP._flat(TP.param_shardings(params))
    assert got.keys() == want.keys()
    for p, spec in want.items():
        assert got[p] == spec, (p, got[p], spec)
    assert got["itemdnn/w"] == (None, "model")
    moments = TP._flat(TP.opt_state_shardings(params))
    assert moments["itemdnn/w/exp_avg"] == moments[
        "itemdnn/w/exp_avg_sq"] == (None, "model")
    dims = TP.model_dims(params)
    assert dims.get("blocks/ffn/w2", dims.get("blocks/ffn/fc2/w")) == 1
    mesh = local_mesh(MeshConfig(model=2))
    back = TP._flat(TP.whole_params(mesh, TP.shard_params(mesh, params)))
    for p, t in TP._flat(params).items():
        assert torch.equal(back[p], t), p


def test_packed_leaves_split_per_part():
    """Model shard m of ``uvqk`` [D, 4D] holds its columns of each of u, v,
    q and k; of ``w13`` [D, 2F] its columns of w1 and of w3."""
    D, F = 8, 6
    uvqk = torch.arange(2 * D * 4 * D, dtype=torch.float32).reshape(
        2, D, 4 * D)
    w13 = torch.arange(D * 2 * F, dtype=torch.float32).reshape(D, 2 * F)
    for m in range(2):
        got = TP.shard_slice(uvqk, "blocks/hstu/uvqk/w", 2, 2, m)
        want = torch.cat([uvqk[..., j * D + m * D // 2:
                               j * D + (m + 1) * D // 2] for j in range(4)],
                         -1)
        assert torch.equal(got, want)
        got = TP.shard_slice(w13, "blocks/ffn/w13", 1, 2, m)
        assert torch.equal(got, torch.cat([w13[:, m * 3:(m + 1) * 3],
                                           w13[:, F + m * 3:
                                               F + (m + 1) * 3]], 1))
    with pytest.raises(ValueError, match="do not split"):
        TP.shard_slice(w13, "blocks/ffn/w13", 1, 4, 0)


# ---------------------------------------------------------------------------
# the lookups
# ---------------------------------------------------------------------------

@requires_8
def test_sharded_and_static_lookups_match_jax_on_data4_model2():
    mesh8 = JM.build_mesh(JMesh(data=4, model=2))
    mesh = local_mesh(MeshConfig(data=4, model=2))
    rng = np.random.default_rng(0)
    V, D = 37, 4
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, (8, 3)).astype(np.int32)
    cot = rng.standard_normal((8, 3, D)).astype(np.float32)

    def f(t):
        return (JSE.sharded_lookup(mesh8, t, jnp.asarray(ids)) * cot).sum()

    jout = JSE.sharded_lookup(mesh8, jnp.asarray(table), jnp.asarray(ids))
    jgrad = np.asarray(jax.grad(f)(jnp.asarray(table)))
    leaf = TSE.pad_rows(torch.from_numpy(table), 8).requires_grad_(True)
    sharded = TSE.ShardedTable.of_leaf(leaf, mesh)
    out = TSE.sharded_lookup(mesh, sharded, torch.from_numpy(ids))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6)
    np.testing.assert_allclose(leaf.grad.numpy()[:V], jgrad[:V], rtol=1e-5,
                               atol=1e-6)
    assert not leaf.grad[V:].any()
    static = TSE.static_table(table, mesh)
    np.testing.assert_array_equal(
        TSE.static_lookup(static, torch.from_numpy(ids)).numpy(),
        np.asarray(JSE.dense_lookup_oracle(jnp.asarray(table),
                                           jnp.asarray(ids),
                                           mask_zero=False)))


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _prep(TR, w, cfg, model, tab, shape):
    b = dict(w["raw"])
    key = (cfg.train.seed, 97, 1, 0)
    if cfg.train.tower_dedup:
        b = TR.augment_batch_dedup(b, cfg, tab, model.itemnum, step_key=key,
                                   n_data_shards=shape.get("data", 1))
    if cfg.train.sparse_tables:
        b = TR.augment_batch_sparse(
            b, cfg, model.itemnum, key,
            n_table_shards=shape.get("data", 1) * shape.get("model", 1),
            usernum=model.usernum)
    return b


def _jax_mesh_step(w, jcfg, jm, shape):
    """The JAX package's step on a mesh of ``shape`` over the first fake
    devices: its unpadded initial parameters, the loss and the parameters
    after the step (numpy)."""
    n = int(np.prod(list(shape.values())))
    mesh = JM.build_mesh(jcfg.mesh, devices=jax.devices()[:n])
    state, tx = JPT.init_sharded_state(jm, jcfg, mesh)
    template = jax.eval_shape(jm.init, jax.random.key(jcfg.train.seed))
    params0 = jax.tree.map(np.asarray, JPT.unpad_state(
        state, template).params)
    tables = JPT.shard_tables(mesh, JTR.device_tables(w["jtab"]))
    step = JPT.make_sharded_train_step(jm, tx, jcfg, mesh)
    batch = _prep(JTR, w, jcfg, jm, w["jtab"], shape)
    state, m = step(state, JPT.shard_batch(mesh, batch), tables["mm"],
                    tables, jax.random.key(23))
    return params0, float(m["loss"]), _flat(state.params)


def _port_step(w, cfg, m, params, mesh, shape):
    """One port step from ``params``: (loss, the dense leaves' gradients,
    the parameters after the step, whole)."""
    state = TTR.init_state(m, cfg, params=params)
    if mesh is not None:
        state = TPT.shard_existing_state(mesh, state)
    tabs = TTR.device_tables(w["tab"], "cpu")
    batch = _prep(TTR, w, cfg, m, w["tab"], shape if mesh else {})
    state, met = TTR.make_train_step(m, cfg, mesh)(
        state, TTR.put_batch(batch, "cpu"), tabs["mm"], tabs)
    grads = {p: t.grad.clone() for p, t in TTR.dense_leaves(state.params,
                                                            cfg)}
    if mesh is not None:
        state = TPT.unpad_state(state, m, mesh)
    return (float(met["loss"]), grads,
            {p: t.detach().clone() for p, t in
             TTR.param_leaves(state.params)})


def _close_grads(got, want):
    assert got.keys() == want.keys()
    for p, g in want.items():
        n = g.shape[0]
        np.testing.assert_allclose(got[p][:n].numpy(), g.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=p)


def check_model_mesh_step(world, case):
    """One step of ``case`` on its local mesh against the single device's
    port step and (where the case says) the JAX mesh step."""
    preset, shape, model, train, with_jax = CASES[case]
    jcfg, cfg = _cfgs(preset, shape, model, train)
    jm, m = _models(world, jcfg, cfg)
    if with_jax:
        params0, jloss, jparams = _jax_mesh_step(world, jcfg, jm, shape)
        params = params_from_jax(params0)
    else:
        params = m.init(torch.Generator().manual_seed(3))
    one_cfg = cfg.replace(mesh=MeshConfig())
    loss1, grads1, _ = _port_step(world, one_cfg, m, params, None, {})
    loss, grads, after = _port_step(world, cfg, m, params,
                                    local_mesh(MeshConfig(**shape)), shape)
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    _close_grads(grads, grads1)
    if not with_jax:
        return
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for p, want in jparams.items():
        got = after[p].float().numpy().reshape(-1, *want.shape[1:]) \
            if want.ndim > 1 else after[p].float().numpy()
        n = got.shape[0]
        # the JAX mesh's rows past the port's are its shard padding: zero
        assert not want[n:].any(), p
        want = want[:n]
        if p in grads1:
            # an element whose gradient is rounding noise (zero in exact
            # arithmetic, as MHA's key bias under the softmax) moves by
            # Adam's lr times the noise's sign: its gradient is held above
            keep = grads1[p].abs().reshape(got.shape).numpy() >= 1e-6
            got, want = got[keep], want[keep]
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5,
                                   err_msg=p)


@requires_8
@pytest.mark.parametrize("case", HERE)
def test_model_mesh_step_matches_one_device_and_jax_mesh(world, case):
    check_model_mesh_step(world, case)


@pytest.mark.parametrize("preset,H", [("hstu_flagship", 1),
                                      ("hstu_flagship", 2),
                                      ("baseline", 1), ("baseline", 4)])
def test_dropout_on_model2_draws_the_single_device_masks(world, preset, H):
    """Dropout 0.2: the replicated activations take one mask, the split
    ones (the HSTU gate, the FFN hidden, MHA's weights of its heads) their
    columns of the whole-width draw, so model 2 trains the single device's
    step: loss rtol 1e-5, gradients rtol 2e-4 / atol 2e-5."""
    shape = dict(model=2)
    _, cfg = _cfgs(preset, shape, dict(hidden_units=32, num_heads=H,
                                       dropout_rate=0.2,
                                       reference_init=False),
                   dict(tower_dedup=False))
    _, m = _models(world, _cfgs(preset, shape, {}, {})[0], cfg)
    params = m.init(torch.Generator().manual_seed(4))
    loss1, grads1, _ = _port_step(world, cfg.replace(mesh=MeshConfig()), m,
                                  params, None, {})
    loss, grads, _ = _port_step(world, cfg, m, params,
                                local_mesh(MeshConfig(**shape)), shape)
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    _close_grads(grads, grads1)
