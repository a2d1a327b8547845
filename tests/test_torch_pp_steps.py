"""Pipeline parallelism in the train step (tencent_recommendation_2025_tpu_
torch/train/trainer.py, parallel/train.py, parallel/mesh.py on a pipe
mesh) against the JAX package on the 8 fake CPU devices of conftest.py:
one step of a small HSTU config (2 blocks, D=16, L=128, batch 8, f32,
dropout off) on a local mesh of pipe 2 x data 2 with 4 microbatches a data
column, for the reference BCE (``hstu_flagship``) and for the sampled
softmax with a sparse ``item_emb`` (``sharded_multihost``, rowwise
Adagrad, its tables on the 4 pipe x data shards):

- its loss and its dense leaves' gradients against the JAX package's loss
  and gradients on its pipe 2 x data 2 mesh (``compute_loss`` under
  ``jax.grad``, the same batch and parameters): loss rtol 1e-4 / atol
  1e-5, gradients rtol 2e-4 / atol 2e-5;
- the same against the port's single-device step;
- the parameters after the step against the JAX mesh step's
  (``make_sharded_train_step``; rtol 2e-3 / atol 2e-5, the bound of
  tests/test_torch_tp.py after a step), every table row included;
- G = 2 microbatches of gradient accumulation on the pipe mesh train the
  whole batch's step (the BCE case)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_torch_tp as TT
from tencent_recommendation_2025_tpu.parallel import mesh as JM
from tencent_recommendation_2025_tpu.parallel import train as JPT
from tencent_recommendation_2025_tpu.train import trainer as JTR
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.config import MeshConfig
from tencent_recommendation_2025_tpu_torch.parallel import train as TPT
from tencent_recommendation_2025_tpu_torch.parallel.mesh import local_mesh
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)

requires_8 = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 fake devices")

B = TT.B
SHAPE = dict(pipe=2, data=2)
MODEL = dict(num_blocks=2, hidden_units=16, maxlen=127, dropout_rate=0.0,
             dtype="float32", reference_init=False)
CASES = {
    "bce": ("hstu_flagship", dict(num_heads=1), dict(tower_dedup=False)),
    "sparse_softmax": ("sharded_multihost", dict(num_heads=2),
                       dict(tower_dedup=False, num_sampled_negatives=16)),
}


@pytest.fixture(scope="module")
def world(synth_dir):
    """tests/test_torch_tp.py's data, its batch at this file's window."""
    from tencent_recommendation_2025_tpu.data.dataset import \
        TrainSampler as JSampler
    from tencent_recommendation_2025_tpu.data.featurizer import \
        build_item_tables as jbuild
    from tencent_recommendation_2025_tpu.data.pipeline import \
        TrainLoader as JLoader
    from tencent_recommendation_2025_tpu.data.readers import \
        TencentGRData as JData
    from tencent_recommendation_2025_tpu.data.schema import \
        FeatureSchema as JSch
    from tencent_recommendation_2025_tpu_torch.data.featurizer import \
        build_item_tables
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema

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


def _cfgs(preset, model, train, grad_accum=1):
    out = []
    for cfg in TT._cfgs(preset, {}, {}, {}):
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model, **dict(MODEL, **model)),
            train=dataclasses.replace(cfg.train, grad_accum_steps=grad_accum,
                                      **train),
            mesh=dataclasses.replace(cfg.mesh, data=2, model=1, seq=1,
                                     pipe=2, pp_microbatches=4)))
    return out


def _prep(TR, w, cfg, model, tab, n_shards):
    b = dict(w["raw"])
    if cfg.train.sparse_tables:
        b = TR.augment_batch_sparse(b, cfg, model.itemnum,
                                    (cfg.train.seed, 97, 1, 0),
                                    n_table_shards=n_shards,
                                    usernum=model.usernum)
    return b


def _jax_mesh(w, jcfg, jm):
    """The JAX package on its pipe 2 x data 2 mesh: the unpadded initial
    parameters, the loss and dense gradients of ``compute_loss`` (the
    tables dense: the gradient of the dense leaves is the sparse path's),
    and the loss and parameters after one mesh step."""
    mesh = JM.build_mesh(jcfg.mesh, devices=jax.devices()[:4])
    state, tx = JPT.init_sharded_state(jm, jcfg, mesh)
    template = jax.eval_shape(jm.init, jax.random.key(jcfg.train.seed))
    params0 = jax.tree.map(np.asarray, JPT.unpad_state(
        state, template).params)
    tables = JPT.shard_tables(mesh, JTR.device_tables(w["jtab"]))
    batch = JPT.shard_batch(mesh, _prep(JTR, w, jcfg, jm, w["jtab"], 4))
    dense_cfg = jcfg.replace(train=dataclasses.replace(
        jcfg.train, sparse_tables=()))
    sparse = set(jcfg.train.sparse_tables)
    dense = {k: v for k, v in state.params.items() if k not in sparse}
    fixed = {k: v for k, v in state.params.items() if k in sparse}

    def loss_fn(p):
        loss, _ = JTR.compute_loss(jm, dict(p, **fixed), {
            k: v for k, v in batch.items()}, tables["mm"], tables,
            dense_cfg, True, jax.random.key(23), mesh)
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(dense)
    step = JPT.make_sharded_train_step(jm, tx, jcfg, mesh)
    state, m = step(state, batch, tables["mm"], tables, jax.random.key(23))
    return (params0, float(loss), TT._flat(grads), float(m["loss"]),
            TT._flat(state.params))


def _port_step(w, cfg, m, params, mesh):
    state = TTR.init_state(m, cfg, params=params)
    if mesh is not None:
        state = TPT.shard_existing_state(mesh, state)
    tabs = TTR.device_tables(w["tab"], "cpu")
    batch = _prep(TTR, w, cfg, m, w["tab"], 4 if mesh is not None else 1)
    state, met = TTR.make_train_step(m, cfg, mesh)(
        state, TTR.put_batch(batch, "cpu"), tabs["mm"], tabs)
    grads = {p: t.grad.clone() for p, t in TTR.dense_leaves(state.params,
                                                            cfg)}
    if mesh is not None:
        state = TPT.unpad_state(state, m, mesh)
    return (float(met["loss"]), grads,
            {p: t.detach().clone() for p, t in
             TTR.param_leaves(state.params)})


def _close(got, want, rtol, atol):
    for p, g in want.items():
        a, b = np.asarray(got[p], np.float32), np.asarray(g, np.float32)
        n = min(len(a), len(b))
        np.testing.assert_allclose(a[:n], b[:n], rtol=rtol, atol=atol,
                                   err_msg=p)
        # the rows past the shorter one are shard padding: zero
        assert not a[n:].any() and not b[n:].any(), p


@requires_8
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipe2_data2_step_matches_jax_mesh_and_one_device(world, case):
    preset, model, train = CASES[case]
    jcfg, cfg = _cfgs(preset, model, train)
    jm, m = TT._models(world, jcfg, cfg)
    params0, jloss, jgrads, jstep_loss, jparams = _jax_mesh(world, jcfg, jm)
    params = params_from_jax(params0)
    loss, grads, after = _port_step(world, cfg, m, params,
                                    local_mesh(cfg.mesh))
    loss1, grads1, _ = _port_step(world, cfg.replace(mesh=MeshConfig()), m,
                                  params, None)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss, jstep_loss, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss, loss1, rtol=1e-4, atol=1e-5)
    assert set(grads) == set(jgrads)
    _close({p: g.numpy() for p, g in grads.items()}, jgrads, 2e-4, 2e-5)
    _close({p: g.numpy() for p, g in grads.items()},
           {p: g.numpy() for p, g in grads1.items()}, 2e-4, 2e-5)
    for p, want in jparams.items():
        got = after[p].float().numpy()
        n = got.shape[0]
        assert not want[n:].any(), p
        want = want[:n].reshape(got.shape)
        if p in grads1:
            # an element whose gradient is rounding noise moves by Adam's
            # lr times the noise's sign: held by its gradient above
            keep = grads1[p].abs().reshape(got.shape).numpy() >= 1e-6
            got, want = got[keep], want[keep]
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5,
                                   err_msg=p)


def test_pipe_mesh_composes_with_grad_accum(world):
    """G = 2 on pipe 2 x data 2 (4 microbatches a column inside each of
    the G): the whole batch's step of the single device (loss rtol 1e-4,
    the dense gradients rtol 2e-4 / atol 2e-5)."""
    _, cfg = _cfgs("hstu_flagship", dict(num_heads=1),
                   dict(tower_dedup=False), grad_accum=1)
    m = TT._models(world, *_cfgs("hstu_flagship", {}, {}))[1]
    params = m.init(torch.Generator().manual_seed(4))
    loss1, grads1, _ = _port_step(world, cfg.replace(mesh=MeshConfig()), m,
                                  params, None)
    cfg2 = cfg.replace(
        train=dataclasses.replace(cfg.train, grad_accum_steps=2),
        mesh=dataclasses.replace(cfg.mesh, pp_microbatches=2))
    loss, grads, _ = _port_step(world, cfg2, m, params,
                                local_mesh(cfg2.mesh))
    np.testing.assert_allclose(loss, loss1, rtol=1e-4)
    _close({p: g.numpy() for p, g in grads.items()},
           {p: g.numpy() for p, g in grads1.items()}, 2e-4, 2e-5)
