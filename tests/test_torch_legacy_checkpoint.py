"""The JAX package's legacy single-blob checkpoint layout (``state.msgpack``,
tencent_recommendation_2025_tpu/train/checkpoint.py:482-497) in the port's
``train.checkpoint.load_checkpoint``: a blob that
``flax.serialization.to_bytes`` writes here from the leaves of the JAX
trainer's own train state (``init_state(model, make_optimizer(cfg), seed,
cfg)``: parameters, optax adam / adamw state, step), filled with seeded
values, read by both packages' loaders into the same parameters, moments,
counts and row-optimizer state, for adamw and adam, a learning-rate
schedule and sparse-trained tables, whole and in flax's chunked form (its
chunk size cut so that the tables chunk); a leaf of another shape raises
``ValueError`` in both. The port's msgpack reader (``read_msgpack``) also
against flax's own restore on bf16, int and scalar leaves; the port's
loader in a process that imports neither ``msgpack`` nor ``flax`` nor
``jax``."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import flax.serialization as FS
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tencent_recommendation_2025_tpu import config as JC
from tencent_recommendation_2025_tpu.data.featurizer import \
    FusedVocab as JFused
from tencent_recommendation_2025_tpu.data.readers import TencentGRData as JData
from tencent_recommendation_2025_tpu.data.schema import FeatureSchema as JSch
from tencent_recommendation_2025_tpu.models.baseline import \
    SeqRecModel as JModel
from tencent_recommendation_2025_tpu.train import checkpoint as JCK
from tencent_recommendation_2025_tpu.train import trainer as JTR
from tencent_recommendation_2025_tpu_torch import config as TC
from tencent_recommendation_2025_tpu_torch.bridge import _flatten
from tencent_recommendation_2025_tpu_torch.data.featurizer import FusedVocab
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

ROOT = Path(__file__).resolve().parents[1]
MODEL = dict(hidden_units=16, num_blocks=1, num_heads=2, maxlen=15,
             dtype="float32")
#: train settings that change the JAX optimizer state's tree: adamw with a
#: constant rate (no schedule state), adam under a warm-up schedule (its
#: count at ``1/1``), adamw under a cosine schedule (``1/2``) beside lazy
#: adam tables, and a row-wise adagrad table
TRAINS = {"adamw": {},
          "adam_warmup": dict(weight_decay=0.0, lr_warmup_steps=5),
          "sparse_cosine": dict(lr_schedule="cosine",
                                sparse_tables=("item_emb", "fused_feat")),
          "adagrad_table": dict(sparse_tables=("item_emb",),
                                table_optimizer="rowwise_adagrad")}


def _cfgs(train):
    return tuple(pkg.Config(model=pkg.ModelConfig(**MODEL),
                            train=pkg.TrainConfig(batch_size=4, **train))
                 for pkg in (JC, TC))


@pytest.fixture(scope="module")
def models(synth_dir):
    jdata = JData(synth_dir, mm_emb_ids=("81",))
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    jcfg, cfg = _cfgs({})
    return (JModel(cfg=jcfg.model, schema=jschema, fused=JFused.build(jschema),
                   usernum=jdata.usernum, itemnum=jdata.itemnum),
            SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum))


def _jax_state(jmodel, jcfg, seed=3):
    """The JAX trainer's train state for ``jcfg``, every array leaf filled
    with its own seeded values (moments non-negative where optax keeps
    squares), the counts and the step 7."""
    st = JTR.init_state(jmodel, JTR.make_optimizer(jcfg), 3, cfg=jcfg)
    rng = np.random.default_rng(seed)

    def fill(path, x):
        x = np.asarray(x)
        if x.ndim == 0:
            return np.asarray(7, x.dtype)
        v = rng.standard_normal(x.shape).astype(x.dtype)
        keys = [str(getattr(k, "key", getattr(k, "name", ""))) for k in path]
        return np.abs(v) if {"nu", "acc"} & set(keys) else v

    return jax.tree_util.tree_map_with_path(fill, st)


def _write(tmp, state, name="ck"):
    """A legacy checkpoint directory: ``to_bytes`` of the state's leaves in
    JAX's leaf order."""
    d = tmp / name
    d.mkdir()
    (d / JCK.CKPT_FILE).write_bytes(FS.to_bytes(
        [np.asarray(x) for x in jax.tree.leaves(state)]))
    return d


def _same(port_state, jax_state, cfg):
    """The port's train state holds the JAX one's leaves: the parameters,
    each dense leaf's AdamW moments and step (optax's mu, nu and count),
    the tables' row state and the step."""
    want = {p: np.asarray(v) for p, v in _flatten(jax_state.params).items()}
    got = _flatten(port_state.params)
    assert list(got) == list(want)
    for p, t in got.items():
        np.testing.assert_array_equal(t.detach().numpy(), want[p],
                                      err_msg=p)
    opt = jax_state.opt_state
    adam = (opt["dense"] if cfg.train.sparse_tables else opt)[0]
    dense = TTR.dense_leaves(port_state.params, cfg)
    assert len(dense) == len(_flatten(adam.mu))
    for p, t in dense:
        st = port_state.opt.state[t]
        assert int(st["step"]) == int(adam.count) == 7
        for k, m in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            np.testing.assert_array_equal(
                st[k].numpy(), np.asarray(_flatten(m)[p]), err_msg=f"{k} {p}")
    for name, ts in port_state.tables.items():
        for k, t in ts.items():
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(opt["tables"][name][k]),
                err_msg=f"{name}/{k}")
    assert port_state.step == int(jax_state.step) == 7


@pytest.mark.parametrize("train,chunked", [
    ("adamw", False), ("adamw", True), ("adam_warmup", False),
    ("sparse_cosine", False), ("adagrad_table", True)])
def test_both_loaders_read_the_same_leaves(models, tmp_path, monkeypatch,
                                           train, chunked):
    """The directory (and the blob file itself) of the JAX trainer's state
    loads into the leaves the JAX loader restores; with flax's chunk size
    cut to 256 bytes every table is written as chunks."""
    jmodel, model = models
    jcfg, cfg = _cfgs(TRAINS[train])
    jstate = _jax_state(jmodel, jcfg)
    if chunked:
        monkeypatch.setattr(FS, "MAX_CHUNK_SIZE", 256)
    d = _write(tmp_path, jstate)
    if chunked:
        assert b"__msgpack_chunked_array__" in (d / JCK.CKPT_FILE).read_bytes()
    template = JTR.init_state(jmodel, JTR.make_optimizer(jcfg), 0, cfg=jcfg)
    jax_back, _ = JCK.load_checkpoint(d, template)
    for where in (d, d / CK.CKPT_FILE):
        state, meta = CK.load_checkpoint(where, model, cfg)
        assert meta == {}
        _same(state, jax_back, cfg)
        _same(state, jstate, cfg)


def test_a_leaf_of_another_shape_raises(models, tmp_path):
    jmodel, model = models
    jcfg, cfg = _cfgs({})
    jstate = _jax_state(jmodel, jcfg)
    bad = JTR.TrainState(dict(jstate.params, pos_emb=np.zeros((3, 16),
                                                               np.float32)),
                         jstate.opt_state, jstate.step)
    d = _write(tmp_path, bad)
    template = JTR.init_state(jmodel, JTR.make_optimizer(jcfg), 0, cfg=jcfg)
    with pytest.raises(ValueError, match="shape"):
        JCK.load_checkpoint(d, template)
    with pytest.raises(ValueError, match="pos_emb"):
        CK.load_checkpoint(d, model, cfg)


def test_reader_matches_flax_restore(tmp_path):
    """bf16, int32 and int64 arrays, numpy and python scalars, strings and
    nesting, whole and chunked: the port's reader gives flax's values (a
    bf16 array as its uint16 bits)."""
    rng = np.random.default_rng(1)
    tree = {"a": jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16),
            "b": {"c": np.arange(-40, 40, dtype=np.int32).reshape(8, 10),
                  "d": np.float32(2.5), "e": 3, "f": 1.25, "g": "name",
                  "h": np.arange(300, dtype=np.int64)}}
    for size in (FS.MAX_CHUNK_SIZE, 64):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(FS, "MAX_CHUNK_SIZE", size)
            blob = FS.to_bytes(tree)
        want = FS.msgpack_restore(blob)
        got = CK.read_msgpack(blob)
        a, bf16 = CK._unchunk(got["a"])
        assert bf16 and np.array_equal(
            a, np.asarray(want["a"]).view(np.uint16))
        for k in "cdh":
            v, bf16 = CK._unchunk(got["b"][k])
            assert not bf16 and v.dtype == np.asarray(want["b"][k]).dtype
            np.testing.assert_array_equal(v, want["b"][k])
        assert [got["b"][k] for k in "efg"] == [3, 1.25, "name"]


def test_loader_imports_no_msgpack_flax_or_jax(models, tmp_path,
                                              synth_dir):
    """``load_checkpoint`` reads a blob into the model's train state in a
    process where msgpack, flax and jax are never imported."""
    d = _write(tmp_path, _jax_state(models[0], _cfgs({})[0]))
    code = (
        "import sys\n"
        "from tencent_recommendation_2025_tpu_torch.config import (\n"
        "    Config, ModelConfig, TrainConfig)\n"
        "from tencent_recommendation_2025_tpu_torch.data.featurizer import "
        "FusedVocab\n"
        "from tencent_recommendation_2025_tpu_torch.data.readers import "
        "TencentGRData\n"
        "from tencent_recommendation_2025_tpu_torch.data.schema import "
        "FeatureSchema\n"
        "from tencent_recommendation_2025_tpu_torch.models.baseline import "
        "SeqRecModel\n"
        "from tencent_recommendation_2025_tpu_torch.train import "
        "checkpoint as CK\n"
        # CFG, written out: the process builds the fixture's model
        "cfg = Config(model=ModelConfig(hidden_units=16, num_blocks=1,\n"
        "                               num_heads=2, maxlen=15,\n"
        "                               dtype='float32'),\n"
        "             train=TrainConfig(batch_size=4))\n"

        f"data = TencentGRData({str(synth_dir)!r}, mm_emb_ids=('81',))\n"
        "schema = FeatureSchema.from_indexer(data.indexer, ('81',), 8)\n"
        "model = SeqRecModel(cfg=cfg.model, schema=schema,\n"
        "                    fused=FusedVocab.build(schema),\n"
        "                    usernum=data.usernum, itemnum=data.itemnum)\n"
        f"state, _ = CK.load_checkpoint({str(d)!r}, model, cfg)\n"
        "assert state.step == 7, state.step\n"
        "bad = {'msgpack', 'flax', 'jax'} & set(sys.modules)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
