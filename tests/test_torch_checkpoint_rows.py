"""The learned tables' rows on load (tencent_recommendation_2025_tpu_torch/
train/checkpoint.py, ``convert_rows``), against the JAX loader's rules
(``_convert_layout``, ``_repad_rows``):

- a checkpoint trained on another vocabulary raises in ``load_checkpoint``
  and in ``load_params`` (a 101-row ``item_emb`` into models of itemnum 300
  and 60; trained surplus rows), where it used to load and read the last
  row for every id past its table; shard padding converts;
- the port's versions of tests/test_resilience.py:156, 191 and 222, each on
  the same arrays through the JAX loader and the port's rules: packed and
  logical layouts both ways with the 1-D accumulator, genuine skew raising,
  trained surplus rows refused and zero ones cut;
- a table at packed scale keeps its Vp rows in a train state and serves
  its itemnum + 1."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.train import checkpoint as JCK
from tencent_recommendation_2025_tpu_torch.config import (Config, ModelConfig,
                                                          TrainConfig)
from tencent_recommendation_2025_tpu_torch.data.featurizer import FusedVocab
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.ops import sparse_table as TST
from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

CFG = Config(model=ModelConfig(hidden_units=16, num_blocks=1, num_heads=2,
                               maxlen=15, dtype="float32"),
             train=TrainConfig(batch_size=4))


@pytest.fixture(scope="module")
def saved(synth_dir, tmp_path_factory):
    """A model of the fixture's 100 items (a 101-row item_emb), and its
    train state and parameters written."""
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    model = SeqRecModel(cfg=CFG.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    assert model.itemnum == 100
    root = tmp_path_factory.mktemp("rows")
    state = TTR.init_state(model, CFG)
    ck = CK.save_checkpoint(root / "state", state, 1, model_config=model.cfg)
    return dict(model=model, state=state, ck=ck)


def _load(kind, ck, model):
    if kind == "state":
        return CK.load_checkpoint(ck, model, CFG)[0].params
    return CK.load_params(ck, model)[0]


@pytest.mark.parametrize("kind", ["state", "params"])
@pytest.mark.parametrize("itemnum", [300, 60])
def test_other_vocabulary_is_refused(saved, kind, itemnum):
    """The re-anchor's probe: 101 rows into 301 or 61 (skew >= 32)."""
    model = dataclasses.replace(saved["model"], itemnum=itemnum)
    with pytest.raises(ValueError, match="item_emb"):
        _load(kind, saved["ck"], model)


@pytest.mark.parametrize("kind", ["state", "params"])
def test_surplus_trained_rows_are_refused_and_padding_converts(saved, kind):
    """101 rows into 97: the 4 cut rows hold trained data, refused. Into
    105: zero-extended (shard padding's direction), the 101 rows kept; the
    train state's AdamW moments of the table follow."""
    with pytest.raises(ValueError, match="NOT all zero"):
        _load(kind, saved["ck"],
              dataclasses.replace(saved["model"], itemnum=96))
    grown = dataclasses.replace(saved["model"], itemnum=104)
    p = _load(kind, saved["ck"], grown)
    want = saved["state"].params["item_emb"].detach()
    assert p["item_emb"].shape == (105, 16)
    assert torch.equal(p["item_emb"][:101].detach(), want)
    assert not p["item_emb"][101:].any()
    same = _load(kind, saved["ck"], saved["model"])
    assert torch.equal(same["item_emb"].detach(), want)


def test_moments_follow_the_table(saved, tmp_path):
    """A state after a step (AdamW moments on item_emb) into 105 rows: the
    moments zero-extend with the table."""
    state = TTR.init_state(saved["model"], CFG)
    for p in state.opt.param_groups[0]["params"]:
        p.grad = torch.ones_like(p)
    state.opt.step()
    ck = CK.save_checkpoint(tmp_path, state, 1,
                            model_config=saved["model"].cfg)
    grown = dataclasses.replace(saved["model"], itemnum=104)
    got, _ = CK.load_checkpoint(ck, grown, CFG)
    table = got.params["item_emb"]
    m = got.opt.state[table]["exp_avg"]
    assert m.shape == (105, 16) and m[:101].abs().min() > 0
    assert not m[101:].any()


# ---------------------------------------------------------------------------
# tests/test_resilience.py:156, 191, 222 on the port's rules
# ---------------------------------------------------------------------------

def _jax_load(tmp, name, arrays, target):
    """The JAX loader's result for ``arrays`` saved and loaded into
    ``target`` ({leaf: numpy result}, or the ValueError's text)."""
    JCK.save_checkpoint(tmp / name, {k: jnp.asarray(v)
                                     for k, v in arrays.items()},
                        global_step=1)
    try:
        got, _ = JCK.load_checkpoint(JCK.latest_checkpoint(tmp / name),
                                     {k: jnp.zeros(s)
                                      for k, s in target.items()})
    except ValueError as e:
        return str(e)
    return {k: np.asarray(v) for k, v in got.items()}


def _port(arrays, target):
    """The port's rules on the same arrays, the targets in the port's
    layout (a packed [G, 8, 128] target as its [G * R, D] rows)."""
    out = {}
    try:
        for k, v in arrays.items():
            shape = target[k]
            if len(shape) == 3:
                shape = (shape[0] * 8 * 128 // v.shape[-1], v.shape[-1])
            got = CK.convert_rows(torch.from_numpy(v), shape, k)
            if got is None:
                raise ValueError(f"checkpoint leaf {k!r} shape {v.shape} "
                                 "!= model shape")
            out[k] = got.numpy()
    except ValueError as e:
        return str(e)
    return out


def _same(jax_out, port_out, packed=()):
    if isinstance(jax_out, str):
        assert isinstance(port_out, str), port_out
        for text in ("NOT all zero", "shape"):
            assert (text in jax_out) == (text in port_out), \
                (jax_out, port_out)
        return
    assert not isinstance(port_out, str), port_out
    for k, v in jax_out.items():
        want = v.reshape(port_out[k].shape) if k in packed else v
        np.testing.assert_array_equal(port_out[k], want, err_msg=k)


def test_checkpoint_converts_between_table_layouts(tmp_path):
    """Logical [100, 64] into the packed 128-row layout and back, with the
    1-D accumulator (its 28 zero rows added, then cut)."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((100, 64)).astype(np.float32)
    logical = {"item_emb": table, "acc": np.ones((100,), np.float32)}
    packed_t = {"item_emb": (8, 8, 128), "acc": (128,)}
    to_packed = _jax_load(tmp_path, "u", logical, packed_t)
    _same(to_packed, _port(logical, packed_t), packed=("item_emb",))
    unpacked = to_packed["item_emb"].reshape(128, 64)
    np.testing.assert_array_equal(unpacked[:100], table)
    assert (unpacked[100:] == 0).all()
    back_t = {"item_emb": (100, 64), "acc": (100,)}
    back = _jax_load(tmp_path, "p", to_packed, back_t)
    _same(back, _port(to_packed, back_t))
    np.testing.assert_array_equal(back["item_emb"], table)
    assert (back["acc"] == 1).all()


def test_layout_conversion_rejects_genuine_skew(tmp_path):
    """Twice the rows, or a 1-D skew of 60, raise the shape error; a 1-D
    surplus of trained rows raises; a mesh's zero shard padding (104 ->
    100) converts."""
    zeros = {"item_emb": np.zeros((100, 64), np.float32),
             "acc": np.zeros((100,), np.float32)}
    for i, target in enumerate(({"item_emb": (16, 8, 128), "acc": (100,)},
                                {"item_emb": (100, 64), "acc": (160,)})):
        out = _jax_load(tmp_path, f"skew{i}", zeros, target)
        assert "shape" in out
        _same(out, _port(zeros, target))
    trained = {"acc": np.ones((108,), np.float32)}
    out = _jax_load(tmp_path, "acc1", trained, {"acc": (100,)})
    assert "NOT all zero" in out
    _same(out, _port(trained, {"acc": (100,)}))
    padded = {"acc": np.concatenate([np.ones(100), np.zeros(4)])
              .astype(np.float32)}
    out = _jax_load(tmp_path, "acc2", padded, {"acc": (100,)})
    assert (out["acc"] == 1).all()
    _same(out, _port(padded, {"acc": (100,)}))


def test_row_cut_refuses_trained_rows(tmp_path):
    """A [104, 64] table into 100 rows: refused where the 4 surplus rows are
    trained, cut where they are zero."""
    trained = {"item_emb": np.ones((104, 64), np.float32)}
    out = _jax_load(tmp_path, "bad", trained, {"item_emb": (100, 64)})
    assert "NOT all zero" in out
    _same(out, _port(trained, {"item_emb": (100, 64)}))
    padded = {"item_emb": np.concatenate([np.ones((100, 64)),
                                          np.zeros((4, 64))])
              .astype(np.float32)}
    out = _jax_load(tmp_path, "ok", padded, {"item_emb": (100, 64)})
    assert (out["item_emb"] == 1).all()
    _same(out, _port(padded, {"item_emb": (100, 64)}))


def test_packed_scale_table_keeps_its_vp_rows(saved, tmp_path, monkeypatch):
    """With every table at packed scale (TABLE_PACK_MIN_ROWS = 1, D = 16:
    101 rows pad to 256), a sparse-trained state loads with its Vp rows,
    its row accumulator too, and serves its 101 (the 155 zero pad rows
    cut); a trained pad row is refused."""
    monkeypatch.setattr(TST, "TABLE_PACK_MIN_ROWS", 1)
    cfg = CFG.replace(model=dataclasses.replace(CFG.model,
                                                pack_big_tables=True),
                      train=dataclasses.replace(
                          CFG.train, sparse_tables=("item_emb",),
                          table_optimizer="rowwise_adagrad"))
    model = dataclasses.replace(saved["model"], cfg=cfg.model)
    state = TTR.init_state(model, cfg)
    assert state.params["item_emb"].shape == (256, 16)
    state.tables["item_emb"]["acc"][:101] = 1.0
    ck = CK.save_checkpoint(tmp_path / "a", state, 1, model_config=model.cfg)
    got, _ = CK.load_checkpoint(ck, model, cfg)
    assert torch.equal(got.params["item_emb"], state.params["item_emb"])
    assert torch.equal(got.tables["item_emb"]["acc"],
                       state.tables["item_emb"]["acc"])
    served, _ = CK.load_params(ck, model)
    assert torch.equal(served["item_emb"], state.params["item_emb"][:101])
    state.params["item_emb"][200] = 1.0
    bad = CK.save_checkpoint(tmp_path / "b", state, 1,
                             model_config=model.cfg)
    with pytest.raises(ValueError, match="NOT all zero"):
        CK.load_params(bad, model)
