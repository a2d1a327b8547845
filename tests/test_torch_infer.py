"""cli.infer end to end, the port against the JAX package, on the CPU: both
read one checkpoint that the JAX package wrote, and their output files and
scores agree. Also the port's checkpoint writer and the packed-table
bridge."""

import json

import jax
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.cli import infer as JINF
from tencent_recommendation_2025_tpu.config import PRESETS
from tencent_recommendation_2025_tpu.data import formats
from tencent_recommendation_2025_tpu.data.featurizer import FusedVocab
from tencent_recommendation_2025_tpu.data.readers import TencentGRData
from tencent_recommendation_2025_tpu.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu.train.checkpoint import save_checkpoint
from tencent_recommendation_2025_tpu.train.trainer import (init_state,
                                                           make_optimizer)
from tencent_recommendation_2025_tpu_torch.bridge import (params_from_jax,
                                                          unpack_table)
from tencent_recommendation_2025_tpu_torch.cli import infer as TINF
from tencent_recommendation_2025_tpu_torch.train import checkpoint as TCK

torch.set_num_threads(2)

ARGS = ["--preset", "hstu_flagship", "--maxlen", "255", "--dtype", "float32",
        "--num_blocks", "2", "--device", "cpu", "--num_workers", "2"]


def _model_cfg():
    import dataclasses

    cfg = PRESETS["hstu_flagship"]()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, maxlen=255, dtype="float32", num_blocks=2))


@pytest.fixture(scope="module")
def runs(synth_dir, tmp_path_factory):
    """A JAX checkpoint of the cut flagship, served by both packages."""
    cfg = _model_cfg()
    data = TencentGRData(synth_dir, mm_emb_ids=("81",), split="test")
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema),
                        usernum=data.usernum, itemnum=data.itemnum)
    state = init_state(model, make_optimizer(cfg), 17, cfg=cfg)
    root = tmp_path_factory.mktemp("infer")
    save_checkpoint(root / "model", state, 7, model_config=cfg.model)
    out = {"params": state.params, "model_dir": root / "model"}
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("EVAL_DATA_PATH", str(synth_dir))
        mp.setenv("MODEL_OUTPUT_PATH", str(root / "model"))
        for name, mod in (("jax", JINF), ("torch", TINF)):
            res = root / name
            mp.setenv("EVAL_RESULT_PATH", str(res))
            top, users = mod.infer(ARGS)
            out[name] = {"dir": res, "top": top, "users": users}
    finally:
        mp.undo()
    return out


def test_output_files_agree(runs):
    j, t = runs["jax"]["dir"], runs["torch"]["dir"]
    for name in ("query.fbin", "embedding.fbin"):
        a, b = formats.load_fbin(j / name), formats.load_fbin(t / name)
        assert a.shape == b.shape and np.isfinite(b).all(), name
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(formats.load_u64bin(t / "id.u64bin"),
                                  formats.load_u64bin(j / "id.u64bin"))
    assert json.loads((t / "retrive_id2creative_id.json").read_text()) == \
        json.loads((j / "retrive_id2creative_id.json").read_text())


def test_top10_and_scores_agree(runs, synth_dir):
    jr, tr = runs["jax"], runs["torch"]
    assert jr["users"] == tr["users"]
    q = formats.load_fbin(jr["dir"] / "query.fbin")
    corpus = formats.load_fbin(jr["dir"] / "embedding.fbin")
    scores = np.sort(q @ corpus.T, axis=1)[:, ::-1]
    gap = np.diff(scores[:, :11], axis=1)
    compared = 0
    for u, (a, b) in enumerate(zip(jr["top"], tr["top"])):
        # ranks up to the first near-tie must agree exactly
        ties = np.nonzero(np.abs(gap[u]) < 1e-3)[0]
        upto = ties[0] if len(ties) else 10
        assert a[:upto] == b[:upto], u
        compared += upto
    assert compared > 5 * len(jr["top"])
    gt = json.loads((synth_dir / "ground_truth.json").read_text())
    from tencent_recommendation_2025_tpu_torch.retrieval.evaluator import \
        hr_ndcg_at_k
    mj = hr_ndcg_at_k(dict(zip(jr["users"], jr["top"])), gt, k=10)
    mt = hr_ndcg_at_k(dict(zip(tr["users"], tr["top"])), gt, k=10)
    assert mt == mj and mt["n"] == len(gt)


def test_main_prints_scores(runs, synth_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("EVAL_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("MODEL_OUTPUT_PATH", str(runs["model_dir"]))
    monkeypatch.setenv("EVAL_RESULT_PATH", str(tmp_path / "res"))
    timings = {}
    m = TINF.main(ARGS, timings=timings)
    assert f"HR@10={m['hr']:.4f} NDCG@10={m['ndcg']:.4f}" in \
        capsys.readouterr().out
    assert timings["n_queries"] == len(runs["torch"]["users"])
    assert timings["n_query_batches"] == 1


def test_checkpoint_reads_back_and_checks_config(runs, tmp_path):
    ckpt = TCK.latest_checkpoint(runs["model_dir"])
    assert ckpt.name.startswith("global_step7")
    params, meta = TCK.load_params(ckpt)
    ref = params_from_jax(jax.tree.map(np.asarray, runs["params"]))
    out = TCK.save_params(tmp_path / "ck", params, global_step=3,
                          model_config=_model_cfg().model)
    again, meta2 = TCK.load_params(out)
    flat_a = {k: v for k, v in _leaves(params)}
    assert flat_a.keys() == {k for k, _ in _leaves(again)} \
        == {k for k, _ in _leaves(ref)}
    for (k, a), (_, b), (_, c) in zip(_leaves(params), _leaves(again),
                                      _leaves(ref)):
        assert torch.equal(a, b) and torch.equal(a, c), k
    assert meta2["model_config"] == meta["model_config"]
    import dataclasses

    class Skewed:
        cfg = dataclasses.replace(_model_cfg().model, hidden_units=32)
        itemnum = 0

    with pytest.raises(ValueError, match="hidden_units"):
        TCK.load_params(out, Skewed())


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{pre}{k}/")
    else:
        yield pre, tree


def test_packed_table_unpacks(tmp_path):
    rng = np.random.default_rng(0)
    D, rows = 64, 101
    R = 8 * 128 // D
    groups = -(-rows // R)
    table = np.zeros((groups * R, D), np.float32)
    table[1:rows] = rng.standard_normal((rows - 1, D))
    packed = table.reshape(groups, 8, 128)
    np.testing.assert_array_equal(unpack_table(packed, D, rows),
                                  table[:rows])
    tree = {"item_emb": packed, "pos_emb": np.zeros((7, D), np.float32)}
    p = params_from_jax(tree, itemnum=rows - 1)
    np.testing.assert_array_equal(p["item_emb"].numpy(), table[:rows])
    # the same through a checkpoint directory
    TCK.save_params(tmp_path, {k: torch.from_numpy(v)
                               for k, v in tree.items()})
    q, _ = TCK.load_params(TCK.latest_checkpoint(tmp_path))
    assert q["item_emb"].shape == (groups * R, D)
    np.testing.assert_array_equal(q["item_emb"].numpy()[:rows], table[:rows])
