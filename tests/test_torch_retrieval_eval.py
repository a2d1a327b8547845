"""The port's epoch-end retrieval eval (``train.eval_retrieval_users``,
tencent_recommendation_2025_tpu_torch/train/trainer.py::make_retrieval_eval)
against the JAX package's (tests/test_e2e.py::test_epoch_end_retrieval_eval):
the same bridged parameters and validation batches give the same HR@k,
NDCG@k and user count on a corpus of 8,192 items (a multiple of the JAX
package's 8,192-row encode chunk, so its zero-id padding rows do not exist
there); and cli.train logs the metric every epoch."""

import dataclasses
import json

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
from tencent_recommendation_2025_tpu_torch.cli import train as TTRAIN
from tencent_recommendation_2025_tpu_torch.config import PRESETS
from tencent_recommendation_2025_tpu_torch.data import synthetic
from tencent_recommendation_2025_tpu_torch.data.dataset import TrainSampler
from tencent_recommendation_2025_tpu_torch.data.featurizer import (
    FusedVocab, build_item_tables)
from tencent_recommendation_2025_tpu_torch.data.pipeline import TrainLoader
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)

ITEMS = 8192


def _cfg(presets):
    cfg = presets["hstu_flagship"]()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, hidden_units=16, num_blocks=2, maxlen=31,
        dropout_rate=0.0, dtype="float32"))


class _Batches:
    """A validation loader over fixed batches."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, _):
        return iter(self.batches)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_8192")
    synthetic.generate(d, num_users=40, num_items=ITEMS, min_seq=5,
                       max_seq=20, seed=3)
    return d


@pytest.mark.parametrize("k,max_users", [(10, 64), (1000, 24)])
def test_retrieval_eval_matches_jax(corpus_dir, k, max_users):
    """HR@k, NDCG@k and n equal the JAX package's from the same parameters
    and batches; k=1000 makes both metrics nonzero at random weights and
    NDCG reads every hit's rank. max_users 24 stops inside the second
    batch."""
    jcfg, cfg = _cfg(JPRESETS), _cfg(PRESETS)
    jdata = JData(corpus_dir, mm_emb_ids=("81",))
    assert jdata.itemnum % 8192 == 0
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    jtab = jbuild(jdata.item_feat_dict, jdata.itemnum, jschema,
                  jdata.mm_emb_dict, jdata.indexer_i_rev)
    jmodel = JModel(cfg=jcfg.model, schema=jschema,
                    fused=JFused.build(jschema), usernum=jdata.usernum,
                    itemnum=jdata.itemnum)
    jparams = jmodel.init(jax.random.key(2))
    data = TencentGRData(corpus_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    tab = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                            data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    valid = _Batches(list(TrainLoader(sampler, np.arange(40), 16, seed=0,
                                      shuffle=False).epoch(0)))

    dtab = JTR.device_tables(jtab)
    want = JTR.make_retrieval_eval(jmodel, dtab, dtab["mm"], jax.device_put,
                                   max_users=max_users, k=k)(jparams, valid)
    tabs = TTR.device_tables(tab, "cpu")
    got = TTR.make_retrieval_eval(
        model, tabs, tabs["mm"], lambda b: TTR.put_batch(b, "cpu"),
        max_users=max_users, k=k)(
            params_from_jax(jax.tree.map(np.asarray, jparams)), valid)
    assert got["n"] == want["n"] == min(max_users, got["n"]) > 0
    np.testing.assert_allclose(got["hr"], want["hr"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["ndcg"], want["ndcg"], rtol=1e-6)
    if k == 1000:
        assert got["hr"] > 0 and got["ndcg"] > 0


def test_cli_train_logs_retrieval_eval_every_epoch(synth_dir, tmp_path,
                                                   capsys, monkeypatch):
    """``--eval_retrieval_users N`` logs HR@10 / NDCG@10 of up to N
    validation users at the end of every epoch: to stdout and as
    ``retrieval_eval`` records of the JSONL log."""
    monkeypatch.setenv("TRAIN_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("TRAIN_LOG_PATH", str(tmp_path / "logs"))
    monkeypatch.setenv("TRAIN_CKPT_PATH", str(tmp_path / "ckpt"))
    TTRAIN.main(["--preset", "hstu_flagship", "--maxlen", "31",
                 "--hidden_units", "16", "--num_blocks", "2", "--dtype",
                 "float32", "--device", "cpu", "--num_workers", "2",
                 "--batch_size", "8", "--num_epochs", "2",
                 "--eval_retrieval_users", "16"])
    out = capsys.readouterr().out
    lines = [json.loads(ln) for ln in open(tmp_path / "logs" / "train.log")]
    evs = [ln for ln in lines if ln.get("event") == "retrieval_eval"]
    assert [e["epoch"] for e in evs] == [1, 2]
    for e in evs:
        assert 0.0 <= e["ndcg"] <= e["hr"] + 1e-9 <= 1.0 + 1e-9
        assert 0 < e["n"] <= 16
    assert out.count("HR@10") == 2
