"""cli.semantic end to end on the CPU (``--device cpu``): both packages'
cli.semantic on one JAX-written checkpoint (the same pairs, the same item
representations: the exact-MIPS baseline's HR equal, the same
``semantic_eval.json`` keys), then the port's chain cli.train ->
cli.semantic -> cli.infer ``--ann_method semantic`` on the synthetic mini
split, with the reference's output files."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.cli import semantic as JSEM
from tencent_recommendation_2025_tpu.config import PRESETS
from tencent_recommendation_2025_tpu.data.featurizer import FusedVocab
from tencent_recommendation_2025_tpu.data.readers import TencentGRData
from tencent_recommendation_2025_tpu.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu.train.checkpoint import save_checkpoint
from tencent_recommendation_2025_tpu.train.trainer import (init_state,
                                                           make_optimizer)
from tencent_recommendation_2025_tpu_torch.cli import infer as TINF
from tencent_recommendation_2025_tpu_torch.cli import semantic as TSEM
from tencent_recommendation_2025_tpu_torch.cli import train as TTRAIN
from tencent_recommendation_2025_tpu_torch.data import formats

torch.set_num_threads(2)

MODEL = ["--preset", "hstu_flagship", "--maxlen", "255", "--num_blocks",
         "2", "--dtype", "float32"]
SEM = ["--rq_steps", "30", "--head_steps", "30", "--rq_codebook", "16",
       "--num_query_users", "32"]
EVAL_KEYS = {"rq_recon", "codes_used", "genret_train_hr",
             "genret_beam_train_hr", "mips_train_hr", "num_pairs"}


@pytest.fixture(scope="module")
def jax_ckpt(synth_dir, tmp_path_factory):
    cfg = PRESETS["hstu_flagship"]()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, maxlen=255, dtype="float32", num_blocks=2))
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema),
                        usernum=data.usernum, itemnum=data.itemnum)
    root = tmp_path_factory.mktemp("semantic_cli")
    save_checkpoint(root / "model", init_state(model, make_optimizer(cfg), 3,
                                               cfg=cfg),
                    5, model_config=cfg.model)
    return root, data.itemnum


def _run(mod, argv, monkeypatch, data, model_dir, res):
    monkeypatch.setenv("TRAIN_DATA_PATH", str(data))
    monkeypatch.setenv("MODEL_OUTPUT_PATH", str(model_dir))
    monkeypatch.setenv("EVAL_RESULT_PATH", str(res))
    mod.main(argv)
    return json.loads((res / "semantic_eval.json").read_text())


def test_semantic_cli_matches_jax_cli(jax_ckpt, synth_dir, monkeypatch):
    root, itemnum = jax_ckpt
    j = _run(JSEM, MODEL + SEM, monkeypatch, synth_dir, root / "model",
             root / "jax")
    t = _run(TSEM, MODEL + SEM + ["--device", "cpu"], monkeypatch, synth_dir,
             root / "model", root / "torch")
    assert set(j) == set(t) == EVAL_KEYS
    # the same (query, positive) pairs and item representations
    assert t["num_pairs"] == j["num_pairs"] > 0
    assert t["mips_train_hr"] == j["mips_train_hr"]
    for key in ("genret_train_hr", "genret_beam_train_hr"):
        assert 0.0 <= t[key] <= 1.0
    assert np.isfinite(t["rq_recon"]) and len(t["codes_used"]) == 3
    for name in ("jax", "torch"):
        ids = np.load(root / name / "semantic_ids.npy")
        assert ids.shape == (itemnum + 1, 3) and ids.dtype == np.int32
        assert (ids[0] == 0).all() and ids.min() >= 0 and ids.max() < 16


def test_semantic_cli_needs_cuda_or_cpu(jax_ckpt, synth_dir, monkeypatch):
    """Without a card, the default --device cuda raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default and runs")
    root, _ = jax_ckpt
    with pytest.raises(RuntimeError, match="--device cpu"):
        _run(TSEM, MODEL + SEM, monkeypatch, synth_dir, root / "model",
             root / "nocuda")


def test_train_semantic_infer_chain(synth_dir, tmp_path, monkeypatch):
    """The port's own chain: cli.train writes the checkpoint, cli.semantic
    the artifacts beside it, cli.infer --ann_method semantic serves them."""
    port = ["--preset", "hstu_flagship", "--maxlen", "255", "--hidden_units",
            "16", "--num_blocks", "2", "--dtype", "float32", "--device",
            "cpu"]
    monkeypatch.setenv("TRAIN_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("TRAIN_LOG_PATH", str(tmp_path / "logs"))
    monkeypatch.setenv("TRAIN_CKPT_PATH", str(tmp_path / "model"))
    TTRAIN.main(port + ["--batch_size", "8", "--num_epochs", "1",
                        "--num_workers", "2"])
    ev = _run(TSEM, port[:-2] + SEM + ["--device", "cpu"], monkeypatch,
              synth_dir, tmp_path / "model", tmp_path / "sem")
    assert set(ev) == EVAL_KEYS
    assert (tmp_path / "model" / "semantic").is_dir()
    ids = np.load(tmp_path / "sem" / "semantic_ids.npy")
    assert ids.shape[1] == 3 and ids.dtype == np.int32

    monkeypatch.setenv("EVAL_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("EVAL_RESULT_PATH", str(tmp_path / "res"))
    timings = {}
    m = TINF.main(port + ["--num_workers", "2", "--ann_method", "semantic",
                          "--beam_width", "8"], timings=timings)
    res = tmp_path / "res"
    for f in ("query.fbin", "embedding.fbin", "id.u64bin", "id100.u64bin",
              "retrive_id2creative_id.json"):
        assert (res / f).exists(), f
    top = np.asarray(formats.read_result_ids(res / "id100.u64bin"))
    ids_all = set(formats.load_u64bin(res / "id.u64bin")[:, 0].tolist())
    assert top.shape == (timings["n_queries"], 10)
    assert set(np.unique(top).tolist()) <= ids_all
    assert timings["topk_s"] > 0 and m is not None and 0 <= m["hr"] <= 1
