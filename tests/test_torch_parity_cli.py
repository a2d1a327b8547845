"""The port's entry points on the reference's own models, on the CPU
(``--device cpu``): cli.train with no ``--preset`` (the default,
``baseline``: the reference's run.sh contract) and with ``--preset
baseline_o1``, one epoch at small width, then cli.infer on the checkpoint
each wrote."""

import json

import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu_torch.cli import infer as TINF
from tencent_recommendation_2025_tpu_torch.cli import train as TTRAIN
from tencent_recommendation_2025_tpu_torch.data import formats
from tencent_recommendation_2025_tpu_torch.train import checkpoint as TCK

torch.set_num_threads(2)

SMALL = ["--hidden_units", "16", "--num_blocks", "2", "--dtype", "float32",
         "--device", "cpu", "--num_workers", "2"]


@pytest.mark.parametrize("preset", [None, "baseline_o1"])
def test_train_then_infer(preset, synth_dir, tmp_path, monkeypatch):
    args = SMALL + (["--preset", preset] if preset else [])
    monkeypatch.setenv("TRAIN_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("TRAIN_LOG_PATH", str(tmp_path / "logs"))
    monkeypatch.setenv("TRAIN_CKPT_PATH", str(tmp_path / "ckpt"))
    state = TTRAIN.main(args + ["--batch_size", "8", "--num_epochs", "1"])
    lines = [json.loads(ln) for ln in open(tmp_path / "logs" / "train.log")]
    assert len(lines) == state.step > 0
    assert np.isfinite([ln["loss"] for ln in lines]).all()
    ck = TCK.latest_checkpoint(tmp_path / "ckpt")
    meta = json.loads((ck / "meta.json").read_text())["model_config"]
    # the default preset is the reference BaseLine: post-LN softmax MHA,
    # ReLU FFN, 4 heads, window 101 (L=102, the dense route)
    assert (meta["block_type"], meta["norm_first"], meta["maxlen"]) == \
        ("mha", False, 101)
    assert (meta["num_heads"], meta["ffn_type"]) == \
        ((1, "swiglu") if preset else (4, "relu"))
    assert "attn" in state.params["blocks"]

    monkeypatch.setenv("EVAL_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("MODEL_OUTPUT_PATH", str(tmp_path / "ckpt"))
    monkeypatch.setenv("EVAL_RESULT_PATH", str(tmp_path / "res"))
    m = TINF.main(args)
    gt = json.loads((synth_dir / "ground_truth.json").read_text())
    assert m["n"] == len(gt)
    queries = formats.load_fbin(tmp_path / "res" / "query.fbin")
    assert queries.shape == (len(gt), 16) and np.isfinite(queries).all()
