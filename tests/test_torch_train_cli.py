"""The port's cli.train end to end on the CPU (``--device cpu``), then the
port's cli.infer on the checkpoint it wrote: the flow of tests/test_e2e.py
through the port's entry points, on the synthetic mini split."""

import json

import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.cli import infer as TINF
from tencent_recommendation_2025_tpu_torch.cli import train as TTRAIN
from tencent_recommendation_2025_tpu_torch.train import checkpoint as TCK

torch.set_num_threads(2)

MODEL = ["--preset", "hstu_flagship", "--maxlen", "255", "--hidden_units",
         "16", "--num_blocks", "2", "--dtype", "float32", "--device", "cpu",
         "--num_workers", "2"]


@pytest.fixture(scope="module")
def trained(synth_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TRAIN_DATA_PATH", str(synth_dir))
        mp.setenv("TRAIN_LOG_PATH", str(root / "logs"))
        mp.setenv("TRAIN_CKPT_PATH", str(root / "ckpt"))
        state = TTRAIN.main(MODEL + ["--batch_size", "8", "--num_epochs",
                                     "2", "--lr", "1e-2"])
    finally:
        mp.undo()
    return root, state


def test_train_log_and_loss(trained):
    root, state = trained
    lines = [json.loads(ln) for ln in open(root / "logs" / "train.log")]
    assert lines and all(
        k in lines[0] for k in ("global_step", "epoch", "step", "loss",
                                "bce", "step_time", "steps_per_second"))
    epochs = sorted({ln["epoch"] for ln in lines})
    assert epochs == [1, 2]
    mean = {e: np.mean([ln["loss"] for ln in lines if ln["epoch"] == e])
            for e in epochs}
    assert mean[2] < mean[1]
    assert state.step == lines[-1]["global_step"]


def test_checkpoint_layout_and_resume(trained, synth_dir):
    root, state = trained
    ck = TCK.latest_checkpoint(root / "ckpt")
    assert ck is not None and ck.name.startswith(
        f"global_step{state.step}.valid_loss=")
    params = params_from_jax(ck)
    for (path, a), (_, b) in zip(
            sorted(TCK._flatten(params).items()),
            sorted(TCK._flatten(state.params).items())):
        assert torch.equal(a, b.detach()), path
    meta = json.loads((ck / "meta.json").read_text())
    assert meta["epoch"] == 2 and meta["model_config"]["hidden_units"] == 16
    # --state_dict_path restores parameters, AdamW moments and the step;
    # both epochs are done, so nothing more trains
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TRAIN_DATA_PATH", str(synth_dir))
        again = TTRAIN.main(MODEL + ["--batch_size", "8", "--num_epochs",
                                     "2", "--state_dict_path", str(ck)])
    finally:
        mp.undo()
    assert again.step == state.step
    leaves = TCK._flatten(state.params)
    for path, t in TCK._flatten(again.params).items():
        assert torch.equal(t.detach(), leaves[path].detach()), path
        a, b = again.opt.state[t], state.opt.state[leaves[path]]
        assert torch.equal(a["exp_avg"], b["exp_avg"]), path
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]), path


def test_infer_on_trained_checkpoint(trained, synth_dir, tmp_path,
                                     monkeypatch):
    root, _ = trained
    monkeypatch.setenv("EVAL_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("MODEL_OUTPUT_PATH", str(root / "ckpt"))
    monkeypatch.setenv("EVAL_RESULT_PATH", str(tmp_path / "res"))
    m = TINF.main(MODEL)
    gt = json.loads((synth_dir / "ground_truth.json").read_text())
    assert m["n"] == len(gt)
    # tiny corpus: must beat the random-retrieval floor (10/100)
    assert m["hr"] > 0.15, m


@pytest.mark.parametrize("method", ["approx", "int8", "hnsw"])
def test_infer_ann_methods_on_trained_checkpoint(trained, synth_dir,
                                                 tmp_path, monkeypatch,
                                                 method):
    """``cli.infer --ann_method`` serves the checkpoint through each tier:
    approx's top 10 equal exact's, int8's and hnsw's hold >= 0.9 of them
    (hnsw falls back to exact where the tool cannot be built, as in the
    JAX package)."""
    from tencent_recommendation_2025_tpu_torch.data import formats

    root, _ = trained
    monkeypatch.setenv("EVAL_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("MODEL_OUTPUT_PATH", str(root / "ckpt"))
    results = {}
    for m in ("exact", method):
        monkeypatch.setenv("EVAL_RESULT_PATH", str(tmp_path / m))
        TINF.main(MODEL + ["--ann_method", m])
        results[m] = np.asarray(formats.read_result_ids(
            tmp_path / m / "id100.u64bin"))
    got, want = results[method], results["exact"]
    assert got.shape == want.shape
    if method == "approx":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.mean([len(set(g) & set(w)) / len(w)
                        for g, w in zip(got, want)]) >= 0.9
