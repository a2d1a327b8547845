"""The port's cli.train on the two presets whose mesh wants several devices
(``sampled_softmax_dp``: data=8, sampled softmax with 64 in-batch negatives
and tower dedup; ``sharded_multihost``: 4x2, sparse item_emb with rowwise
Adagrad, sampled softmax, tower dedup): on one device they train
single-device with the JAX CLI's warning, write a checkpoint (with the
table's row-optimizer state) that resumes, and the port's cli.infer serves
it. Small widths on the synthetic mini split, ``--device cpu``."""

import json

import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu_torch.cli import infer as TINF
from tencent_recommendation_2025_tpu_torch.cli import train as TTRAIN
from tencent_recommendation_2025_tpu_torch.config import PRESETS
from tencent_recommendation_2025_tpu_torch.train import checkpoint as TCK
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

torch.set_num_threads(2)

SMALL = ["--maxlen", "31", "--hidden_units", "16", "--num_blocks", "2",
         "--dtype", "float32", "--device", "cpu", "--num_workers", "2"]


def _train(preset, synth_dir, root, capsys, *extra):
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TRAIN_DATA_PATH", str(synth_dir))
        mp.setenv("TRAIN_LOG_PATH", str(root / "logs"))
        mp.setenv("TRAIN_CKPT_PATH", str(root / "ckpt"))
        state = TTRAIN.main(["--preset", preset, "--batch_size", "8",
                             "--num_epochs", "1", *SMALL, *extra])
    finally:
        mp.undo()
    return state, capsys.readouterr().out


@pytest.mark.parametrize("preset,want", [("sampled_softmax_dp", 8),
                                         ("sharded_multihost", 8)])
def test_mesh_preset_trains_single_device_and_serves(preset, want, synth_dir,
                                                     tmp_path, capsys,
                                                     monkeypatch):
    state, out = _train(preset, synth_dir, tmp_path, capsys)
    assert f"WARNING: preset wants {want} devices but only 1 present — " \
        "training single-device" in out
    lines = [json.loads(ln) for ln in open(tmp_path / "logs" / "train.log")]
    assert state.step == len(lines) > 0
    assert all(np.isfinite(ln["loss"]) for ln in lines)
    sparse = PRESETS[preset]().train.sparse_tables
    assert set(state.tables) == set(sparse)
    ck = TCK.latest_checkpoint(tmp_path / "ckpt")
    assert ck.name.startswith(f"global_step{state.step}.")
    if sparse:
        # the row-optimizer state is saved and restored with the step
        assert state.tables["item_emb"]["acc"].abs().sum() > 0
        again, _ = _train(preset, synth_dir, tmp_path, capsys,
                          "--state_dict_path", str(ck))
        assert again.step == state.step
        assert torch.equal(again.tables["item_emb"]["acc"],
                           state.tables["item_emb"]["acc"])
        assert torch.equal(again.params["item_emb"],
                           state.params["item_emb"])
    monkeypatch.setenv("EVAL_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("MODEL_OUTPUT_PATH", str(tmp_path / "ckpt"))
    monkeypatch.setenv("EVAL_RESULT_PATH", str(tmp_path / "res"))
    m = TINF.main(["--preset", preset, *SMALL])
    gt = json.loads((synth_dir / "ground_truth.json").read_text())
    assert m["n"] == len(gt) and 0.0 <= m["hr"] <= 1.0


def test_check_supported_raises_only_on_what_is_not_ported():
    import dataclasses

    cfg = PRESETS["sharded_multihost"]()
    TTR.check_supported(cfg)            # cfg.mesh 4x2: trains single-device
    with pytest.raises(TypeError, match="is not a mesh"):
        TTR.check_supported(cfg, mesh=object())
    # gradient accumulation is ported; on sparse tables the JAX guard holds
    with pytest.raises(ValueError, match="dense tables only"):
        TTR.check_supported(cfg.replace(
            train=dataclasses.replace(cfg.train, grad_accum_steps=2)))
    # the epoch-end retrieval eval is ported
    TTR.check_supported(cfg.replace(
        train=dataclasses.replace(cfg.train, eval_retrieval_users=8)))
    with pytest.raises(ValueError, match="sparse_tables"):
        TTR.check_supported(cfg.replace(train=dataclasses.replace(
            cfg.train, sparse_tables=("fused_feat",))))


@pytest.mark.parametrize("present", [1, 4, 8])
def test_single_device_warning(present):
    """The JAX CLI's text where the mesh's devices are missing; one that
    still says it trains single-device where they are present."""
    text = TTRAIN.single_device_warning(8, present)
    assert text.startswith("WARNING: preset wants 8 devices")
    assert text.endswith("— training single-device")
    assert (f"but only {present} present" in text) == (present < 8)


class _ProcessMesh:
    """A stand-in for parallel.mesh.ProcessMesh: several processes."""

    process = True
    rank = data_index = 0

    def __init__(self, **shape):
        self.shape = dict({"pipe": 1, "data": 1, "model": 1, "seq": 1},
                          **shape)


_REFUSED = {
    "pipe > 1": ("hstu_flagship", dict(pipe=2, seq=2)),
    "pipe with model": ("hstu_flagship", dict(pipe=2, model=2)),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_process_mesh_refuses_what_it_does_not_cover(case):
    """Under several processes a pipe axis with a seq or a model axis
    raises ``ValueError``, as the JAX ``build_mesh`` asserts (pipe > 1
    composes with data only), rather than training each process on its
    own."""
    preset, shape = _REFUSED[case]
    with pytest.raises(ValueError, match=r"model=seq=1"):
        TTR.check_supported(PRESETS[preset](), mesh=_ProcessMesh(**shape))


_COVERED = {
    "model > 1": ("hstu_flagship", dict(model=2, seq=2), {}),
    # sharded_multihost on its preset's own mesh: model = 2 is tensor
    # parallelism, its sparse tables row-shard over data x model
    "sparse tables": ("sharded_multihost", dict(data=4, model=2), {}),
    "seq with data": ("hstu_flagship", dict(data=2, seq=2), {}),
    "data-only mesh": ("hstu_flagship", dict(data=2), {}),
    "sampled softmax on data": ("sampled_softmax_dp", dict(data=8), {}),
    "sampled softmax on data x seq": ("sampled_softmax_dp",
                                      dict(data=2, seq=2), {}),
    "G=2 on a data mesh": ("hstu_flagship", dict(data=8),
                           dict(grad_accum_steps=2, tower_dedup=False)),
    "G=2 on a seq mesh": ("hstu_flagship", dict(seq=2),
                          dict(grad_accum_steps=2, tower_dedup=False)),
    # sparse tables on any data mesh, with or without seq (row-sharded)
    "sparse tables on seq": ("sharded_multihost", dict(seq=2), {}),
    "sparse tables on data": ("sharded_multihost", dict(data=4), {}),
    "sparse tables on data x seq": ("sharded_multihost",
                                    dict(data=2, seq=2), {}),
    # pipeline parallelism: a pipe axis alone or with data
    "pipe 2": ("hstu_flagship", dict(pipe=2), {}),
    "pipe 2 x data 2": ("hstu_flagship", dict(pipe=2, data=2), {}),
    "sparse tables on pipe x data": ("sharded_multihost",
                                     dict(pipe=2, data=2), {}),
    "G=2 on a pipe mesh": ("hstu_flagship", dict(pipe=2, data=2),
                           dict(grad_accum_steps=2, tower_dedup=False)),
}


@pytest.mark.parametrize("case", sorted(_COVERED))
def test_process_mesh_covers_seq_with_data(case):
    """What a process mesh trains: data, model and seq axes alone or
    together, a pipe axis alone or with data, the sampled softmax on them,
    G > 1 on any, sparse tables on any of them (sharded_multihost's own
    data 4 x model 2)."""
    import dataclasses

    preset, shape, train = _COVERED[case]
    cfg = PRESETS[preset]()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train))
    TTR.check_supported(cfg, mesh=_ProcessMesh(**shape))


def test_cli_under_several_processes_refuses_a_data_only_mesh(
        synth_dir, tmp_path, monkeypatch, capsys):
    """Once refused, a data-only preset now forms its mesh and trains:
    cli.train with WORLD_SIZE > 1 builds the mesh from the preset's
    (data=8) before the model and trains on it, without the single-device
    warning. The process group is mocked here: the mesh built is a local
    one of 2 data shards (one process, the stacked tower-dedup plan); the
    real processes run in tests/test_torch_dp_dist.py."""
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel import mesh as PM

    built = []

    def build(cfg):
        built.append(cfg)
        return PM.local_mesh(MeshConfig(data=2))

    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setattr(PM, "initialize_distributed", lambda device: True)
    monkeypatch.setattr(PM, "build_mesh", build)
    monkeypatch.setenv("TRAIN_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("TRAIN_LOG_PATH", str(tmp_path / "logs"))
    monkeypatch.setenv("TRAIN_CKPT_PATH", str(tmp_path / "ckpt"))
    state = TTRAIN.main(["--preset", "sampled_softmax_dp", "--batch_size",
                         "8", "--num_epochs", "1", *SMALL])
    out = capsys.readouterr().out
    assert [c.data for c in built] == [8]
    assert "mesh: {'pipe': 1, 'data': 2, 'model': 1, 'seq': 1}" in out
    assert "training single-device" not in out
    assert "tower_dedup needs" not in out      # stacked on the data shards
    lines = [json.loads(ln) for ln in open(tmp_path / "logs" / "train.log")]
    assert state.step == len(lines) > 0
    assert all(np.isfinite(ln["loss"]) for ln in lines)
    assert TCK.latest_checkpoint(tmp_path / "ckpt").name.startswith(
        f"global_step{state.step}.")
