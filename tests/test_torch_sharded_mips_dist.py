"""Sharded serving and row-sharded static tables across processes
(tencent_recommendation_2025_tpu_torch/retrieval/mips.py,
parallel/sharded_embedding.py, cli/infer.py) on the CPU: groups of
processes joined by gloo, each the worker of this file run as a script.

- 2 processes (data 2) and 4 (data 2 x seq 2: 4 corpus shards, flattened;
  2 table shards): ``sharded_topk_mips`` (exact and approx) and
  ``sharded_topk_mips_int8`` on a process mesh equal one process's top-k,
  ids and scores; each rank holds one corpus shard of ceil(N / S) rows,
  sliced from the host corpus (an int8 shard quantized from its rows).
- The static tables on a process mesh: each rank holds ceil(V / S) rows of
  the item ``sparse`` and ``mm`` tables (``device_tables(..., mesh)``), and
  one step of hstu_flagship cut to D=16, 2 blocks, L=32, batch 8 (BCE, f32,
  dropout off) gives the local mesh's loss and parameters (the tables
  all-gathered) at rtol 1e-5 / atol 1e-5, as tests/test_torch_sharded_
  dist.py holds its steps.
- ``cli.infer --device cpu`` under the 2 processes (rank 0 encodes, every
  rank serves its rows of the corpus file) writes an ``id100.u64bin``
  byte-equal to one process's on the same checkpoint.

The groups run at once, started by a module fixture, each with a time
limit of its own."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = 150
#: name -> (processes, seq, what each worker runs)
GROUPS = {"two": (2, 1, "topk,static,infer"), "four": (4, 2, "topk,static")}
CORPUS = dict(N=1003, D=16, Q=24, k=10, seed=3)
INFER_ARGS = ["--preset", "baseline", "--maxlen", "31", "--hidden_units",
              "16", "--num_blocks", "1", "--num_heads", "2", "--dtype",
              "float32", "--device", "cpu", "--num_workers", "1",
              "--ann_method", "exact"]


# ---------------------------------------------------------------------------
# shared by the workers and the tests
# ---------------------------------------------------------------------------

def _corpus():
    c = CORPUS
    rng = np.random.default_rng(c["seed"])
    return (rng.standard_normal((c["Q"], c["D"])).astype(np.float32),
            rng.standard_normal((c["N"], c["D"])).astype(np.float32))


def _topk(mesh):
    """{tier: (scores, ids)} of the three tiers, on ``mesh`` or on one
    device, and the row counts of the shards this process holds."""
    from tencent_recommendation_2025_tpu_torch.retrieval import mips as TM

    q, c = _corpus()
    qt, k = torch.from_numpy(q), CORPUS["k"]
    if mesh is None:
        codes, scales = TM.quantize_corpus_int8(c, device="cpu")
        out = {"exact": TM.topk_mips(qt, torch.from_numpy(c), k=k),
               "approx": TM.topk_mips_approx(qt, torch.from_numpy(c), k=k,
                                             block_n=128),
               "int8": TM.topk_mips_int8(qt, codes, scales, k=k,
                                         block_n=128)}
        return out, {}
    f32 = TM.shard_corpus(mesh, c, device="cpu")
    i8 = TM.shard_corpus_int8(mesh, c, device="cpu")
    out = {"exact": TM.sharded_topk_mips(mesh, qt, f32, k=k),
           "approx": TM.sharded_topk_mips(mesh, qt, f32, k=k, block_n=128,
                                          approx=True),
           "int8": TM.sharded_topk_mips_int8(mesh, qt, i8, k=k,
                                             block_n=128)}
    held = {"f32": [list(s.shape) for s in f32.shards],
            "int8": [list(s[0].shape) for s in i8.shards]}
    return out, held


def _static_world(data_dir):
    import dataclasses

    from tencent_recommendation_2025_tpu_torch.config import PRESETS
    from tencent_recommendation_2025_tpu_torch.data.dataset import \
        TrainSampler
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.pipeline import \
        TrainLoader
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel

    cfg = PRESETS["hstu_flagship"]()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hidden_units=16, num_blocks=2,
                                  num_heads=2, maxlen=31, dtype="float32",
                                  dropout_rate=0.0),
        train=dataclasses.replace(cfg.train, batch_size=8, tower_dedup=False,
                                  loss_type="bce"))
    data = TencentGRData(data_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    batch = next(iter(TrainLoader(sampler, np.arange(len(sampler)), 8,
                                  seed=3, num_workers=1).epoch(1)))
    return cfg, model, tables, batch


def _static_step(data_dir, mesh):
    """(the static table blocks' shapes this process holds, the loss of
    one step with the static tables row-sharded, the parameters after it
    whole at their rows)."""
    from tencent_recommendation_2025_tpu_torch.parallel import \
        sharded_embedding as TSE
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg, model, tables, batch = _static_world(data_dir)
    tabs = TR.device_tables(tables, "cpu", mesh)
    held = {name: [list(b.shape) for b in t.blocks]
            for name, t in (("sparse", tabs["sparse"]),
                            ("mm", tabs["mm"]["81"]))
            if isinstance(t, TSE.StaticTable)}
    state = PT.init_sharded_state(model, cfg, mesh, seed=5, device="cpu")
    state, m = TR.make_train_step(model, cfg, mesh)(
        state, TR.put_batch(batch, "cpu"), tabs["mm"], tabs)
    state = PT.unpad_state(state, model, mesh)
    params = {p: t.detach().float() for p, t in
              TR.param_leaves(state.params)}
    return held, float(m["loss"]), params


def _checkpoint(data_dir, ckpt_dir):
    """A seeded checkpoint of the model ``cli.infer`` builds from
    INFER_ARGS on the test split."""
    import dataclasses

    from tencent_recommendation_2025_tpu_torch.cli import infer as TINF
    from tencent_recommendation_2025_tpu_torch.config import PRESETS
    from tencent_recommendation_2025_tpu_torch.data.featurizer import \
        FusedVocab
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    args = TINF.get_args(INFER_ARGS)
    cfg = PRESETS[args.preset]()
    model_cfg = dataclasses.replace(
        cfg.model, hidden_units=args.hidden_units,
        num_blocks=args.num_blocks, num_heads=args.num_heads,
        maxlen=args.maxlen, dtype=args.dtype)
    data = TencentGRData(data_dir, mm_emb_ids=("81",), split="test")
    schema = FeatureSchema.from_indexer(data.indexer, ("81",),
                                        cfg.features.array_cap)
    model = SeqRecModel(cfg=model_cfg, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    CK.save_params(ckpt_dir, model.init(torch.Generator().manual_seed(9)),
                   model_config=model_cfg)


# ---------------------------------------------------------------------------
# the worker: one process of a group, run as a script
# ---------------------------------------------------------------------------

def _worker(out_dir, data_dir, seq, what):
    import torch.distributed as dist

    from tencent_recommendation_2025_tpu_torch.cli import infer as TINF
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        build_mesh, initialize_distributed)

    torch.set_num_threads(1)
    initialize_distributed("cpu")
    mesh = build_mesh(MeshConfig(seq=seq))
    res = {}
    if "topk" in what:
        out, held = _topk(mesh)
        res["topk:held"] = json.dumps(held)
        for tier, (s, i) in out.items():
            res[f"topk:{tier}:scores"] = s.numpy()
            res[f"topk:{tier}:ids"] = i.numpy()
    if "static" in what:
        held, loss, params = _static_step(data_dir, mesh)
        res["static:held"] = json.dumps(held)
        res["static:loss"] = np.float64(loss)
        res.update({f"static:param:{p}": t.numpy()
                    for p, t in params.items()})
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **res)
    if "infer" in what:
        TINF.main(INFER_ARGS)      # leaves the process group at its end
    else:
        dist.barrier()
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(n, out_dir, data_dir, seq, what, env_extra):
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT), **env_extra)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(out_dir),
             str(data_dir), str(seq), what],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs, time.monotonic()


def _wait(group):
    procs, t0 = group
    outs = []
    for p in procs:
        left = max(1.0, GROUP_TIMEOUT - (time.monotonic() - t0))
        try:
            out, _ = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"process group exceeded {GROUP_TIMEOUT} s")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope="module")
def groups(synth_dir, tmp_path_factory):
    """Every process group, started at once, after the checkpoint that
    ``cli.infer`` serves is written."""
    root = tmp_path_factory.mktemp("sharded_mips_dist")
    _checkpoint(synth_dir, root / "ckpt")
    dirs = {k: root / k for k in GROUPS}
    started = {}
    for name, (n, seq, what) in GROUPS.items():
        dirs[name].mkdir()
        started[name] = _start(n, dirs[name], synth_dir, seq, what, {
            "EVAL_DATA_PATH": str(synth_dir),
            "MODEL_OUTPUT_PATH": str(root / "ckpt"),
            "EVAL_RESULT_PATH": str(dirs[name] / "res")})
    return started, dirs, {}, root


def _results(groups, name):
    started, dirs, outs, _ = groups
    if name not in outs:
        outs[name] = _wait(started[name])
    n = GROUPS[name][0]
    return [np.load(dirs[name] / f"rank{r}.npz") for r in range(n)], \
        outs[name]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_process_mesh_topk_equals_one_process(groups, group):
    ranks, _ = _results(groups, group)
    one, _ = _topk(None)
    n = GROUPS[group][0]
    rows = -(-CORPUS["N"] // n)
    for r in ranks:
        held = json.loads(str(r["topk:held"]))
        assert held == {"f32": [[rows, CORPUS["D"]]],
                        "int8": [[rows, CORPUS["D"]]]}
        for tier, (s, i) in one.items():
            np.testing.assert_array_equal(r[f"topk:{tier}:ids"], i.numpy(),
                                          err_msg=tier)
            np.testing.assert_allclose(r[f"topk:{tier}:scores"], s.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=tier)


_LOCAL = {}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_process_mesh_static_tables_hold_their_rows_and_step_as_local(
        groups, synth_dir, group):
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh

    n, seq, _ = GROUPS[group]
    S = n // seq
    ranks, _ = _results(groups, group)
    _, model, _, _ = _static_world(synth_dir)
    V = model.itemnum + 1
    if S not in _LOCAL:
        _LOCAL[S] = _static_step(synth_dir, local_mesh(MeshConfig(data=S)))
    local_held, local_loss, local = _LOCAL[S]
    assert local_held == {"sparse": [[-(-V // S), 14]] * S,
                          "mm": [[-(-V // S), 32]] * S}
    for r in ranks:
        held = json.loads(str(r["static:held"]))
        assert held == {"sparse": [[-(-V // S), 14]],
                        "mm": [[-(-V // S), 32]]}
        np.testing.assert_allclose(float(r["static:loss"]), local_loss,
                                   rtol=1e-5)
        for p, t in local.items():
            np.testing.assert_allclose(r[f"static:param:{p}"], t.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=p)


def test_cli_infer_under_two_processes_writes_one_processs_file(
        groups, synth_dir, tmp_path, monkeypatch):
    from tencent_recommendation_2025_tpu_torch.cli import infer as TINF

    _, outs = _results(groups, "two")
    _, dirs, _, root = groups
    monkeypatch.setenv("EVAL_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("MODEL_OUTPUT_PATH", str(root / "ckpt"))
    monkeypatch.setenv("EVAL_RESULT_PATH", str(tmp_path / "res"))
    m = TINF.main(INFER_ARGS)
    assert m is not None and "HR@10=" in outs[0]
    assert "HR@10=" not in outs[1]
    got = (dirs["two"] / "res" / "id100.u64bin").read_bytes()
    want = (tmp_path / "res" / "id100.u64bin").read_bytes()
    assert len(want) > 8 and got == want


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
