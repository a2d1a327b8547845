"""Checkpoints, resume and restarts in the port (tencent_recommendation_2025_
tpu_torch/train/{checkpoint,supervisor,trainer}.py): the single-device cases
of tests/test_resilience.py on the port's train state, on the CPU (D=32, 2
blocks, maxlen 20, batch 8: 4 steps an epoch). A preempted run resumed with
``skip_steps`` is bitwise equal to the uninterrupted one here. A train
state the JAX trainer wrote after 2 steps continues in the port: one more
step in both packages lands within tests/test_torch_ring_dist.py's Adam
tolerance (rtol 1e-5, atol 1e-5: 1% of the learning rate), with optax
adam, adamw under a cosine schedule, and sparse lazy-Adam and rowwise
Adagrad tables (the latter at packed scale)."""

import dataclasses
import json
import os
import re
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import PRESETS as JPRESETS
from tencent_recommendation_2025_tpu.data.dataset import \
    TrainSampler as JSampler
from tencent_recommendation_2025_tpu.data.featurizer import \
    FusedVocab as JFused
from tencent_recommendation_2025_tpu.data.pipeline import \
    TrainLoader as JLoader
from tencent_recommendation_2025_tpu.data.readers import TencentGRData as JData
from tencent_recommendation_2025_tpu.data.schema import FeatureSchema as JSch
from tencent_recommendation_2025_tpu.models.baseline import \
    SeqRecModel as JModel
from tencent_recommendation_2025_tpu.ops import sparse_table as JST
from tencent_recommendation_2025_tpu.train import checkpoint as JCK
from tencent_recommendation_2025_tpu.train import trainer as JTR
from tencent_recommendation_2025_tpu_torch.config import (
    PRESETS, Config, ModelConfig, TrainConfig)
from tencent_recommendation_2025_tpu_torch.data.dataset import TrainSampler
from tencent_recommendation_2025_tpu_torch.data.featurizer import (
    FusedVocab, build_item_tables)
from tencent_recommendation_2025_tpu_torch.data.pipeline import (
    TrainLoader, train_val_split)
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.ops import sparse_table as TST
from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR
from tencent_recommendation_2025_tpu_torch.train.supervisor import (
    FaultInjected, run_supervised)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world(synth_dir):
    cfg = Config(model=ModelConfig(hidden_units=32, num_blocks=2, num_heads=2,
                                   maxlen=20, dtype="float32"),
                 train=TrainConfig(batch_size=8, num_epochs=1))
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    tr, _ = train_val_split(len(sampler), 0.1, 0)
    loader = TrainLoader(sampler, tr, cfg.train.batch_size, seed=0)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    return dict(cfg=cfg, model=model, loader=loader, tables=tables,
                data=data, schema=schema)


def _state(w):
    return TTR.init_state(w["model"], w["cfg"], device="cpu")


def _steps(w, state, batches):
    tabs = TTR.device_tables(w["tables"], "cpu")
    step = TTR.make_train_step(w["model"], w["cfg"])
    for b in batches:
        state, _ = step(state, TTR.put_batch(b, "cpu"), tabs["mm"], tabs)
    return state


def _load(w, path):
    return CK.load_checkpoint(path, w["model"], w["cfg"], device="cpu")


def _check_equal(a, b, exact=False):
    for (name, x), (_, y) in zip(TTR.param_leaves(a.params),
                                 TTR.param_leaves(b.params)):
        if exact:
            assert torch.equal(x, y), name
        else:
            np.testing.assert_allclose(x.detach().numpy(),
                                       y.detach().numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def _ckpt_step(path):
    return int(re.match(r"global_step(\d+)", path.name).group(1))


def _loop(w, loader, **kw):
    return TTR.train_loop(w["model"], w["cfg"], loader, None, w["tables"],
                          verbose=False, device="cpu", **kw)


def test_checkpoint_resume_continues_exactly(world, tmp_path):
    """4 steps straight == 2 steps, a checkpoint, a load and 2 more."""
    w = world
    batches = list(w["loader"].epoch(0))[:4]
    full = _steps(w, _state(w), batches)
    a = _steps(w, _state(w), batches[:2])
    CK.save_checkpoint(tmp_path, a, global_step=2, valid_loss=0.5,
                       model_config=w["model"].cfg)
    b, meta = _load(w, CK.latest_checkpoint(tmp_path))
    assert meta["global_step"] == 2 and b.step == 2
    b = _steps(w, b, batches[2:])
    _check_equal(full, b)


def test_atomic_checkpoint_ignores_tmp(world, tmp_path):
    CK.save_checkpoint(tmp_path, _state(world), global_step=5)
    (tmp_path / "global_step9.valid_loss=0.0000.tmp").mkdir()
    assert CK.latest_checkpoint(tmp_path).name.startswith("global_step5")


def test_supervisor_restarts_from_checkpoint(world, tmp_path):
    w = world
    batches = list(w["loader"].epoch(0))[:4]
    calls = {"n": 0}

    def train_fn(resume, attempt):
        calls["n"] += 1
        state = resume if resume is not None else _state(w)
        for i, b in enumerate(batches[state.step:], start=state.step):
            if attempt == 0 and i == 2:
                raise FaultInjected("injected host failure at step 2")
            state = _steps(w, state, [b])
            CK.save_checkpoint(tmp_path, state, global_step=i + 1)
        return state

    final = run_supervised(train_fn, tmp_path, w["model"], w["cfg"],
                           max_restarts=2, verbose=False, device="cpu")
    assert calls["n"] == 2 and final.step == 4
    _check_equal(_steps(w, _state(w), batches), final)


def test_supervisor_gives_up_after_max_restarts(world, tmp_path):
    def always_fail(resume, attempt):
        raise FaultInjected("permafail")

    with pytest.raises(FaultInjected):
        run_supervised(always_fail, tmp_path, world["model"], world["cfg"],
                       max_restarts=2, verbose=False, device="cpu")


def test_async_save_and_kill_during_save(world, tmp_path, monkeypatch):
    """The async save holds the state of the moment it was called, though
    the next step updates the state in place before the files are written
    (the writer thread waits for it here); a crash mid-write (the test hook)
    leaves only a .tmp directory, which latest_checkpoint passes over."""
    w = world
    batches = list(w["loader"].epoch(0))[:2]
    s = _steps(w, _state(w), batches[:1])
    CK.save_checkpoint(tmp_path / "sync", s, global_step=3, valid_loss=0.9,
                       model_config=w["model"].cfg)
    stepped, write = threading.Event(), CK._write

    def write_after_the_step(*a, **k):
        assert stepped.wait(60)
        return write(*a, **k)

    monkeypatch.setattr(CK, "_write", write_after_the_step)
    h = CK.save_checkpoint_async(tmp_path / "async", s, global_step=3,
                                 valid_loss=0.9, model_config=w["model"].cfg)
    s = _steps(w, s, batches[1:])         # in place, before the write
    stepped.set()
    path = h.result(timeout=60)
    monkeypatch.setattr(CK, "_write", write)
    assert path.name.startswith("global_step3")
    sync = CK.latest_checkpoint(tmp_path / "sync")
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest == json.loads((sync / "manifest.json").read_text())
    for e in manifest["leaves"]:
        np.testing.assert_array_equal(np.load(path / e["file"]),
                                      np.load(sync / e["file"]),
                                      err_msg=e["path"])
    restored, meta = _load(w, path)
    assert meta["model_config"]["hidden_units"] == w["model"].cfg.hidden_units
    assert restored.step == 1 and s.step == 2
    assert not torch.equal(restored.params["item_emb"], s.params["item_emb"])

    with pytest.raises(RuntimeError, match="injected"):
        CK.save_checkpoint(tmp_path / "async", s, global_step=7,
                           _fault_after_files=2)
    latest = CK.latest_checkpoint(tmp_path / "async")
    assert latest is not None and latest.name.startswith("global_step3")
    assert (tmp_path / "async" / "global_step7.valid_loss=0.0000.tmp").exists()


def test_load_rejects_config_skew(world, tmp_path):
    w = world
    CK.save_checkpoint(tmp_path, _state(w), global_step=1,
                       model_config=w["model"].cfg)
    skewed = dataclasses.replace(
        w["model"], cfg=dataclasses.replace(w["model"].cfg, hidden_units=128))
    with pytest.raises(ValueError, match="hidden_units"):
        CK.load_checkpoint(CK.latest_checkpoint(tmp_path), skewed, w["cfg"])


def test_load_rejects_structure_change(world, tmp_path):
    """A parameter tree that is not the model's fails by leaf path, even
    where no shape differs."""
    w = world
    s = _state(w)
    s.params = {**s.params, "new_head": s.params["pos_emb"]}
    CK.save_checkpoint(tmp_path, s, global_step=1)
    with pytest.raises(ValueError, match="structure mismatch"):
        _load(w, CK.latest_checkpoint(tmp_path))


class _FaultyLoader:
    """Wraps a loader; raises once at (epoch, step), a host failure
    mid-epoch."""

    def __init__(self, inner, fail_epoch, fail_step):
        self.inner = inner
        self.fail_epoch, self.fail_step = fail_epoch, fail_step
        self.armed = True

    def __len__(self):
        return len(self.inner)

    def epoch(self, e):
        for i, b in enumerate(self.inner.epoch(e)):
            if self.armed and e == self.fail_epoch and i == self.fail_step:
                self.armed = False
                raise FaultInjected(f"injected failure epoch {e} step {i}")
            yield b


def test_resume_runs_only_remaining_epochs(world, tmp_path):
    """A crash in epoch 2 after epoch 1's (async) checkpoint: the crash
    path joined the save, the resume trains epoch 2 only, to the
    uninterrupted run's parameters; a finished run resumes to nothing."""
    w = world
    n = len(w["loader"])
    full = _loop(w, w["loader"], num_epochs=2)
    ckpt = tmp_path / "ckpt"
    with pytest.raises(FaultInjected):
        _loop(w, _FaultyLoader(w["loader"], 2, 1), ckpt_dir=str(ckpt),
              num_epochs=2)
    latest = CK.latest_checkpoint(ckpt)
    assert latest is not None and _ckpt_step(latest) == n
    restored, meta = _load(w, latest)
    assert meta["epoch"] == 1 and restored.step == n
    res = _loop(w, w["loader"], ckpt_dir=str(ckpt), state=restored,
                start_epoch=meta["epoch"], num_epochs=2)
    assert res.step == 2 * n
    final = CK.latest_checkpoint(ckpt)
    assert _ckpt_step(final) == 2 * n
    assert _load(w, final)[1]["epoch"] == 2
    _check_equal(full, res)
    done = _loop(w, w["loader"], state=res, start_epoch=2, num_epochs=2)
    assert done.step == 2 * n


def test_supervisor_resumes_remaining_epochs(world, tmp_path):
    """run_supervised hands the restored meta to a train_fn of three
    parameters: the restart trains the epochs left, to the budget."""
    w = world
    n = len(w["loader"])
    faulty = _FaultyLoader(w["loader"], 2, 1)
    calls = []

    def train_fn(resume, attempt, meta):
        se = int(meta.get("epoch", 0)) if meta else 0
        calls.append(se)
        return _loop(w, faulty, ckpt_dir=str(tmp_path), state=resume,
                     start_epoch=se, skip_steps=int((meta or {}).get(
                         "epoch_step", 0)), num_epochs=2)

    final = run_supervised(train_fn, tmp_path, w["model"], w["cfg"],
                           max_restarts=2, verbose=False, device="cpu")
    assert calls == [0, 1] and final.step == 2 * n
    assert _ckpt_step(CK.latest_checkpoint(tmp_path)) == 2 * n


class _SignalingLoader:
    """Sends this process SIGTERM at (epoch 2, step 1); the loop's handler
    lets the step in flight finish."""

    def __init__(self, inner):
        self.inner = inner
        self.armed = True

    def __len__(self):
        return len(self.inner)

    def epoch(self, e):
        for i, b in enumerate(self.inner.epoch(e)):
            if self.armed and e == 2 and i == 1:
                self.armed = False
                os.kill(os.getpid(), signal.SIGTERM)
            yield b


def test_sigterm_checkpoints_and_resumes_bitwise(world, tmp_path):
    """SIGTERM mid-epoch: the step in flight ends, a synchronous checkpoint
    records the last whole epoch and the steps into the next, the loop
    returns and the previous handler is back; the resume with skip_steps
    trains the rest to the uninterrupted run's parameters, bitwise."""
    w = world
    n = len(w["loader"])
    full = _loop(w, w["loader"], num_epochs=2)
    ckpt = tmp_path / "ck"
    prev = signal.getsignal(signal.SIGTERM)
    pre = _loop(w, _SignalingLoader(w["loader"]), ckpt_dir=str(ckpt),
                num_epochs=2)
    assert signal.getsignal(signal.SIGTERM) == prev
    restored, meta = _load(w, CK.latest_checkpoint(ckpt))
    assert meta.get("preempted") is True and meta["epoch"] == 1
    # the prefetch runs ahead of the consumer: the stop lands a step or
    # two after the signal, and the state agrees with the meta
    assert meta["epoch_step"] >= 1
    assert restored.step == pre.step == n + meta["epoch_step"] < 2 * n
    res = _loop(w, w["loader"], state=restored, start_epoch=meta["epoch"],
                skip_steps=meta["epoch_step"], num_epochs=2)
    assert res.step == 2 * n
    _check_equal(full, res, exact=True)


# ---------------------------------------------------------------------------
# a train state the JAX trainer wrote
# ---------------------------------------------------------------------------

JAX_MODEL = dict(hidden_units=32, num_blocks=2, maxlen=31, dropout_rate=0.0,
                 dtype="float32")
DENSE = dict(sparse_tables=(), tower_dedup=False, loss_type="bce",
             l2_emb=1e-3)
JAX_CASES = {
    "adam": dict(DENSE, weight_decay=0.0),
    "adamw-cosine": dict(DENSE, weight_decay=0.01, lr_schedule="cosine",
                         lr_warmup_steps=1, lr_total_steps=5),
    "lazy_adam": dict(table_optimizer="lazy_adam", tower_dedup=False,
                      loss_type="bce", l2_emb=1e-3),
    "rowwise_adagrad-packed": dict(sparse_tables=("item_emb", "user_emb"),
                                   table_optimizer="rowwise_adagrad",
                                   tower_dedup=False, loss_type="bce"),
}


def _jcfgs(case):
    out = []
    for presets in (JPRESETS, PRESETS):
        cfg = presets["sharded_multihost"]()
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model, **JAX_MODEL),
            train=dataclasses.replace(cfg.train, batch_size=4,
                                      **JAX_CASES[case])))
    return out


@pytest.fixture(scope="module")
def jax_batches(synth_dir):
    jdata = JData(synth_dir, mm_emb_ids=("81",))
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    loader = JLoader(JSampler(jdata, jschema, JAX_MODEL["maxlen"]),
                     np.arange(len(jdata.seq)), 4, seed=1, num_workers=2)
    return jdata, jschema, [b for _, b in zip(range(3), loader.epoch(1))]


def _np(v, D):
    """A JAX leaf as the port holds it: a packed table as [Vp, D]."""
    v = np.asarray(v, np.float32)
    return v.reshape(-1, D) if JST.is_packed(v) else v


def _flat(tree, D):
    return {"/".join(str(k.key) for k in path): _np(v, D)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_jax_written_state_continues_in_port(world, jax_batches, case,
                                             tmp_path, monkeypatch):
    if case.endswith("packed"):
        monkeypatch.setattr(JST, "TABLE_PACK_MIN_ROWS", 1)
        monkeypatch.setattr(TST, "TABLE_PACK_MIN_ROWS", 1)
    jdata, jschema, raw = jax_batches
    jcfg, cfg = _jcfgs(case)
    jm = JModel(cfg=jcfg.model, schema=jschema, fused=JFused.build(jschema),
                usernum=jdata.usernum, itemnum=jdata.itemnum)
    m = SeqRecModel(cfg=cfg.model, schema=world["schema"],
                    fused=FusedVocab.build(world["schema"]),
                    usernum=world["data"].usernum,
                    itemnum=world["data"].itemnum)

    def prep(TR, c, b, i):
        if not c.train.sparse_tables:
            return b
        return TR.augment_batch_sparse(b, c, jdata.itemnum,
                                       (c.train.seed, 97, 1, i),
                                       usernum=jdata.usernum)

    tx = JTR.make_optimizer(jcfg)
    js = JTR.init_state(jm, tx, 3, cfg=jcfg)
    jstep = JTR.make_train_step(jm, tx, jcfg)
    from tencent_recommendation_2025_tpu.data.featurizer import \
        build_item_tables as jbuild
    jtab = JTR.device_tables(jbuild(jdata.item_feat_dict, jdata.itemnum,
                                    jschema, jdata.mm_emb_dict,
                                    jdata.indexer_i_rev))
    for i, b in enumerate(raw[:2]):
        js, _ = jstep(js, jax.device_put(prep(JTR, jcfg, b, i)), jtab["mm"],
                      jtab, jax.random.key(0))
    path = JCK.save_checkpoint(tmp_path, js, 2, model_config=jcfg.model)
    paths = [e["path"] for e in
             json.loads((path / "manifest.json").read_text())["leaves"]]
    assert (("1/2/count" in paths) == (case == "adamw-cosine"))
    assert any(p.startswith("1/tables/") for p in paths) == \
        bool(cfg.train.sparse_tables)

    state, meta = CK.load_checkpoint(path, m, cfg, device="cpu")
    assert state.step == 2 and meta["global_step"] == 2
    D = cfg.model.hidden_units
    if case.endswith("packed"):
        assert state.params["item_emb"].shape[0] == \
            TST.padded_table_rows(m.itemnum + 1)
    tabs = TTR.device_tables(world["tables"], "cpu")
    state, pm = TTR.make_train_step(m, cfg)(
        state, TTR.put_batch(prep(TTR, cfg, raw[2], 2), "cpu"), tabs["mm"],
        tabs)
    js, jm3 = jstep(js, jax.device_put(prep(JTR, jcfg, raw[2], 2)),
                    jtab["mm"], jtab, jax.random.key(0))
    assert state.step == int(js.step) == 3
    np.testing.assert_allclose(float(pm["loss"]), float(jm3["loss"]),
                               rtol=1e-4)
    ref = _flat(js.params, D)
    for name, p in TTR.param_leaves(state.params):
        np.testing.assert_allclose(p.detach().float().numpy(), ref[name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    jopt = js.opt_state["tables"] if cfg.train.sparse_tables else {}
    for name, opt in state.tables.items():
        for k, v in opt.items():
            np.testing.assert_allclose(
                v.float().numpy(), _np(jopt[name][k], D),
                rtol=1e-5, atol=1e-7, err_msg=f"{name}/{k}")


# ---------------------------------------------------------------------------
# cli.train: preempted, then resumed by --state_dict_path
# ---------------------------------------------------------------------------

CLI = ["--preset", "hstu_flagship", "--maxlen", "255", "--hidden_units", "16",
       "--num_blocks", "2", "--dtype", "float32", "--device", "cpu",
       "--num_workers", "2", "--batch_size", "8", "--dropout_rate", "0.0",
       "--loader", "native", "--num_epochs", "2"]


def test_cli_preempt_and_resume_with_grad_accum(synth_dir, tmp_path,
                                                monkeypatch, capsys):
    """cli.train with gradient accumulation on the native pack, sent
    SIGTERM in epoch 2, then run again with --state_dict_path: it resumes
    mid-epoch and ends on the uninterrupted run's parameters, bitwise. The
    config drops tower dedup, which G > 1 refuses."""
    from tencent_recommendation_2025_tpu_torch.cli import train as TTRAIN
    from tencent_recommendation_2025_tpu_torch.config import PRESETS as P
    from tencent_recommendation_2025_tpu_torch.data import cached_dataset

    flagship = P["hstu_flagship"]
    monkeypatch.setitem(P, "hstu_flagship", lambda: flagship().replace(
        train=dataclasses.replace(flagship().train, tower_dedup=False)))
    monkeypatch.setenv("TRAIN_DATA_PATH", str(synth_dir))
    argv = CLI + ["--grad_accum_steps", "2"]

    def run(name, extra=()):
        monkeypatch.setenv("TRAIN_LOG_PATH", str(tmp_path / name / "logs"))
        monkeypatch.setenv("TRAIN_CKPT_PATH", str(tmp_path / name / "ckpt"))
        return TTRAIN.main(argv + list(extra))

    full = run("full")
    epoch = cached_dataset.CachedTrainLoader.epoch
    armed = {"on": True}

    def signalling(self, e, prep=None):
        for i, b in enumerate(epoch(self, e, prep=prep)):
            if armed["on"] and self.shuffle and e == 2 and i == 1:
                armed["on"] = False
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    monkeypatch.setattr(cached_dataset.CachedTrainLoader, "epoch",
                        signalling)
    pre = run("pre")
    monkeypatch.setattr(cached_dataset.CachedTrainLoader, "epoch", epoch)
    assert not armed["on"] and pre.step < full.step
    ckpt = CK.latest_checkpoint(tmp_path / "pre" / "ckpt")
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["preempted"] and meta["epoch"] == 1 and meta["epoch_step"] >= 1
    capsys.readouterr()
    res = run("pre", ["--state_dict_path", str(ckpt)])
    assert f"+{meta['epoch_step']} steps into the next" in \
        capsys.readouterr().out
    assert res.step == full.step
    _check_equal(full, res, exact=True)
