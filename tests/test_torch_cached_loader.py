"""The port's packed-cache loader (tencent_recommendation_2025_tpu_torch/
data/cached_dataset.py) against the JAX package's, and cli.train taking it
(``--loader cached``, and ``auto``) on the CPU."""

import json

import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.data import cached_dataset as JC
from tencent_recommendation_2025_tpu.data import dataset as JD
from tencent_recommendation_2025_tpu.data import readers as JR
from tencent_recommendation_2025_tpu.data.pipeline import \
    train_val_split as jsplit
from tencent_recommendation_2025_tpu.data.schema import \
    FeatureSchema as JSchema
from tencent_recommendation_2025_tpu_torch.cli import train as TTRAIN
from tencent_recommendation_2025_tpu_torch.data import cached_dataset as TC
from tencent_recommendation_2025_tpu_torch.data import dataset as TD
from tencent_recommendation_2025_tpu_torch.data import readers as TR
from tencent_recommendation_2025_tpu_torch.data.pipeline import \
    train_val_split as tsplit
from tencent_recommendation_2025_tpu_torch.data.schema import \
    FeatureSchema as TSchema
from tencent_recommendation_2025_tpu_torch.train import checkpoint as TCK

torch.set_num_threads(2)

MAXLEN = 20


def _cache(R, Schema, D, C, synth_dir):
    data = R.TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = Schema.from_indexer(data.indexer, mm_emb_ids=("81",),
                                 array_cap=8)
    return C.PackedCache(D.TrainSampler(data, schema, MAXLEN), num_workers=2)


@pytest.fixture(scope="module")
def caches(synth_dir):
    return (_cache(JR, JSchema, JD, JC, synth_dir),
            _cache(TR, TSchema, TD, TC, synth_dir))


def test_packed_cache_matches_jax(caches):
    jc, tc = caches
    assert len(jc) == len(tc) > 8
    assert jc.fields.keys() == tc.fields.keys()
    for k in jc.fields:
        np.testing.assert_array_equal(jc.fields[k], tc.fields[k], err_msg=k)
    np.testing.assert_array_equal(jc.seen_sets.vals, tc.seen_sets.vals)
    np.testing.assert_array_equal(jc.seen_sets.offs, tc.seen_sets.offs)
    np.testing.assert_array_equal(jc.neg_ok, tc.neg_ok)


@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_match_jax_for_two_epochs(caches, shuffle):
    """Same seed, same batches, field by field, negatives included."""
    jc, tc = caches
    jtr, jva = jsplit(len(jc), 0.1, 42)
    ttr, tva = tsplit(len(tc), 0.1, 42)
    np.testing.assert_array_equal(jtr, ttr)
    idx = jtr if shuffle else jva
    jl = JC.CachedTrainLoader(jc, idx, 8, seed=42, shuffle=shuffle,
                              num_workers=2)
    tl = TC.CachedTrainLoader(tc, idx, 8, seed=42, shuffle=shuffle,
                              num_workers=2)
    assert len(jl) == len(tl)
    for epoch in (1, 2):
        jb, tb = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(jb) == len(tb) == len(tl)
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            # negatives avoid the user's seen items and featureless ids
            assert (b["neg"][b["pos"] > 0] > 0).all()
            assert tc.neg_ok[b["neg"][b["pos"] > 0]].all()
    if shuffle:
        first = [b["seq"] for b in tl.epoch(1)]
        second = [b["seq"] for b in tl.epoch(2)]
        assert any(not np.array_equal(a, b) for a, b in zip(first, second))


def test_prep_runs_on_the_workers_in_batch_order(caches):
    _, tc = caches
    loader = TC.CachedTrainLoader(tc, np.arange(len(tc)), 8, seed=3,
                                  num_workers=3)

    def prep(b, i):
        return dict(b, index=np.int64(i), total=b["seq"].sum())

    plain = list(loader.epoch(1))
    prepped = list(loader.epoch(1, prep=prep))
    assert [int(b["index"]) for b in prepped] == list(range(len(loader)))
    for a, b in zip(plain, prepped):
        np.testing.assert_array_equal(a["neg"], b["neg"])
        assert b["total"] == a["seq"].sum()


MODEL = ["--preset", "hstu_flagship", "--maxlen", "255", "--hidden_units",
         "16", "--num_blocks", "2", "--dtype", "float32", "--device", "cpu",
         "--num_workers", "2", "--batch_size", "8"]


@pytest.fixture
def train_env(synth_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("TRAIN_DATA_PATH", str(synth_dir))
    monkeypatch.setenv("TRAIN_LOG_PATH", str(tmp_path / "logs"))
    monkeypatch.setenv("TRAIN_CKPT_PATH", str(tmp_path / "ckpt"))
    return tmp_path


def test_cli_train_cached_loader_to_a_checkpoint(train_env):
    timings = {}
    state = TTRAIN.main(MODEL + ["--loader", "cached", "--num_epochs", "1"],
                        timings=timings)
    assert timings["loader"] == "cached" and timings["cache_build_s"] > 0
    lines = [json.loads(ln) for ln in open(train_env / "logs" / "train.log")]
    assert len(lines) == state.step > 0
    assert np.isfinite([ln["loss"] for ln in lines]).all()
    ck = TCK.latest_checkpoint(train_env / "ckpt")
    assert ck is not None and ck.name.startswith(f"global_step{state.step}.")


@pytest.mark.parametrize("loader,taken", [("auto", "native"),
                                          ("streaming", "streaming"),
                                          ("native", "native")])
def test_cli_train_loader_choice(train_env, loader, taken):
    """``auto`` takes the native C++ pack at any scale, as the JAX CLI's
    ``auto`` does, and so does ``native``; the pack lands under
    TRAIN_CKPT_PATH/packed_cache_maxlen{maxlen}."""
    argv = MODEL + ["--loader", loader, "--inference_only"]
    timings = {}
    assert TTRAIN.main(argv, timings=timings) is None
    assert timings["loader"] == taken
    if taken == "native":
        assert not timings["cache_reused"] and timings["cache_build_s"] > 0
        assert list(train_env.rglob("packed_cache_maxlen255/meta.json"))


def test_cli_train_reuses_the_last_pack(train_env):
    """With a ``packs`` dict, a second run on the same data and window
    reuses the pack (another model: the pack does not depend on it);
    another window packs anew; without one, every run packs."""
    runs = (MODEL, MODEL[:-2] + ["--batch_size", "4", "--preset", "hstu_mini"],
            [a if a != "255" else "127" for a in MODEL], MODEL)
    packs, seen = {}, []
    for argv in runs:
        timings = {}
        TTRAIN.main(argv + ["--loader", "cached", "--inference_only"],
                    timings=timings, packs=packs)
        seen.append(timings["cache_reused"])
    assert seen == [False, True, False, False] and len(packs) == 1
    timings = {}
    TTRAIN.main(MODEL + ["--loader", "cached", "--inference_only"],
                timings=timings)
    assert not timings["cache_reused"]
