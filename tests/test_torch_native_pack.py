"""The port's native data prep (tencent_recommendation_2025_tpu_torch/data/
native_pack.py): the C++ tool built into build/native/, its pack bitwise
equal to the port's python pack and to the JAX package's native pack, the
on-disk pack reused, the loader's batches equal to the python pack's, and
the user-token cap checked (cli.train's loader choice:
tests/test_torch_cached_loader.py)."""

import os

import numpy as np
import pytest

from tencent_recommendation_2025_tpu.data import native_pack as JNP
from tencent_recommendation_2025_tpu.data.dataset import \
    TrainSampler as JSampler
from tencent_recommendation_2025_tpu.data.readers import TencentGRData as JData
from tencent_recommendation_2025_tpu.data.schema import FeatureSchema as JSch
from tencent_recommendation_2025_tpu_torch.data import native_pack as NP
from tencent_recommendation_2025_tpu_torch.data.cached_dataset import (
    CachedTrainLoader, PackedCache)
from tencent_recommendation_2025_tpu_torch.data.dataset import TrainSampler
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema

MAXLEN = 20


@pytest.fixture(scope="module")
def sampler(synth_dir):
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    return TrainSampler(data, FeatureSchema.from_indexer(data.indexer,
                                                         ("81",), 8), MAXLEN)


@pytest.fixture(scope="module")
def packs(sampler, synth_dir, tmp_path_factory):
    """The port's python pack, its native pack and the JAX native pack."""
    jdata = JData(synth_dir, mm_emb_ids=("81",))
    jsampler = JSampler(jdata, JSch.from_indexer(jdata.indexer, ("81",), 8),
                        MAXLEN)
    d = tmp_path_factory.mktemp("native")
    return dict(py=PackedCache(sampler, num_workers=4),
                nat=NP.build_packed_cache_native(sampler, d / "port",
                                                 threads=4),
                jax=JNP.build_packed_cache_native(jsampler, d / "jax",
                                                  threads=4),
                dir=d / "port")


def test_tool_builds_into_build_native():
    path = NP.tool_path()
    assert path is not None and path == NP.TOOL
    assert path.parent.parts[-2:] == ("build", "native")
    assert os.access(path, os.X_OK)
    assert not list(path.parent.glob("*.tmp"))


@pytest.mark.parametrize("other", ["py", "jax"])
def test_native_fields_and_seen_sets_bitwise(packs, other):
    nat, ref = packs["nat"], packs[other]
    assert set(nat.fields) == set(ref.fields)
    for name, arr in ref.fields.items():
        got = nat.fields[name]
        assert got.dtype == arr.dtype and got.shape == arr.shape, name
        np.testing.assert_array_equal(np.asarray(got), np.asarray(arr),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(nat.seen_sets.offs),
                                  np.asarray(ref.seen_sets.offs))
    np.testing.assert_array_equal(np.asarray(nat.seen_sets.vals),
                                  np.asarray(ref.seen_sets.vals))
    np.testing.assert_array_equal(nat.neg_ok, ref.neg_ok)
    assert nat.itemnum == ref.itemnum and len(nat) == len(ref)


def test_native_cache_is_reused(sampler, packs):
    stamp = os.stat(packs["dir"] / "seq.bin").st_mtime_ns
    again = NP.build_packed_cache_native(sampler, packs["dir"], threads=4)
    assert os.stat(packs["dir"] / "seq.bin").st_mtime_ns == stamp
    for name, arr in packs["nat"].fields.items():
        np.testing.assert_array_equal(np.asarray(again.fields[name]),
                                      np.asarray(arr), err_msg=name)


def test_native_batches_equal_python_batches(packs):
    """The cached loader over either pack yields the same batches, keys and
    bytes, negatives included (drawn from (seed, epoch, batch))."""
    idx = np.arange(len(packs["py"]))
    for e in (0, 1):
        a = list(CachedTrainLoader(packs["py"], idx, 8, seed=3).epoch(e))
        b = list(CachedTrainLoader(packs["nat"], idx, 8, seed=3).epoch(e))
        assert len(a) == len(b) > 1
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_user_token_cap_is_checked(sampler, packs, monkeypatch):
    from tencent_recommendation_2025_tpu_torch import config

    monkeypatch.setattr(config, "MAX_USER_TOKENS_PER_ROW", 0)
    assert (np.asarray(packs["nat"].fields["token_type"]) == 2).any()
    with pytest.raises(ValueError, match="user tokens"):
        NP.load_native_cache(packs["dir"], sampler)
