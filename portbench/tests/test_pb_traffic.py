"""The traffic generator: the same seed gives the same batches, every seed
the same amount of work, features a function of the id."""

import numpy as np
import torch

import tiny
from portbench.bench import program as PG
from portbench.bench import traffic as TF

SEED = 2 ** 31 + 123457


def _batches(seed, workload="flagship.train", train=True):
    c = tiny.cell(workload)
    return TF.make_batches(c.traffic, PG.model_info(c.config), seed, 4,
                           train), c


def test_same_seed_same_batches():
    a, _ = _batches(SEED)
    b, _ = _batches(SEED)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_seed_changes_items_not_work():
    a, _ = _batches(SEED)
    b, _ = _batches(SEED + 1)
    assert not np.array_equal(a[0]["seq"], b[0]["seq"])
    for x, y in zip(a, b):
        assert sorted((x["token_type"] > 0).sum(1)) \
            == sorted((y["token_type"] > 0).sum(1))


def test_layout_and_features():
    bs, c = _batches(SEED)
    vocab = PG.feature_vocab(c.config)
    for b in bs:
        tt, seq, pos = b["token_type"], b["seq"], b["pos"]
        assert (tt[:, 0] == 0).all() and (tt[:, -1] == 1).all()
        assert ((tt == 2).sum(1) == 1).all()
        item = tt[:, 1:] == 1
        np.testing.assert_array_equal(pos[:, :-1][item], seq[:, 1:][item])
        np.testing.assert_array_equal(
            b["seq_item_sparse"],
            TF.item_sparse(np.where(tt == 1, seq, 0), SEED, vocab))
        np.testing.assert_array_equal(b["pos_item_sparse"],
                                      TF.item_sparse(pos, SEED, vocab))
        assert ((b["neg"] > 0) == (pos > 0)).all()


def test_hash_agrees_on_host_and_device():
    ids = np.arange(0, 5000, 7)
    vocab = {f: 1000 for f in TF.ITEM_SPARSE}
    np.testing.assert_array_equal(
        TF.item_sparse(ids, SEED, vocab),
        TF.item_sparse(torch.as_tensor(ids), SEED, vocab, torch).numpy())


def test_zipf_ids_in_range_and_skewed():
    rng = np.random.default_rng(0)
    ids = TF.zipf_items(rng, 100_000, 1_000_000, 1.0, SEED)
    assert ids.min() >= 1 and ids.max() <= 1_000_000
    _, counts = np.unique(ids, return_counts=True)
    assert counts.max() > 1000          # the most popular item
