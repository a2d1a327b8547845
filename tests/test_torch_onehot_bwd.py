"""The one-hot lookup backward of the fused-feature table
(tencent_recommendation_2025_tpu_torch/models/embedding.py
``fused_feature_lookup`` with per-slot vocabulary sizes, and
parallel/sharded_embedding.py ``row_grad_sum``) against ``jax.grad`` of the
JAX package's ``fused_feature_lookup(..., vocab_sizes=...)``, whose
backward is ``_fused_lookup_onehot_bwd``'s one-hot products: f32 sums of
the cotangents of the ids in (0, vocab] at row offset + id, nothing for an
id above its slot's vocabulary, zero elsewhere.

The layout: two sparse slots of 2000 and 1500 values and an array feature
of 1100 values in 3 slots that share its offset; ids above each slot's
vocabulary (2100 in the first slot reads the second feature's row 2100
forward), padding ids 0. On one device and on a local data mesh of 2
shards (the table row-sharded, each shard's batch rows in turn), in f32 at
rtol 2e-4 / atol 2e-5; past ONEHOT_BWD_MAX_VOCAB (a slot of 20000) the
plain route (a scatter-add that drops nothing in range) is unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.models import embedding as JE
from tencent_recommendation_2025_tpu_torch.config import MeshConfig
from tencent_recommendation_2025_tpu_torch.models import embedding as TE
from tencent_recommendation_2025_tpu_torch.parallel import \
    sharded_embedding as SE
from tencent_recommendation_2025_tpu_torch.parallel.mesh import local_mesh

torch.set_num_threads(2)

D = 8
CAP = 3


def _layout(big=False):
    """(offsets, sizes, table rows) of the slots: sparse slots of 2000 (or
    20000 with ``big``) and 1500 values, then CAP slots of an 1100-value
    array feature at one offset, each feature followed by its spacing
    row, as data/featurizer.FusedVocab lays them out."""
    sizes = [20000 if big else 2000, 1500, 1100]
    offs, acc = [], 0
    for n in sizes:
        offs.append(acc)
        acc += n + 1
    return (offs[:2] + [offs[2]] * CAP, sizes[:2] + [sizes[2]] * CAP,
            acc + 1)


def _arrays(big=False, seed=0, n=64):
    """Table, ids [n, slots] (ids up to 1.3x each vocabulary: about a
    quarter above it; a third of them 0; the first row's first id 2100)
    and the cotangent [n, slots, D]."""
    offs, sizes, rows = _layout(big)
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, D)).astype(np.float32)
    ids = np.stack([rng.integers(0, int(1.3 * s) + 1, n) for s in sizes],
                   axis=1)
    ids[rng.random(ids.shape) < 0.3] = 0
    ids[0, 0] = 2100
    cot = rng.standard_normal(ids.shape + (D,)).astype(np.float32)
    return offs, sizes, table, ids.astype(np.int32), cot


def _jax_grad(offs, sizes, table, ids, cot):
    """jax.grad of the JAX lookup, given the static sizes where its towers
    give them (``_maybe_sizes``: the largest at most
    ONEHOT_BWD_MAX_VOCAB)."""
    static = (tuple(offs), tuple(sizes)) \
        if max(sizes) <= JE.ONEHOT_BWD_MAX_VOCAB else None

    def f(t):
        out = JE.fused_feature_lookup(
            t, jnp.asarray(ids), jnp.asarray(offs, jnp.int32),
            vocab_sizes=static)
        return jnp.sum(out * jnp.asarray(cot))

    return np.asarray(jax.grad(f)(jnp.asarray(table)))


def _port_grad(offs, sizes, table, ids, cot, shards=1):
    """The port's table gradient, on one device or on a local data mesh of
    ``shards`` (each data shard's rows looked up in turn in a
    ShardedTable over the padded table; the pad rows cut)."""
    t = torch.from_numpy(table)
    if shards > 1:
        t = SE.pad_rows(t, shards)
    t.requires_grad_(True)
    ids_t, cot_t = torch.from_numpy(ids), torch.from_numpy(cot)
    if shards == 1:
        out = TE.fused_feature_lookup(t, ids_t, offs, sizes=sizes)
        (out * cot_t).sum().backward()
    else:
        st = SE.ShardedTable.of_leaf(t, local_mesh(MeshConfig(data=shards)))
        loss = 0.0
        for rows in np.array_split(np.arange(ids.shape[0]), shards):
            out = TE.fused_feature_lookup(st, ids_t[rows], offs, sizes=sizes)
            loss = loss + (out * cot_t[rows]).sum()
        loss.backward()
    return t.grad[:table.shape[0]].numpy()


@pytest.mark.parametrize("shards", [1, 2])
def test_onehot_backward_matches_jax(shards):
    """The table gradient equals jax.grad of the JAX lookup, on one device
    and on a 2-shard data mesh; the first slot's id 2100 (in the second
    feature's rows) sends nothing there."""
    offs, sizes, table, ids, cot = _arrays(seed=shards)
    assert 1024 < max(sizes) <= TE.ONEHOT_BWD_MAX_VOCAB
    want = _jax_grad(offs, sizes, table, ids, cot)
    got = _port_grad(offs, sizes, table, ids, cot, shards)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # row 2100 takes the cotangents of the second slot's id 99 alone
    hit = (ids[:, 1] == 2100 - offs[1])
    np.testing.assert_allclose(got[2100], cot[hit, 1].sum(0), rtol=1e-5,
                               atol=1e-6)
    assert not got[0].any()


def test_ids_above_their_vocabulary_send_nothing():
    """Only ids above their vocabulary, the forward reading the next
    feature's rows (the last slots' clamped to the table's end): the
    gradient is zero everywhere."""
    offs, sizes, table, ids, cot = _arrays(seed=3)
    ids = np.where(ids > 0, np.asarray(sizes)[None, :] + 1 + ids % 50, 0)
    ids = ids.astype(np.int32)
    out = TE.fused_feature_lookup(torch.from_numpy(table),
                                  torch.from_numpy(ids), offs, sizes=sizes)
    rows = np.minimum(np.asarray(offs)[None, :] + ids, table.shape[0] - 1)
    np.testing.assert_array_equal(out.numpy()[ids > 0],
                                  table[rows[ids > 0]])
    assert not _port_grad(offs, sizes, table, ids, cot).any()


def test_plain_route_past_the_onehot_vocabulary():
    """A slot of 20000 values: the JAX package takes its plain gather and
    scatter-add (every id in the table's range sends its gradient), and so
    does the port."""
    offs, sizes, table, ids, cot = _arrays(big=True, seed=4)
    assert max(sizes) > TE.ONEHOT_BWD_MAX_VOCAB
    assert (ids[:, 0] > sizes[0]).any()
    want = _jax_grad(offs, sizes, table, ids, cot)
    got = _port_grad(offs, sizes, table, ids, cot)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    rows = offs[0] + ids[:, 0]
    above = rows[(ids[:, 0] > sizes[0]) & (rows < table.shape[0])]
    assert above.size and np.abs(got[above]).sum(1).all()


def test_row_grad_sum_orders_and_drops():
    """row_grad_sum against an index_add_ of the kept rows (the same sums
    in f64), rows outside [0, n) dropped, and bitwise equal over two
    calls."""
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(rng.integers(-3, 40, 500))
    cot = torch.from_numpy(rng.standard_normal((500, 5)).astype(np.float32))
    got = SE.row_grad_sum(rows, cot, 33)
    keep = (rows >= 0) & (rows < 33)
    want = torch.zeros(33, 5, dtype=torch.float64).index_add_(
        0, rows[keep], cot[keep].double())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, SE.row_grad_sum(rows, cot, 33))
