"""Sharded top-k MIPS (tencent_recommendation_2025_tpu_torch/retrieval/
mips.py, the sharded tier) on a local mesh of 8 corpus shards and of data 2
x seq 4 (8 shards, flattened), against the JAX package's sharded tier on
the 8 fake CPU devices of conftest.py: the counterparts of every case of
tests/test_sharded_mips.py, with the same numpy inputs from the same seeds.
Scores at rtol 1e-5 / atol 1e-5 (the JAX tests' tolerance), ids equal.

The int8 tier ranks in bf16, where ties are common. The port resolves
them as ``lax.top_k`` (the lower index), so its int8 ids equal the JAX
single-device tier's and one device's equal a mesh's. The JAX sharded int8
tier takes ``approx_max_k`` per shard, which keeps tied scores its own way:
against it int8 ids are held equal at every place whose two scores are not
a tie (2^-7 relative, the bf16 ranking's step and the query scale's
rounding).

One case is new: pad rows on the last shard of an f32 corpus whose every
score is negative. The port masks them before each shard's top-k in every
tier and returns the exact ids; the JAX approx path masks them only after
its per-shard top-k, and returns other ids on that input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tencent_recommendation_2025_tpu.retrieval import mips as JM
from tencent_recommendation_2025_tpu_torch.config import MeshConfig
from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
    local_mesh, world_shards)
from tencent_recommendation_2025_tpu_torch.retrieval import mips as TM

requires_8 = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 fake devices")
MESHES = {"corpus8": MeshConfig(data=8),
          "data2xseq4": MeshConfig(data=2, seq=4)}
TOL = dict(rtol=1e-5, atol=1e-5)


def _jmesh():
    return Mesh(np.asarray(jax.devices()).reshape(-1), ("corpus",))


@pytest.fixture(params=sorted(MESHES))
def mesh(request):
    m = local_mesh(MESHES[request.param])
    assert world_shards(m) == 8 and m.world_indices == list(range(8))
    return m


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _check(got, want_s, want_i):
    s, i = got
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))


def _check_int8(got, want_s, want_i):
    """Against the JAX sharded int8 tier: scores at the bf16 ranking's
    step; ids equal wherever the two scores at a place are not a tie."""
    s, i = (np.asarray(x) for x in got)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_allclose(s, want_s, rtol=2 ** -7)
    differ = i != want_i
    tie = np.abs(s - want_s) <= 2 ** -7 * np.maximum(np.abs(s),
                                                      np.abs(want_s))
    assert (tie | ~differ).all(), np.argwhere(differ & ~tie)[:5]


@requires_8
@pytest.mark.parametrize("seed,Q,N,D", [(0, 32, 1003, 16), (1, 4, 37, 8)],
                         ids=["uneven-shards", "k-exceeds-shard"])
def test_sharded_matches_jax_and_single_device(mesh, seed, Q, N, D):
    """N=1003 over 8 shards (126 rows, 5 pad rows on the last); N=37 (5
    rows a shard, fewer than k: each shard returns k candidates, the
    unfilled ones (lowest, row 0))."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    c = rng.standard_normal((N, D)).astype(np.float32)
    js, ji = JM.sharded_topk_mips(_jmesh(), jnp.asarray(q), jnp.asarray(c),
                                  k=10)
    got = TM.sharded_topk_mips(mesh, _t(q), c, k=10)
    _check(got, js, ji)
    single = TM.topk_mips(_t(q), _t(c), k=10)
    assert torch.equal(got[1], single[1])
    assert got[1].max() < N


@requires_8
def test_retrieve_topk_on_a_mesh_matches_jax_auto_mesh(mesh):
    """The host wrapper shards the corpus once and maps rows to ids: the
    JAX wrapper's automatic 8-device mesh and the numpy oracle."""
    rng = np.random.default_rng(2)
    N, D, k = 500, 8, 5
    q = rng.standard_normal((17, D)).astype(np.float32)
    c = rng.standard_normal((N, D)).astype(np.float32)
    ids = rng.integers(10**6, 10**9, N).astype(np.uint64)
    want = JM.retrieve_topk(q, c, ids, k=k)
    got = TM.retrieve_topk(q, c, ids, k=k, device="cpu", mesh=mesh,
                           query_batch=8)
    np.testing.assert_array_equal(got, want)
    oracle = ids[np.argsort(-(q @ c.T), axis=1)[:, :k]]
    np.testing.assert_array_equal(got, oracle)


def test_approx_matches_exact_and_jax():
    """The approx tier (per-block top k, exact merge) on one device: the
    exact ids, and JAX's approx result (exact on the CPU)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((64, 16)).astype(np.float32)
    c = rng.standard_normal((3000, 16)).astype(np.float32)
    js, ji = JM.topk_mips_approx(q, c, k=10, block_n=1024)
    es, ei = TM.topk_mips(_t(q), _t(c), k=10)
    as_, ai = TM.topk_mips_approx(_t(q), _t(c), k=10, block_n=1024)
    assert torch.equal(ai, ei)
    np.testing.assert_allclose(as_.numpy(), es.numpy(), rtol=1e-6)
    _check((as_, ai), js, ji)


@requires_8
def test_sharded_approx_matches_exact_and_jax(mesh):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((32, 16)).astype(np.float32)
    c = rng.standard_normal((1003, 16)).astype(np.float32)
    es, ei = TM.sharded_topk_mips(mesh, _t(q), c, k=10)
    got = TM.sharded_topk_mips(mesh, _t(q), c, k=10, approx=True)
    assert torch.equal(got[1], ei)
    js, ji = JM.sharded_topk_mips(_jmesh(), q, c, k=10, approx=True)
    _check(got, js, ji)


def test_int8_codes_recall_and_ids_match_jax():
    """The int8 store is the JAX [D, N] store transposed; top-10 recall
    against exact f32 >= 0.95 (the JAX test's bar); ids equal to JAX's
    (bf16 ties resolved alike), scores at the ranking's bf16 step."""
    rng = np.random.default_rng(11)
    c = rng.standard_normal((4000, 16)).astype(np.float32)
    jcodes, jscales = JM.quantize_corpus_int8(c)
    codes, scales = TM.quantize_corpus_int8(c, device="cpu")
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes).T)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    q = rng.standard_normal((128, 16)).astype(np.float32)
    js, ji = JM.topk_mips_int8(jnp.asarray(q), jcodes, jscales, k=10,
                               block_n=1024, approx=False)
    ts, ti = TM.topk_mips_int8(_t(q), codes, scales, k=10, block_n=1024)
    _, ei = TM.topk_mips(_t(q), _t(c), k=10)
    assert _overlap(ti.numpy(), ei.numpy()) >= 0.95
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2 ** -7)


def _overlap(a, b):
    k = a.shape[1]
    return np.mean([len(set(x) & set(y)) / k
                    for x, y in zip(a.tolist(), b.tolist())])


def test_int8_retrieve_topk_host_wrapper_matches_jax():
    """The int8 wrapper in one process: the JAX single-device int8 rows
    mapped to corpus ids; its top 5 overlaps exact f32's and the JAX
    wrapper's (which, seeing 8 devices, takes its sharded tier) by >= 0.9
    (the JAX test's bar)."""
    rng = np.random.default_rng(12)
    c = rng.standard_normal((500, 16)).astype(np.float32)
    q = c[:40] * 3.0
    ids = (np.arange(500, dtype=np.uint64) + 7) * 11
    jcodes, jscales = JM.quantize_corpus_int8(c)
    _, ji = JM.topk_mips_int8(jnp.asarray(q), jcodes, jscales, k=5,
                              approx=False)
    got = TM.retrieve_topk(q, c, ids, k=5, device="cpu", quantize=True)
    exact = TM.retrieve_topk(q, c, ids, k=5, device="cpu")
    assert got.shape == (40, 5) and got.dtype == np.uint64
    np.testing.assert_array_equal(got, ids[np.asarray(ji)])
    assert _overlap(got, exact) >= 0.9
    want = JM.retrieve_topk(q, c, ids, k=5, mesh=None, quantize=True)
    assert _overlap(got, want) >= 0.9


@requires_8
def test_sharded_int8_matches_single_device_and_jax(mesh):
    """int8 over the 8 shards (uneven tail, a shard's blocks of 128 rows
    with a short last one) equal to the single device's int8 and to JAX's
    sharded int8; ``retrieve_topk(mesh=..., quantize=True)`` shards a host
    corpus (quantized shard by shard on the host) to the same ids."""
    rng = np.random.default_rng(21)
    c = rng.standard_normal((1003, 16)).astype(np.float32)
    q = rng.standard_normal((32, 16)).astype(np.float32)
    jcodes, jscales = JM.quantize_corpus_int8(c)
    js, ji = JM.sharded_topk_mips_int8(_jmesh(), q, (jcodes, jscales),
                                       k=10, block_n=128)
    codes, scales = TM.quantize_corpus_int8(c, device="cpu")
    got = TM.sharded_topk_mips_int8(mesh, _t(q), (codes, scales), k=10,
                                    block_n=128)
    ds, di = TM.topk_mips_int8(_t(q), codes, scales, k=10, block_n=128)
    assert torch.equal(got[1], di)
    np.testing.assert_allclose(got[0].numpy(), ds.numpy(), rtol=1e-6)
    _check_int8(got, js, ji)
    ids = np.arange(1003, dtype=np.uint64) * 3 + 5
    placed = TM.shard_corpus_int8(mesh, c, device="cpu")
    assert [s[0].shape for s in placed.shards] == [(126, 16)] * 8
    assert torch.equal(placed.shards[-1][0][-5:],
                       torch.zeros((5, 16), dtype=torch.int8))
    wrapped = TM.retrieve_topk(q, c, ids, k=10, device="cpu", mesh=mesh,
                               quantize=True)
    np.testing.assert_array_equal(wrapped, ids[di.numpy()])


@requires_8
def test_sharded_int8_pad_rows_never_displace_negative_scores(mesh):
    """Every score negative: the 5 pad rows of the last shard (code 0,
    score 0) must rank last before that shard's top-k."""
    rng = np.random.default_rng(33)
    N, D = 1003, 16
    c = -np.abs(rng.standard_normal((N, D))).astype(np.float32)
    q = np.abs(rng.standard_normal((4, D))).astype(np.float32)
    jcodes, jscales = JM.quantize_corpus_int8(c)
    js, ji = JM.sharded_topk_mips_int8(_jmesh(), q, (jcodes, jscales),
                                       k=10, block_n=128)
    codes, scales = TM.quantize_corpus_int8(c, device="cpu")
    got = TM.sharded_topk_mips_int8(mesh, _t(q), (codes, scales), k=10,
                                    block_n=128)
    _, di = TM.topk_mips_int8(_t(q), codes, scales, k=10, block_n=128)
    assert torch.equal(got[1], di)
    _check_int8(got, js, ji)
    assert got[1].max() < N and float(got[0].max()) < 0


def _pad_row_input():
    """N=1003 over 8 shards: every score negative, the last shard's rows
    (882-1002) scaled by 0.01, so the true top 10 live on the last shard
    beside its 5 zero pad rows."""
    rng = np.random.default_rng(33)
    N, D = 1003, 16
    c = -np.abs(rng.standard_normal((N, D))).astype(np.float32)
    c[882:] *= 0.01
    q = np.abs(rng.standard_normal((4, D))).astype(np.float32)
    return q, c


@requires_8
def test_f32_pad_rows_masked_before_each_shards_top_k(mesh):
    """The port's exact and approx tiers equal the single device's exact
    result on the pad-row input; JAX's sharded exact does too, and JAX's
    sharded approx, which masks the pad rows after its per-shard top-k, is
    asserted to differ there."""
    q, c = _pad_row_input()
    es, ei = TM.topk_mips(_t(q), _t(c), k=10)
    assert ei.min() >= 882
    for approx in (False, True):
        s, i = TM.sharded_topk_mips(mesh, _t(q), c, k=10, approx=approx)
        assert torch.equal(i, ei), approx
        np.testing.assert_allclose(s.numpy(), es.numpy(), **TOL)
    js, ji = JM.sharded_topk_mips(_jmesh(), q, c, k=10)
    np.testing.assert_array_equal(np.asarray(ji), ei.numpy())
    _, jai = JM.sharded_topk_mips(_jmesh(), q, c, k=10, approx=True)
    assert not np.array_equal(np.asarray(jai), ei.numpy())
    codes, scales = TM.quantize_corpus_int8(c, device="cpu")
    _, di = TM.topk_mips_int8(_t(q), codes, scales, k=10, block_n=128)
    _, si = TM.sharded_topk_mips_int8(mesh, _t(q), (codes, scales), k=10,
                                      block_n=128)
    assert torch.equal(si, di) and si.min() >= 882
