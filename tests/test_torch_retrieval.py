"""The port's top-k MIPS tiers (exact, approx, int8) and ANN file contract
(with the HNSW tool) against the JAX package's (the single-device cases of
tests/test_sharded_mips.py and tests/test_hnsw.py), and the serving
entry's refusals: the semantic method without its artifacts and a CUDA
device where there is none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.retrieval import mips as JM
from tencent_recommendation_2025_tpu_torch.cli import infer as TINF
from tencent_recommendation_2025_tpu_torch.config import RetrievalConfig
from tencent_recommendation_2025_tpu_torch.data import formats
from tencent_recommendation_2025_tpu_torch.retrieval import mips as TM
from tencent_recommendation_2025_tpu_torch.retrieval.ann import (
    binary_path, run_ann)

torch.set_num_threads(2)


@pytest.mark.parametrize("Q,N,k,block_n", [(7, 300, 10, 64), (5, 4, 10, 64),
                                           (3, 1000, 20, 65536)])
def test_topk_mips_matches_jax(Q, N, k, block_n):
    rng = np.random.default_rng(Q * 1000 + N)
    q = rng.standard_normal((Q, 16)).astype(np.float32)
    c = rng.standard_normal((N, 16)).astype(np.float32)
    js, ji = JM.topk_mips(jnp.asarray(q), jnp.asarray(c), k=k,
                          block_n=block_n)
    ts, ti = TM.topk_mips(torch.from_numpy(q), torch.from_numpy(c), k=k,
                          block_n=block_n)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if k > N:
        # places no corpus row filled: lowest f32 score, index 0
        assert (ts.numpy()[:, N:] == np.finfo(np.float32).min).all()
        assert (ti.numpy()[:, N:] == 0).all()


def _recall(got, want):
    return np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)])


def test_run_ann_exact_and_unported_methods(tmp_path):
    """exact, approx (the exact ids), int8 (the same top 10 as sets on a
    corpus without near ties) and hnsw through the file contract;
    semantic raises without a model output path or without the artifacts
    cli.semantic writes there (tests/test_torch_rqvae_pipeline.py serves
    them)."""
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((50, 8)).astype(np.float32)
    queries = rng.standard_normal((6, 8)).astype(np.float32)
    ids = np.arange(1000, 1050, dtype=np.uint64).reshape(-1, 1)
    formats.save_emb(corpus, tmp_path / "embedding.fbin")
    formats.save_emb(ids, tmp_path / "id.u64bin")
    formats.save_emb(queries, tmp_path / "query.fbin")
    out = run_ann(tmp_path, RetrievalConfig(top_k=10), device="cpu")
    got = formats.read_result_ids(out)
    want = ids[np.argsort(-(queries @ corpus.T), axis=1)[:, :10], 0]
    np.testing.assert_array_equal(np.asarray(got), want)
    for method in ("approx", "int8", "hnsw"):
        out = run_ann(tmp_path, RetrievalConfig(method=method, top_k=10),
                      device="cpu")
        got = np.asarray(formats.read_result_ids(out))
        assert got.shape == want.shape, method
        if method == "approx":
            np.testing.assert_array_equal(got, want)
        else:
            assert _recall(got, want) >= 0.9, method
    with pytest.raises(AssertionError, match="model output path"):
        run_ann(tmp_path, RetrievalConfig(method="semantic"), device="cpu")
    with pytest.raises(AssertionError, match="no semantic artifacts"):
        run_ann(tmp_path, RetrievalConfig(method="semantic"), device="cpu",
                model_output_path=tmp_path)


@pytest.mark.parametrize("N,block_n", [(3000, 1024), (700, 1_048_576)])
def test_topk_mips_approx_matches_jax_and_exact(N, block_n):
    """The approx tier (per-block top k, then an exact merge) returns the
    exact result, as the JAX package's does on the CPU, where approx_max_k
    lowers to an exact top k."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((64, 16)).astype(np.float32)
    c = rng.standard_normal((N, 16)).astype(np.float32)
    js, ji = JM.topk_mips_approx(jnp.asarray(q), jnp.asarray(c), k=10,
                                 block_n=block_n)
    ts, ti = TM.topk_mips_approx(torch.from_numpy(q), torch.from_numpy(c),
                                 k=10, block_n=block_n)
    es, ei = TM.topk_mips(torch.from_numpy(q), torch.from_numpy(c), k=10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), ei.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


def test_quantize_corpus_int8_matches_jax():
    """Codes and scales equal the JAX package's (its codes stored [D, N]),
    from numpy (quantized on the host in row chunks) and from a tensor;
    zero rows take scale 1 and codes 0."""
    rng = np.random.default_rng(11)
    c = rng.standard_normal((4000, 16)).astype(np.float32)
    c[7] = 0.0
    jcodes, jscales = JM.quantize_corpus_int8(c)
    for src in (c, torch.from_numpy(c)):
        codes, scales = TM.quantize_corpus_int8(src, device="cpu")
        assert codes.dtype == torch.int8 and codes.shape == (4000, 16)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes).T)
        np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    assert scales[7] == 1.0 and not codes[7].any()


def test_quantize_corpus_int8_host_chunks(monkeypatch):
    """The host path quantizes in row chunks without changing a code."""
    rng = np.random.default_rng(3)
    c = rng.standard_normal((1000, 16)).astype(np.float32)
    whole = TM.quantize_corpus_int8(c, device="cpu")
    monkeypatch.setattr(TM, "_HOST_CHUNK_ELEMS", 16 * 37)
    chunked = TM.quantize_corpus_int8(c, device="cpu")
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_int8_quantized_mips_recall_and_scores_match_jax():
    """top-10 recall against exact f32 >= 0.95 (the JAX test's bar); the
    JAX int8 tier's scores to its bf16 ranking step and its ids as sets
    above the last place (bf16 ranking makes ties, which torch.topk and
    lax.top_k order and cut differently)."""
    rng = np.random.default_rng(11)
    c = rng.standard_normal((4000, 16)).astype(np.float32)
    q = rng.standard_normal((128, 16)).astype(np.float32)
    jcodes, jscales = JM.quantize_corpus_int8(c)
    js, ji = JM.topk_mips_int8(jnp.asarray(q), jcodes, jscales, k=10,
                               block_n=1024, approx=False)
    codes, scales = TM.quantize_corpus_int8(c, device="cpu")
    ts, ti = TM.topk_mips_int8(torch.from_numpy(q), codes, scales, k=10,
                               block_n=1024)
    _, ei = TM.topk_mips(torch.from_numpy(q), torch.from_numpy(c), k=10)
    assert _recall(ti.numpy(), ei.numpy()) >= 0.95
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2 ** -7)
    # the ids above the last place's score (a tie there may take either id)
    js, ji = np.asarray(js), np.asarray(ji)
    for row in range(len(q)):
        last = js[row, -1]
        above = set(ji[row][js[row] > last + abs(last) * 2 ** -7])
        assert above <= set(ti[row].tolist()), row


def test_int8_retrieve_topk_host_wrapper():
    """retrieve_topk(quantize=True) maps rows to ids; its top 5 overlaps
    the exact one by >= 0.9 (the JAX test's bar)."""
    rng = np.random.default_rng(12)
    c = rng.standard_normal((500, 16)).astype(np.float32)
    q = c[:40] * 3.0
    ids = (np.arange(500, dtype=np.uint64) + 7) * 11
    got = TM.retrieve_topk(q, c, ids, k=5, device="cpu", quantize=True)
    exact = TM.retrieve_topk(q, c, ids, k=5, device="cpu")
    assert got.shape == (40, 5) and got.dtype == np.uint64
    assert _recall(got, exact) >= 0.9
    np.testing.assert_array_equal(
        TM.retrieve_topk(q, c, ids, k=5, device="cpu", approx=True), exact)


def test_hnsw_recall_vs_exact(tmp_path):
    """The HNSW tool through the port's wrapper: recall@10 against exact
    MIPS >= 0.9 at the JAX test's settings (skipped where the tool does not
    build)."""
    if binary_path(build=True) is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(0)
    n, d, nq, k = 2000, 32, 64, 10
    base = rng.standard_normal((n, d)).astype(np.float32)
    ids = (np.arange(n, dtype=np.uint64) + 1000).reshape(-1, 1)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    formats.save_emb(base, tmp_path / "embedding.fbin")
    formats.save_emb(ids, tmp_path / "id.u64bin")
    formats.save_emb(queries, tmp_path / "query.fbin")
    out = run_ann(tmp_path, RetrievalConfig(
        method="hnsw", top_k=k, hnsw_m=16, hnsw_ef_construction=200,
        hnsw_ef_search=200), device="cpu")
    got = np.asarray(formats.read_result_ids(out))
    assert got.shape == (nq, k)
    exact = ids[np.argsort(-(queries @ base.T), axis=1)[:, :k], 0]
    assert _recall(got, exact) >= 0.9


def test_infer_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TINF.resolve_device("cuda")
    assert TINF.resolve_device("cpu").type == "cpu"
    assert TINF.get_args([]).device == "cuda"


@pytest.mark.parametrize("Q,N,k,D,base,n_valid", [
    (1, 10_000_000, 10, 64, 0, None), (1024, 10_000_000, 10, 64, 0, None),
    (4096, 10_000_000, 10, 64, 0, None), (4096, 1_000_003, 128, 512, 0,
                                          None),
    (7, 300, 10, 16, 0, None), (1, 5, 128, 1024, 0, None),
    (33, 4000, 20, 64, 4000, 5500), (33, 4000, 20, 64, 0, 2000),
    (2, 129, 1, 13, 0, None), (1024, 25_000_000, 10, 64, 75_000_000,
                               100_000_000)])
def test_scan_plan_gives_every_row_to_one_slice(Q, N, k, D, base, n_valid):
    """The kernel's cut (``scan_plan``, on a 132-SM card): every row of
    [0, min(N, n_valid - base)) in exactly one slice of whole 128-row
    tiles, no slice empty, the query tiles cover Q and fit their
    shared-memory budgets, and at Q = 1, 1,024 and 4,096 over 10M rows the
    blocks fill the SMs."""
    n = TM._rows_scanned(N, base, n_valid)
    assert n == (N if n_valid is None else min(N, n_valid - base))
    p = TM.scan_plan(Q, n, k, D, 132)
    assert p.tm in (1, 2, 4) and p.qtiles * 16 * p.tm >= Q
    assert (p.qtiles - 1) * 16 * p.tm < Q
    assert p.tm == 1 or (16 * p.tm * TM._query_pitch(D) * 4
                         <= TM._QUERY_TILE_BYTES
                         and 16 * p.tm * k * 8 <= TM._LIST_BYTES)
    assert p.rows % TM._TILE_ROWS == 0 and p.slices >= 1
    owner = np.full(n, -1)
    for s in range(p.slices):
        lo, hi = s * p.rows, min((s + 1) * p.rows, n)
        assert lo < hi                       # no slice is empty
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = s
    assert (owner >= 0).all()
    if N == 10_000_000:
        assert p.qtiles * p.slices >= 132


def test_scan_plan_of_a_shard_of_pad_rows_has_no_slice():
    assert TM._rows_scanned(4000, 8000, 5500) == 0
    p = TM.scan_plan(33, 0, 20, 64, 132)
    assert p.slices == 0 and p.qtiles == 1


def test_mips_topk_kernel_limits_raise_and_cpu_takes_the_plain_version():
    """``mips_topk`` refuses k and D past the kernel's limits (naming the
    limit) and CPU tensors; ``topk_mips`` on CPU tensors takes the plain
    version at any k and leaves the kernel's counters alone."""
    from tencent_recommendation_2025_tpu_torch.utils import tracing as TRC

    q = torch.zeros((3, 64))
    with pytest.raises(ValueError, match="KERNEL_MAX_K"):
        TM.mips_topk(q, torch.zeros((10, 64)), k=TM.KERNEL_MAX_K + 1)
    with pytest.raises(ValueError, match="KERNEL_MAX_K"):
        TM.mips_topk(q, torch.zeros((10, 64)), k=0)
    wide = torch.zeros((3, TM.KERNEL_MAX_D + 1))
    with pytest.raises(ValueError, match="KERNEL_MAX_D"):
        TM.mips_topk(wide, wide, k=1)
    with pytest.raises(ValueError, match="on one card"):
        TM.mips_topk(q, torch.zeros((10, 64)), k=10)
    launches = TM.mips_topk.launches
    kq = TRC.counters().get("mips.kernel_queries", 0)
    rng = np.random.default_rng(5)
    c = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    qq = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    s, i = TM.topk_mips(qq, c, k=TM.KERNEL_MAX_K + 2, block_n=64)
    assert s.shape == (3, TM.KERNEL_MAX_K + 2)
    want = torch.topk(qq @ c.T, TM.KERNEL_MAX_K + 2, dim=1)
    assert torch.equal(i, want.indices)
    assert TM.mips_topk.launches == launches
    assert TRC.counters().get("mips.kernel_queries", 0) == kq
