"""The port's exact top-k MIPS and ANN file contract against the JAX
package's, and the serving entry's refusals: unported methods and a CUDA
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
from tencent_recommendation_2025_tpu_torch.retrieval.ann import run_ann

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


def test_run_ann_exact_and_unported_methods(tmp_path):
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
    for method, item in (("approx", "Retrieval tiers"),
                         ("int8", "Retrieval tiers"),
                         ("hnsw", "Retrieval tiers"),
                         ("semantic", "Generative tier")):
        with pytest.raises(NotImplementedError, match=item):
            run_ann(tmp_path, RetrievalConfig(method=method), device="cpu")


def test_infer_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TINF.resolve_device("cuda")
    assert TINF.resolve_device("cpu").type == "cpu"
    assert TINF.get_args([]).device == "cuda"
