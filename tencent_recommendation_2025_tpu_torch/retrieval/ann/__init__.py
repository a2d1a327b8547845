"""ANN serving over the reference's file contract.

Counterpart of ``tencent_recommendation_2025_tpu/retrieval/ann``: read
``embedding.fbin`` / ``id.u64bin`` / ``query.fbin`` from a result directory,
write the top-k retrieval ids to ``id100.u64bin``. The port serves the exact
method; the other methods of the JAX package raise until ported.
"""

from __future__ import annotations

from pathlib import Path

from ...config import RetrievalConfig
from ...data import formats

_NOT_PORTED = {
    "approx": "approximate top-k (ROADMAP Queue 1, Retrieval tiers)",
    "int8": "int8-quantized corpus top-k (ROADMAP Queue 1, Retrieval tiers)",
    "hnsw": "the native HNSW tool wrapper (ROADMAP Queue 1, Retrieval tiers)",
    "semantic": "generative semantic-id serving (ROADMAP Queue 1, Generative tier)",
}


def run_ann(result_dir, cfg: RetrievalConfig = RetrievalConfig(),
            dataset_file="embedding.fbin", id_file="id.u64bin",
            query_file="query.fbin", result_file="id100.u64bin",
            device="cuda") -> Path:
    """Exact top-k search with the reference's file contract."""
    if cfg.method != "exact":
        what = _NOT_PORTED.get(cfg.method, "this method")
        raise NotImplementedError(
            f"ann method {cfg.method!r}: {what} is not ported yet")
    from ..mips import retrieve_topk

    result_dir = Path(result_dir)
    out = result_dir / result_file
    corpus = formats.load_fbin(result_dir / dataset_file)
    ids = formats.load_u64bin(result_dir / id_file)[:, 0]
    queries = formats.load_fbin(result_dir / query_file)
    top = retrieve_topk(queries, corpus, ids, k=cfg.top_k, device=device)
    formats.save_result_ids(top, out)
    return out
