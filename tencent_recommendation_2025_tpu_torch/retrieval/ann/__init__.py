"""ANN serving over the reference's file contract.

Counterpart of ``tencent_recommendation_2025_tpu/retrieval/ann``: read
``embedding.fbin`` / ``id.u64bin`` / ``query.fbin`` from a result directory,
write the top-k retrieval ids to ``id100.u64bin``. Methods: ``exact``,
``approx`` and ``int8`` through :func:`..mips.retrieve_topk` on the device
(on a mesh, or over the processes of an initialised group, the corpus
row-sharded: each process reads and places its rows only);
``hnsw`` through the repo's C++ HNSW tool (``native/hnsw``, built with
``make`` on first use), the reference's own contract:

    hnsw_tool --dataset_vector_file_path=... --dataset_id_file_path=...
              --query_vector_file_path=... --result_id_file_path=...
              --query_ann_top_k=10 --faiss_M=64 --faiss_ef_construction=1280
              --query_ef_search=640 --faiss_metric_type=0

Where the tool cannot be built, ``hnsw`` falls back to exact search, as the
JAX package's wrapper does. ``semantic`` serves through the tokenizer and
decode head that ``cli.semantic`` saved under the model's output path
(``retrieval/semantic_serve.run_semantic_ann``: beam decoding).
"""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Optional

from ...config import RetrievalConfig
from ...data import formats

_NATIVE_DIR = Path(__file__).resolve().parents[3] / "native" / "hnsw"
_BINARY = _NATIVE_DIR / "hnsw_tool"


def binary_path(build: bool = True) -> Optional[Path]:
    """The HNSW tool's path, built with make if needed; None where it
    cannot be built."""
    if _BINARY.exists():
        return _BINARY
    if not build:
        return None
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    return _BINARY if _BINARY.exists() else None


def run_ann(result_dir, cfg: RetrievalConfig = RetrievalConfig(),
            dataset_file="embedding.fbin", id_file="id.u64bin",
            query_file="query.fbin", result_file="id100.u64bin",
            device="cuda", model_output_path=None,
            beam_width: int = 32, mesh=None) -> Path:
    """Top-k search by ``cfg.method`` with the reference's file contract;
    returns the result file's path. ``semantic`` reads its artifacts under
    ``model_output_path`` and decodes ``beam_width`` beams. ``mesh`` (the
    device tiers): the corpus shards over it (``mips.retrieve_topk``); on
    a process mesh every process serves its rows and rank 0 writes the
    result file."""
    if cfg.method == "semantic":
        from ..semantic_serve import run_semantic_ann

        assert model_output_path is not None, \
            "ann method 'semantic' needs the model output path"
        return run_semantic_ann(result_dir, model_output_path, cfg,
                                beam_width=beam_width,
                                dataset_file=dataset_file, id_file=id_file,
                                query_file=query_file,
                                result_file=result_file, device=device)
    result_dir = Path(result_dir)
    out = result_dir / result_file
    tool = binary_path() if cfg.method == "hnsw" else None
    if tool is not None:
        subprocess.run([
            str(tool),
            f"--dataset_vector_file_path={result_dir / dataset_file}",
            f"--dataset_id_file_path={result_dir / id_file}",
            f"--query_vector_file_path={result_dir / query_file}",
            f"--result_id_file_path={out}",
            f"--query_ann_top_k={cfg.top_k}",
            f"--faiss_M={cfg.hnsw_m}",
            f"--faiss_ef_construction={cfg.hnsw_ef_construction}",
            f"--query_ef_search={cfg.hnsw_ef_search}",
            f"--faiss_metric_type={cfg.metric_type}",
        ], check=True)
        return out
    from ..mips import corpus_mesh, retrieve_topk

    mesh = corpus_mesh() if mesh is None else mesh
    corpus = formats.load_fbin(result_dir / dataset_file,
                               mmap=mesh is not None)
    ids = formats.load_u64bin(result_dir / id_file)[:, 0]
    queries = formats.load_fbin(result_dir / query_file)
    top = retrieve_topk(queries, corpus, ids, k=cfg.top_k, device=device,
                        mesh=mesh, approx=cfg.method == "approx",
                        quantize=cfg.method == "int8")
    if mesh is None or not mesh.process or mesh.rank == 0:
        formats.save_result_ids(top, out)
    return out
