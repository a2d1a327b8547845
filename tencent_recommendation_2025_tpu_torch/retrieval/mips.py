"""Top-k maximum-inner-product search: exact, blocked, and int8.

Counterpart of ``tencent_recommendation_2025_tpu/retrieval/mips.py``, its
single-device tiers; the JAX package leaves all of them to XLA, so here
they are plain PyTorch.

- :func:`topk_mips`, exact: blocked ``[Q, D] x [D, N]`` scoring with a
  running top-k merge, so peak memory is O(Q * (k + block_n)), never
  O(Q * N).
- :func:`topk_mips_approx`: the JAX package takes ``lax.approx_max_k`` per
  1M-row block, then one exact merge of the block winners. CUDA has no
  approximate top-k, so each block takes an exact top-k, which meets the
  contract (recall 1) and returns the exact ids.
- :func:`quantize_corpus_int8` / :func:`topk_mips_int8`: the corpus as
  per-row symmetric int8 codes and f32 scales (4x smaller than f32: the
  route for a corpus whose f32 form does not fit the card), queries
  quantized per row, int8 x int8 scores exact in int32, times the corpus
  scales and ranked in bf16, the query scales applied at the end. The
  codes are stored [N, D]: the JAX package's [D, N] store exists for the
  TPU's int8 tiling only.

Indices are global corpus rows; where k exceeds the corpus, the missing
places score the lowest f32 value with index 0.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_NEG = torch.finfo(torch.float32).min


def _merge(best_s, best_i, s, i, k):
    """Top k of the running winners and one block's candidates."""
    cat_s = torch.cat([best_s, s], dim=1)
    cat_i = torch.cat([best_i, i], dim=1)
    best_s, pos = torch.topk(cat_s, min(k, cat_s.shape[1]), dim=1)
    return best_s, torch.gather(cat_i, 1, pos)


def _init(Q, k, dev):
    return (torch.full((Q, k), _NEG, dtype=torch.float32, device=dev),
            torch.zeros((Q, k), dtype=torch.long, device=dev))


def _unfilled_to_zero(best_s, best_i):
    """Places no corpus row filled keep (lowest score, row 0)."""
    return best_s, torch.where(best_s == _NEG, torch.zeros_like(best_i),
                               best_i)


def topk_mips(queries: torch.Tensor, corpus: torch.Tensor, k: int = 10,
              block_n: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], corpus [N, D] -> (scores [Q, k] f32, indices [Q, k]
    int64)."""
    Q = queries.shape[0]
    N = corpus.shape[0]
    block_n = min(block_n, max(k, N))
    dev = queries.device
    best_s, best_i = _init(Q, k, dev)
    q = queries.float()
    for start in range(0, N, block_n):
        block = corpus[start:start + block_n].float()
        s = q @ block.T
        idx = torch.arange(start, start + block.shape[0], device=dev)
        best_s, best_i = _merge(best_s, best_i, s,
                                idx[None, :].expand(Q, -1), k)
    return _unfilled_to_zero(best_s, best_i)


def topk_mips_approx(queries: torch.Tensor, corpus: torch.Tensor,
                     k: int = 10, block_n: int = 1_048_576
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's approximate tier on the card: per 1M-row block the
    top k (exact here, where the TPU takes ``approx_max_k``), then one
    merge of the block winners. Returns the exact result."""
    Q = queries.shape[0]
    N = corpus.shape[0]
    block_n = min(block_n, max(k, N))
    best_s, best_i = _init(Q, k, queries.device)
    q = queries.float()
    for start in range(0, N, block_n):
        s = q @ corpus[start:start + block_n].float().T
        bs, bi = torch.topk(s, min(k, s.shape[1]), dim=1)
        best_s, best_i = _merge(best_s, best_i, bs, bi + start, k)
    return _unfilled_to_zero(best_s, best_i)


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 codes of f32 rows and their scales (max|x| /
    127; 1 for a zero row)."""
    amax = x.abs().amax(dim=1)
    scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.round(x / scales[:, None]).clamp(-127, 127)
    return codes.to(torch.int8), scales


#: rows of a host corpus quantized at a time (128M f32 elements at D=64)
_HOST_CHUNK_ELEMS = 1 << 27


def quantize_corpus_int8(corpus, device="cuda"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: ``codes[n] = round(x_n / s_n)``
    with ``s_n = max|x_n| / 127`` (scale 1 and codes 0 for a zero row).
    Returns (codes [N, D] int8, scales [N] f32). A numpy corpus is
    quantized on the host in row chunks, so that only the codes and scales
    reach ``device`` and no f32 copy of the whole corpus is made; a tensor
    is quantized where it lies."""
    if isinstance(corpus, torch.Tensor):
        return _quantize_rows(corpus.float())
    corpus = np.asarray(corpus)
    N, D = corpus.shape
    codes = torch.empty((N, D), dtype=torch.int8)
    scales = torch.empty((N,), dtype=torch.float32)
    step = max(1, _HOST_CHUNK_ELEMS // max(D, 1))
    for s in range(0, N, step):
        c, sc = _quantize_rows(torch.from_numpy(
            np.asarray(corpus[s:s + step], np.float32)))
        codes[s:s + step], scales[s:s + step] = c, sc
    return codes.to(device), scales.to(device)


def _int8_scores(qi: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """[Q, n] int32 = qi [Q, D] int8 . block [n, D] int8 ^T, exact, through
    ``torch._int_mm`` (the int8 tensor-core product on the card), the block
    read through its column-major [D, n] view (cuBLAS's int8 "TN" layout).
    Its shape rules (more than 16 rows; inner and output widths multiples
    of 8) are met by zero padding, which adds nothing to the real
    scores."""
    Q, D = qi.shape
    n = block.shape[0]
    qp = max(24, -(-Q // 8) * 8)
    dp, np_ = -(-D // 8) * 8, -(-n // 8) * 8
    if (qp, dp) != (Q, D):
        qi = torch.nn.functional.pad(qi, (0, dp - D, 0, qp - Q))
    if (np_, dp) != (n, D):
        block = torch.nn.functional.pad(block, (0, dp - D, 0, np_ - n))
    return torch._int_mm(qi, block.t())[:Q, :n]


def topk_mips_int8(queries: torch.Tensor, codes: torch.Tensor,
                   scales: torch.Tensor, k: int = 10,
                   block_n: int = 1_048_576
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MIPS over an int8 corpus (:func:`quantize_corpus_int8`).

    Queries quantize per row to int8 as the corpus does; each block's
    scores are the int8 x int8 products, exact in int32, times the corpus
    scales, ranked in bf16 (as the JAX package ranks them; ties are common
    there, and the order among tied ids may differ from ``lax.top_k``'s);
    the winners merge exactly and take the query scales at the end, so the
    scores returned are the quantized inner products.

    ``block_n``: the JAX package scores 4,194,304 rows a block, whose
    [Q, block_n] int32 transient at the host wrapper's 4,096 queries is
    68.7 GB; here 1,048,576 (17.2 GB, then 8.6 GB for its bf16 ranking
    copy), which only the tie order can tell apart."""
    Q = queries.shape[0]
    N = codes.shape[0]
    q32 = queries.float()
    qi, qs = _quantize_rows(q32)
    block_n = min(block_n, max(k, N))
    best_s, best_i = _init(Q, k, queries.device)
    for start in range(0, N, block_n):
        sc = _int8_scores(qi, codes[start:start + block_n]).to(
            torch.bfloat16)
        sc.mul_(scales[start:start + block_n].to(torch.bfloat16)[None, :])
        bs, bi = torch.topk(sc, min(k, sc.shape[1]), dim=1)
        best_s, best_i = _merge(best_s, best_i, bs.float(), bi + start, k)
    best_s, best_i = _unfilled_to_zero(best_s, best_i)
    return best_s * qs[:, None], best_i


def retrieve_topk(query_embs: np.ndarray, corpus_embs: np.ndarray,
                  corpus_ids: np.ndarray, k: int = 10,
                  query_batch: int = 4096, device="cuda",
                  approx: bool = False, quantize: bool = False) -> np.ndarray:
    """Host wrapper: batch queries, map indices back to corpus ids. Returns
    [Q, k] of ``corpus_ids`` dtype (e.g. uint64 retrieval ids). ``approx``
    takes :func:`topk_mips_approx`; ``quantize`` the int8 corpus (quantized
    on the host, only its codes and scales on ``device``)."""
    if quantize:
        corpus = quantize_corpus_int8(corpus_embs, device)
    else:
        corpus = torch.as_tensor(np.asarray(corpus_embs, np.float32),
                                 device=device)
    out = []
    for s in range(0, len(query_embs), query_batch):
        q = torch.as_tensor(np.asarray(query_embs[s:s + query_batch],
                                       np.float32), device=device)
        if quantize:
            _, idx = topk_mips_int8(q, *corpus, k=k)
        elif approx:
            _, idx = topk_mips_approx(q, corpus, k=k)
        else:
            _, idx = topk_mips(q, corpus, k=k)
        out.append(idx.cpu().numpy())
    return np.asarray(corpus_ids)[np.concatenate(out, axis=0)]
