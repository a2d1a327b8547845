"""Top-k maximum-inner-product search: exact, blocked, and int8.

Counterpart of ``tencent_recommendation_2025_tpu/retrieval/mips.py``, its
single-device tiers; the JAX package leaves all of them to XLA, so here
they are plain PyTorch.

- :func:`topk_mips`, exact. On the card, the hand-written kernel
  :func:`mips_topk` (``csrc/mips_topk.cu``, two launches, no sync): f32
  FFMA scoring with each query's running top k kept in registers and
  shared memory, so that no score reaches device memory, then a merge of
  the corpus slices' winners. On the CPU, its plain version
  :func:`_topk_mips_plain`: blocked ``[Q, D] x [D, N]`` scoring with a
  running top-k merge, so peak memory is O(Q * (k + block_n)), never
  O(Q * N).
- :func:`topk_mips_approx`: the JAX package takes ``lax.approx_max_k`` per
  1M-row block, then one exact merge of the block winners. CUDA has no
  approximate top-k: on the card it takes :func:`mips_topk`, the exact
  result in the exact tier's order; on the CPU each block takes an exact
  top-k, which meets the contract (recall 1) and returns the exact ids.
- :func:`quantize_corpus_int8` / :func:`topk_mips_int8`: the corpus as
  per-row symmetric int8 codes and f32 scales (4x smaller than f32: the
  route for a corpus whose f32 form does not fit the card), queries
  quantized per row, int8 x int8 scores exact in int32, times the corpus
  scales and ranked in bf16, the query scales applied at the end. The
  codes are stored [N, D]: the JAX package's [D, N] store exists for the
  TPU's int8 tiling only.

The sharded tier (JAX ``retrieval/mips.py:255-471``) serves a corpus no
card holds whole: :func:`shard_corpus` / :func:`shard_corpus_int8` row-shard
it over every axis of a mesh, flattened (``parallel.mesh.world_shards`` = S
shards of ``ceil(N / S)`` rows; shard s holds global rows [s * rows, (s + 1)
* rows), zero-padded at the end). A process of a process mesh holds its
rank's shard on its card, sliced (and quantized) on the host before the
copy; a local mesh holds every shard on its one card. Each shard runs the
tier's blocked top-k with its base row and the corpus's N, so that every
global row at or past N scores the lowest value *before* the shard's top-k
(in all three tiers: the JAX approx path masks its pad rows only after the
per-shard top-k, where zero pad rows can displace real rows of negative
score). One all-gather of each shard's k winners over every process, then
an exact top k of the S * k candidates in shard order (ties to the lower
place, as ``lax.top_k``), gives the global result
(:func:`sharded_topk_mips`, :func:`sharded_topk_mips_int8`).
:func:`retrieve_topk` shards once and serves every query batch from the
placed shards; with no mesh it builds one over the process group where one
with more than one process is initialised (one card a process: the
counterpart of the JAX wrapper's ``jax.device_count() > 1`` rule).

Indices are global corpus rows; where k exceeds the corpus, the missing
places score the lowest f32 value with index 0. Tied scores resolve as
``lax.top_k`` resolves them, to the lower index, so that a mesh returns one
card's ids (equal corpus vectors tie in f32; the int8 tier's bf16 ranking
ties often). The kernel ranks by score, then row, throughout. The plain
scans merge block winners by a stable sort; each block's top k is
``torch.topk``'s, which may keep any of several scores tied across the k-th
place, so it takes the k + 1-th too, and a row whose such tie could reach
its final winners is scanned again with ``lax.top_k``'s choice
(:func:`_top_k`, :func:`_resolve_spills`: one sync a call; a corpus of one
block takes that choice at once).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..parallel.mesh import world_shards
from ..utils import tracing as TRC

_NEG = torch.finfo(torch.float32).min


def _by_index(v: torch.Tensor, i: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winners [Q, k] in descending value, equal values in ascending index
    (``lax.top_k``'s order)."""
    i, order = torch.sort(i, dim=1)
    v, order = torch.sort(torch.gather(v, 1, order), dim=1, descending=True,
                          stable=True)
    return v, torch.gather(i, 1, order)


def _top_k(x: torch.Tensor, k: int, exact: bool):
    """The k largest of each row of ``x``, whose columns are in index order
    among equal values: (values, columns, probe). ``lax.top_k`` keeps the
    lowest columns of values tied across the k-th place; ``torch.topk``
    keeps any, so it takes the k + 1-th value too: ``probe`` [Q, 2] holds
    the k-th and k + 1-th values, for :func:`_resolve_spills`. ``exact``:
    ``lax.top_k``'s choice (the tied rows through ``models.rqvae.top_k``,
    one sync), the winners in :func:`_by_index` order, and no probe."""
    k = min(k, x.shape[1])
    if exact:
        v, i = torch.topk(x, k, dim=1)
        tied = ((x >= v[:, -1:]).sum(1) > k).nonzero()[:, 0]
        if tied.numel():
            from ..models.rqvae import top_k

            v[tied], i[tied] = top_k(x[tied], k)
        v, i = _by_index(v, i)
        return v, i, None
    v, i = torch.topk(x, min(k + 1, x.shape[1]), dim=1)
    probe = v[:, k - 1:] if v.shape[1] > k else None
    return v[:, :k], i[:, :k], probe


def _merge(best_s, best_i, s, i, k):
    """The top k of the running winners and a block's, both in
    :func:`_by_index` order and the block's indices after the winners': a
    stable sort keeps the lower index of equal scores, as ``lax.top_k``."""
    best_s, pos = torch.sort(torch.cat([best_s, s.float()], dim=1), dim=1,
                             descending=True, stable=True)
    return best_s[:, :k], torch.gather(torch.cat([best_i, i], dim=1), 1,
                                       pos[:, :k])


def _init(Q, k, dev):
    return (torch.full((Q, k), _NEG, dtype=torch.float32, device=dev),
            torch.zeros((Q, k), dtype=torch.long, device=dev))


def _resolve_spills(best_s, best_i, probes, rerun):
    """A scan's winners as a tier returns them. A probe whose k-th value
    ties the k + 1-th marks a top-k where ``torch.topk`` chose among tied
    scores; the rows where such a tie is at or above their final k-th score
    (one sync a call) are scanned again by ``rerun(rows)``, which takes
    ``lax.top_k``'s choice everywhere. Every row in :func:`_by_index` order;
    places no corpus row filled keep (lowest score, row 0). Spans
    ``mips.resolve`` and, around the second scan, ``mips.rescan``; the rows
    scanned again count in ``mips.rescanned_rows`` on every call, 0
    included."""
    with TRC.span("mips.resolve"):
        n = 0
        if probes:
            p = torch.stack([x.float() for x in probes])    # [blocks, Q, 2]
            tie = (p[..., 1] == p[..., 0]) & (p[..., 0] > _NEG)
            spill = torch.where(tie, p[..., 0], _NEG).amax(0)
            rows = (tie.any(0) & (spill >= best_s[:, -1])).nonzero()[:, 0]
            n = rows.numel()
            if n:
                with TRC.span("mips.rescan"):
                    best_s[rows], best_i[rows] = rerun(rows)
        TRC.count("mips.rescanned_rows", n)
        best_s, best_i = _by_index(best_s, best_i)
        return best_s, torch.where(best_s == _NEG, torch.zeros_like(best_i),
                                   best_i)


def _mask_pad(s: torch.Tensor, first: int, n_valid: Optional[int],
              low) -> torch.Tensor:
    """Block scores ``s`` [Q, n] whose column 0 is global row ``first``,
    with the columns at or past ``n_valid`` (a shard's pad rows) set to
    ``low``, in place; ``s`` itself without ``n_valid``."""
    if n_valid is not None and first + s.shape[1] > n_valid:
        s[:, max(0, n_valid - first):] = low
    return s


def _scan_f32(q, corpus, k, block_n, base, n_valid, whole, exact):
    """The f32 tiers' scan: each block's scores, pad rows masked, then the
    top k of the running winners with the whole block (``whole``: exact
    tier) or the stable merge of the block's own top k (approx tier). A
    corpus of one block takes ``lax.top_k``'s choice at once. Returns
    (scores, indices, probes). Spans a block: ``mips.score`` (the product,
    the pad mask) and ``mips.select`` (the top k, the merge)."""
    Q, N = q.shape[0], corpus.shape[0]
    exact = exact or N <= block_n
    best_s, best_i = _init(Q, k, q.device)
    probes = []
    for start in range(0, N, block_n):
        with TRC.span("mips.score"):
            block = corpus[start:start + block_n].float()
            s = _mask_pad(q @ block.T, base + start, n_valid, _NEG)
        with TRC.span("mips.select"):
            if whole:
                idx = torch.arange(base + start,
                                   base + start + block.shape[0],
                                   device=q.device)[None, :].expand(Q, -1)
                best_s, pos, pr = _top_k(torch.cat([best_s, s], dim=1), k,
                                         exact)
                best_i = torch.gather(torch.cat([best_i, idx], dim=1), 1,
                                      pos)
            else:
                bs, bi, pr = _top_k(s, k, exact)
                best_s, best_i = _merge(best_s, best_i,
                                        *_by_index(bs, bi + base + start), k)
        if pr is not None:
            probes.append(pr)
    return best_s, best_i, probes


#: the kernel's limits (``csrc/mips_topk.cu``): places of the top k, widths
KERNEL_MAX_K = 128
KERNEL_MAX_D = 1024
#: corpus rows a kernel call scans: rows are int32 there, and a list's k
#: sentinel rows rank after every real one
KERNEL_MAX_ROWS = 2 ** 31 - 1 - KERNEL_MAX_K
#: corpus rows a tile of the scan kernel; shared-memory budgets (bytes) of
#: a block's query tile and of its queries' top-k lists
_TILE_ROWS = 128
_QUERY_TILE_BYTES = 72 * 1024
_LIST_BYTES = 32 * 1024


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """:func:`mips_topk`'s cut of a scan: ``qtiles`` query tiles of 16
    ``tm`` queries times ``slices`` slices of ``rows`` corpus rows (the last
    one shorter), one block each."""

    tm: int
    qtiles: int
    slices: int
    rows: int


def _query_pitch(D: int) -> int:
    """Floats a query row takes in the kernel's shared memory: D rounded up
    to 4, an odd number of 16-byte groups."""
    pa = -(-D // 4) * 4
    return pa + 4 if pa // 4 % 2 == 0 else pa


def scan_plan(Q: int, n: int, k: int, D: int, sms: int) -> ScanPlan:
    """The kernel's cut of a scan of ``n`` corpus rows for ``Q`` (>= 1)
    queries on a card of ``sms`` SMs. The query tile is the narrowest of 16,
    32 and 64 queries that holds Q, narrowed further until it fits its
    shared-memory budget (wide D) and its top-k lists theirs (large k). The
    rows split into slices of whole 128-row tiles: enough for two blocks an
    SM over the query tiles (one slice where the query tiles alone fill
    them), none empty; no slice for ``n`` = 0. (On an H100 a tile of 128
    queries, whose register tile holds one block an SM, ran the scan at
    Q = 1024 over 10M x 64 in 50-54 ms, one of 64 in 41-44.)"""
    tm = 4
    while tm > 1 and 16 * (tm // 2) >= Q:
        tm //= 2
    while tm > 1 and (16 * tm * _query_pitch(D) * 4 > _QUERY_TILE_BYTES
                      or 16 * tm * k * 8 > _LIST_BYTES):
        tm //= 2
    qtiles = -(-Q // (16 * tm))
    if n <= 0:
        return ScanPlan(tm, qtiles, 0, 0)
    tiles = -(-n // _TILE_ROWS)
    per = -(-tiles // max(1, min(tiles, 2 * sms // qtiles)))
    return ScanPlan(tm, qtiles, -(-tiles // per), per * _TILE_ROWS)


def scan_smem_bytes(tm: int, D: int, k: int) -> int:
    """Dynamic shared memory of a scan block (the kernel's ``scan_smem``):
    the query tile, three stages of 128 rows of 36 floats, the queries' top-k
    lists and 32 candidate slots each, and the slots' counts."""
    bm = 16 * tm
    return 4 * (bm * _query_pitch(D) + 3 * _TILE_ROWS * 36 + 2 * bm * k
                + 2 * bm * 32 + bm)


def _rows_scanned(N: int, base: int, n_valid: Optional[int]) -> int:
    """Rows [0, n) of a shard of N rows whose row 0 is global row ``base``
    that hold corpus rows: those below global row ``n_valid``."""
    return N if n_valid is None else max(0, min(N, n_valid - base))


def _check_kernel_shapes(k: int, D: int, N: int) -> None:
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"mips_topk: k = {k} is outside the kernel's limit "
                         f"1..{KERNEL_MAX_K} (KERNEL_MAX_K)")
    if not 1 <= D <= KERNEL_MAX_D:
        raise ValueError(f"mips_topk: width D = {D} is outside the kernel's "
                         f"limit 1..{KERNEL_MAX_D} (KERNEL_MAX_D)")
    if N > KERNEL_MAX_ROWS:
        raise ValueError(f"mips_topk: {N} corpus rows exceed the kernel's "
                         f"limit {KERNEL_MAX_ROWS} (KERNEL_MAX_ROWS)")


def _kernel_fn(name: str):
    fn = getattr(kernels.load("mips_topk"), name)
    fn.restype = ctypes.c_int
    ints = 8 if name == "mips_topk_scan" else 3
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints \
        + [ctypes.c_longlong, ctypes.c_void_p]
    return fn


def mips_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int = 10,
              base: int = 0, n_valid: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact top k of ``queries`` [Q, D] against ``corpus`` [N, D], CUDA
    tensors, by the hand-written kernel ``csrc/mips_topk.cu``: (scores
    [Q, k] f32, global rows [Q, k] int64) in :func:`_by_index` order, as
    :func:`_topk_mips_plain` returns them. Scores are f32 FFMA sums over D
    in column order. ``base`` / ``n_valid`` as :func:`topk_mips`'s: rows at
    or past global row ``n_valid`` are never scored; places no row filled
    hold (lowest f32, 0). Two launches, span ``mips.scan`` around the scan
    of the corpus slices (:func:`scan_plan`) and ``mips.merge`` around the
    merge of their winners; no sync. Counted in ``mips_topk.launches`` (a
    call), the queries in ``mips.kernel_queries``, and 0 in
    ``mips.rescanned_rows``: nothing is scanned again. k, D and N beyond
    the kernel's limits raise; any other dtype or layout of the operands
    is taken as contiguous f32 (queries as f32 rows of unit stride: the
    last position of a batch's activations is read in place)."""
    Q, D = queries.shape
    N = corpus.shape[0]
    _check_kernel_shapes(k, D, N)
    dev = corpus.device
    if dev.type != "cuda" or queries.device != dev or corpus.shape[1] != D:
        raise ValueError(f"mips_topk: needs queries [Q, D] and corpus [N, D] "
                         f"on one card, got {tuple(queries.shape)} on "
                         f"{queries.device} and {tuple(corpus.shape)} on "
                         f"{dev}")
    TRC.count("mips.kernel_queries", Q)
    TRC.count("mips.rescanned_rows", 0)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.long, device=dev)
    if Q == 0:
        return out_s, out_i
    q = queries
    if q.dtype != torch.float32 or q.stride(1) != 1 \
            or (Q > 1 and q.stride(0) < D):
        q = q.float().contiguous()
    c = corpus.float().contiguous()
    n = _rows_scanned(N, base, n_valid)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = scan_plan(Q, n, k, D, sms)
    part_s = torch.empty((plan.slices, Q, k), dtype=torch.float32, device=dev)
    part_r = torch.empty((plan.slices, Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if plan.slices:
            with TRC.span("mips.scan"):
                rc = _kernel_fn("mips_topk_scan")(
                    q.data_ptr(), c.data_ptr(), part_s.data_ptr(),
                    part_r.data_ptr(), Q, D, k, n, plan.rows, plan.slices,
                    plan.tm, int(D % 4 == 0 and c.data_ptr() % 16 == 0),
                    q.stride(0) if Q > 1 else D, stream)
            if rc != 0:
                raise RuntimeError(f"mips_topk scan kernel launch failed: "
                                   f"CUDA error {rc}")
        with TRC.span("mips.merge"):
            rc = _kernel_fn("mips_topk_merge")(
                part_s.data_ptr(), part_r.data_ptr(), out_s.data_ptr(),
                out_i.data_ptr(), Q, k, plan.slices, int(base), stream)
        if rc != 0:
            raise RuntimeError(f"mips_topk merge kernel launch failed: CUDA "
                               f"error {rc}")
    mips_topk.launches += 1
    return out_s, out_i


mips_topk.launches = 0


def _topk_mips_plain(queries: torch.Tensor, corpus: torch.Tensor,
                     k: int = 10, block_n: int = 65536, base: int = 0,
                     n_valid: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_mips`'s plain version, on any device: the blocked scan
    (:func:`_scan_f32`) and the tie rescan (:func:`_resolve_spills`). Span
    ``topk_mips``; the queries count in ``mips.queries``."""
    block_n = min(block_n, max(k, corpus.shape[0]))
    with TRC.span("topk_mips"):
        TRC.count("mips.queries", queries.shape[0])
        q = queries.float()
        out = _scan_f32(q, corpus, k, block_n, base, n_valid, True, False)
        return _resolve_spills(*out, lambda rows: _scan_f32(
            q[rows], corpus, k, block_n, base, n_valid, True, True)[:2])


def topk_mips(queries: torch.Tensor, corpus: torch.Tensor, k: int = 10,
              block_n: int = 65536, base: int = 0,
              n_valid: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], corpus [N, D] -> (scores [Q, k] f32, indices [Q, k]
    int64). ``base``/``n_valid``, for a shard: its row 0 is global row
    ``base``, and global rows at or past ``n_valid`` are padding, scored
    the lowest value before the top-k; indices are global rows. A CPU
    corpus takes :func:`_topk_mips_plain` (``block_n`` rows a block), any
    other :func:`mips_topk` (the kernel: no blocks). Span ``topk_mips``;
    the queries count in ``mips.queries``."""
    if corpus.device.type == "cpu":
        return _topk_mips_plain(queries, corpus, k, block_n, base, n_valid)
    with TRC.span("topk_mips"):
        TRC.count("mips.queries", queries.shape[0])
        return mips_topk(queries, corpus, k, base, n_valid)


def topk_mips_approx(queries: torch.Tensor, corpus: torch.Tensor,
                     k: int = 10, block_n: int = 1_048_576, base: int = 0,
                     n_valid: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's approximate tier: on the card :func:`mips_topk`,
    the exact tier's kernel, bitwise :func:`topk_mips`'s result; on the CPU
    per 1M-row block the top k (exact here, where the TPU takes
    ``approx_max_k``), then one merge of the block winners, the exact
    result. ``base`` / ``n_valid`` as :func:`topk_mips`'s: pad rows are
    never scored on the card and masked before each block's top-k on the
    CPU. Spans and counters as :func:`topk_mips`'s."""
    if corpus.device.type != "cpu":
        with TRC.span("topk_mips"):
            TRC.count("mips.queries", queries.shape[0])
            return mips_topk(queries, corpus, k, base, n_valid)
    block_n = min(block_n, max(k, corpus.shape[0]))
    with TRC.span("topk_mips"):
        TRC.count("mips.queries", queries.shape[0])
        q = queries.float()
        out = _scan_f32(q, corpus, k, block_n, base, n_valid, False, False)
        return _resolve_spills(*out, lambda rows: _scan_f32(
            q[rows], corpus, k, block_n, base, n_valid, False, True)[:2])


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
    Its shape rules (more than 16 rows; inner widths multiples of 8; block
    rows a multiple of 32, below which cuBLASLt refused a shard's 25,000
    rows on the card) are met by zero padding, which adds nothing to the
    real scores."""
    Q, D = qi.shape
    n = block.shape[0]
    qp = max(24, -(-Q // 8) * 8)
    dp, np_ = -(-D // 8) * 8, -(-n // 32) * 32
    if (qp, dp) != (Q, D):
        qi = torch.nn.functional.pad(qi, (0, dp - D, 0, qp - Q))
    if (np_, dp) != (n, D):
        block = torch.nn.functional.pad(block, (0, dp - D, 0, np_ - n))
    return torch._int_mm(qi, block.t())[:Q, :n]


def _scan_int8(qi, codes, scales, k, block_n, base, n_valid, exact):
    """The int8 tier's scan (before the query scales): each block's int32
    scores times the corpus scales in bf16, pad rows masked, its top k
    merged into the running winners. A corpus of one block takes
    ``lax.top_k``'s choice at once. Returns (scores, indices, probes).
    Spans a block as :func:`_scan_f32`'s."""
    exact = exact or codes.shape[0] <= block_n
    best_s, best_i = _init(qi.shape[0], k, qi.device)
    probes = []
    for start in range(0, codes.shape[0], block_n):
        with TRC.span("mips.score"):
            sc = _int8_scores(qi, codes[start:start + block_n]).to(
                torch.bfloat16)
            sc.mul_(scales[start:start + block_n].to(torch.bfloat16)[None, :])
            _mask_pad(sc, base + start, n_valid, -float("inf"))
        with TRC.span("mips.select"):
            bs, bi, pr = _top_k(sc, k, exact)
            best_s, best_i = _merge(best_s, best_i,
                                    *_by_index(bs, bi + base + start), k)
        if pr is not None:
            probes.append(pr)
    return best_s, best_i, probes


def topk_mips_int8(queries: torch.Tensor, codes: torch.Tensor,
                   scales: torch.Tensor, k: int = 10,
                   block_n: int = 1_048_576, base: int = 0,
                   n_valid: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MIPS over an int8 corpus (:func:`quantize_corpus_int8`).

    Queries quantize per row to int8 as the corpus does; each block's
    scores are the int8 x int8 products, exact in int32, times the corpus
    scales, ranked in bf16 (as the JAX package ranks them; ties are common
    there); the winners merge exactly and take the query scales at the
    end, so the scores returned are the quantized inner products.

    ``block_n``: the JAX package scores 4,194,304 rows a block, whose
    [Q, block_n] int32 transient at the host wrapper's 4,096 queries is
    68.7 GB; here 1,048,576 (17.2 GB, then 8.6 GB for its bf16 ranking
    copy), the same ids.

    ``base`` / ``n_valid`` as :func:`topk_mips`'s: a shard's pad rows (code
    0, score 0) rank -inf in bf16 before each block's top-k. Spans and
    counters as :func:`topk_mips`'s."""
    block_n = min(block_n, max(k, codes.shape[0]))
    with TRC.span("topk_mips"):
        TRC.count("mips.queries", queries.shape[0])
        qi, qs = _quantize_rows(queries.float())
        out = _scan_int8(qi, codes, scales, k, block_n, base, n_valid, False)
        best_s, best_i = _resolve_spills(*out, lambda rows: _scan_int8(
            qi[rows], codes, scales, k, block_n, base, n_valid, True)[:2])
        return best_s * qs[:, None], best_i

# ---------------------------------------------------------------------------
# the sharded tier
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedCorpus:
    """A corpus row-sharded over every axis of ``mesh``: ``shards`` are the
    shards this process holds (``mesh.world_indices``), each [rows, D] f32,
    or (codes [rows, D] int8, scales [rows] f32) for the int8 tier; ``n``
    is the corpus's real rows, ``rows`` = ceil(n / S) a shard."""

    mesh: object
    shards: list
    n: int
    rows: int


def _rows_of(corpus, lo: int, hi: int, rows: int, device,
             dtype=None) -> torch.Tensor:
    """Global rows [lo, hi) of ``corpus`` (host array or tensor) on
    ``device`` (in ``dtype``), zero-padded to ``rows``: a host corpus is
    sliced before the copy; a tensor's rows that need no padding stay a
    view."""
    part = corpus[lo:hi]
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part))
    part = part.to(device, dtype)
    if part.shape[0] < rows:
        part = torch.cat([part, part.new_zeros(
            (rows - part.shape[0],) + tuple(part.shape[1:]))])
    return part


def _extent(mesh, n: int):
    """(S, rows a shard, [(shard, lo, hi)] of the shards this process
    holds)."""
    S = world_shards(mesh)
    rows = -(-n // S)
    return S, rows, [(s, min(s * rows, n), min((s + 1) * rows, n))
                     for s in mesh.world_indices]


def shard_corpus(mesh, corpus, device="cuda") -> ShardedCorpus:
    """``corpus`` [N, D] (host array or tensor) row-sharded over every axis
    of ``mesh``, in f32: this process's shards on ``device``; a sharded
    corpus as it is."""
    if isinstance(corpus, ShardedCorpus):
        return corpus
    n = corpus.shape[0]
    _, rows, held = _extent(mesh, n)
    return ShardedCorpus(mesh, [_rows_of(corpus, lo, hi, rows, device,
                                         torch.float32)
                                for _, lo, hi in held], n, rows)


def shard_corpus_int8(mesh, corpus, device="cuda") -> ShardedCorpus:
    """The int8 tier's corpus row-sharded over every axis of ``mesh``:
    ``corpus`` is [N, D] f32 (host array or tensor; a host corpus is
    quantized on the host shard by shard, so that only this process's codes
    and scales reach ``device``) or a (codes [N, D], scales [N]) pair from
    :func:`quantize_corpus_int8`. Pad rows hold code 0 and scale 1; a
    sharded corpus passes as it is."""
    if isinstance(corpus, ShardedCorpus):
        return corpus
    pair = isinstance(corpus, tuple)
    n = (corpus[0] if pair else corpus).shape[0]
    _, rows, held = _extent(mesh, n)
    shards = []
    for _, lo, hi in held:
        if pair:
            codes = _rows_of(corpus[0], lo, hi, rows, device)
            scales = corpus[1][lo:hi].to(device)
        else:
            codes, scales = quantize_corpus_int8(corpus[lo:hi], device)
            codes = _rows_of(codes, 0, hi - lo, rows, device)
        scales = torch.cat([scales, scales.new_ones(rows - (hi - lo))])
        shards.append((codes, scales))
    return ShardedCorpus(mesh, shards, n, rows)


def _merge_shard_topk(mesh, parts, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top k of the shards' winners: ``parts`` [(scores [Q, k],
    global indices [Q, k])] of the shards this process holds; one
    all-gather of each over every process, then the exact top k of the S *
    k candidates in shard order (a stable sort: tied scores keep the lower
    place, the lower index, as ``lax.top_k`` in the JAX merge)."""
    S = world_shards(mesh)
    Q = parts[0][0].shape[0]
    all_s = mesh.all_gather_world([s for s, _ in parts])[0]
    all_i = mesh.all_gather_world([i for _, i in parts])[0]
    cat_s = all_s.reshape(S, Q, k).transpose(0, 1).reshape(Q, S * k)
    cat_i = all_i.reshape(S, Q, k).transpose(0, 1).reshape(Q, S * k)
    best_s, pos = torch.sort(cat_s, dim=1, descending=True, stable=True)
    return best_s[:, :k], torch.gather(cat_i, 1, pos[:, :k])


def sharded_topk_mips(mesh, queries: torch.Tensor, corpus, k: int = 10,
                      block_n: int = 65536, approx: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MIPS over a corpus row-sharded on ``mesh``: each shard this
    process holds runs :func:`topk_mips` (``approx``: :func:`topk_mips_
    approx`, at the same ``block_n``, as the JAX sharded path passes it)
    over its rows, its pad rows masked first, and the winners
    merge across every process (:func:`_merge_shard_topk`). ``queries``
    [Q, D], the same on every process; ``corpus`` a :class:`ShardedCorpus`
    or a whole corpus to shard (:func:`shard_corpus`, on the queries'
    device). Returns (scores [Q, k], global indices [Q, k]) on every
    process."""
    corpus = shard_corpus(mesh, corpus, queries.device)
    fn = topk_mips_approx if approx else topk_mips
    parts = [fn(queries, shard, k=k, block_n=block_n, base=s * corpus.rows,
                n_valid=corpus.n)
             for s, shard in zip(mesh.world_indices, corpus.shards)]
    return _merge_shard_topk(mesh, parts, k)


def sharded_topk_mips_int8(mesh, queries: torch.Tensor, corpus, k: int = 10,
                           block_n: int = 1_048_576
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_mips_int8` over an int8 corpus row-sharded on ``mesh``
    (``corpus``: a :class:`ShardedCorpus` of :func:`shard_corpus_int8`, or
    what that takes), each shard's pad rows masked before its top-k, the
    winners merged as :func:`sharded_topk_mips`'s."""
    corpus = shard_corpus_int8(mesh, corpus, queries.device)
    parts = [topk_mips_int8(queries, codes, scales, k=k, block_n=block_n,
                            base=s * corpus.rows, n_valid=corpus.n)
             for s, (codes, scales) in zip(mesh.world_indices,
                                              corpus.shards)]
    return _merge_shard_topk(mesh, parts, k)


def corpus_mesh():
    """The mesh a serving corpus shards over without one given: a process
    mesh over the initialised process group when it holds more than one
    process (one card each), else None (one card)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return None
    from ..parallel.mesh import build_mesh

    return build_mesh()


def retrieve_topk(query_embs: np.ndarray, corpus_embs: np.ndarray,
                  corpus_ids: np.ndarray, k: int = 10,
                  query_batch: int = 4096, device="cuda", mesh=None,
                  approx: bool = False, quantize: bool = False) -> np.ndarray:
    """Host wrapper: batch queries, map indices back to corpus ids. Returns
    [Q, k] of ``corpus_ids`` dtype (e.g. uint64 retrieval ids). ``approx``
    takes :func:`topk_mips_approx`; ``quantize`` the int8 corpus (quantized
    on the host, only its codes and scales on ``device``). With ``mesh``
    (or, without one, :func:`corpus_mesh`'s) the corpus is sharded once
    (:func:`shard_corpus` / :func:`shard_corpus_int8`: a host corpus sliced
    on the host, so that a process copies only its rows) and every query
    batch runs the sharded tier; every process gets the result."""
    if mesh is None:
        mesh = corpus_mesh()
    if mesh is not None:
        corpus = shard_corpus_int8(mesh, corpus_embs, device) if quantize \
            else shard_corpus(mesh, corpus_embs, device)
    elif quantize:
        corpus = quantize_corpus_int8(corpus_embs, device)
    else:
        corpus = torch.as_tensor(np.asarray(corpus_embs, np.float32),
                                 device=device)
    out = []
    for s in range(0, len(query_embs), query_batch):
        with TRC.span("request", {"batch": s // query_batch}):
            q = torch.as_tensor(np.asarray(query_embs[s:s + query_batch],
                                           np.float32), device=device)
            if mesh is not None and quantize:
                _, idx = sharded_topk_mips_int8(mesh, q, corpus, k=k)
            elif mesh is not None:
                _, idx = sharded_topk_mips(mesh, q, corpus, k=k,
                                           approx=approx)
            elif quantize:
                _, idx = topk_mips_int8(q, *corpus, k=k)
            elif approx:
                _, idx = topk_mips_approx(q, corpus, k=k)
            else:
                _, idx = topk_mips(q, corpus, k=k)
            out.append(idx.cpu().numpy())
    return np.asarray(corpus_ids)[np.concatenate(out, axis=0)]
