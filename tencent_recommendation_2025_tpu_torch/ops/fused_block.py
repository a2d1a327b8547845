"""Fused pre-norm HSTU block: CUDA kernels, plain versions, autograd, gate.

Counterpart of ``tencent_recommendation_2025_tpu/ops/fused_block.py``. One
call runs a whole HSTU block (pre-norm, SwiGLU FFN) on [B, L, D]
activations and returns ``x + block(x)``:

    h    = LN(x; ln1)
    uvqk = silu(h @ Wuvqk + b);  u, v, q, k = split(uvqk)
    av   = (silu(q k^T * hd^-1/2 + rab) * causal * key_valid / L) @ v
    y    = x + drop1(LN(av; ln2) * u) @ Wo + bo
    out  = y + drop2(silu(x1) * x3) @ W2,   [x1 | x3] = LN(y; ln3) @ W13

Kernels, each replacing TPU kernels of the JAX package's file:

- ``csrc/fused_block.cu`` (``proj_wgmma_kernel`` then
  ``attn_ffn_wgmma_kernel`` in bf16 at D <= 128; ``proj_kernel`` then
  ``attn_ffn_kernel`` in f32 and wider). Inference
  (:func:`fused_hstu_block`) and training (:func:`fused_hstu_block_train`:
  the two dropouts, and ``av`` written for the backward). Replaces
  ``_fwd_kernel`` (l.274) and, in the chunked variant, the three forward
  stages: ``_fwd_pre_kernel_chunk`` (l.452) is the first kernel;
  ``_fwd_attn_kernel_chunk`` (l.468) and ``_fwd_post_kernel_chunk``
  (l.502) are the attention and the post half of the second kernel.
  Bound on the H100 at the flagship shape (B=128, L=1024, D=64, F=256,
  H=1): compute, 35.4 GFLOP per block, 36 us at 989 TFLOP/s bf16.
- ``csrc/fused_block_bwd.cu`` (:func:`fused_hstu_block_bwd`): recompute
  from x and av, dx and every weight, LN, bias and rel-pos gradient.
  Replaces ``_bwd_kernel`` (l.325) and, in the chunked variant,
  ``_bwd_gate_kernel_chunk`` (l.612) with ``gate_ffn_bwd_wgmma_kernel`` and
  ``wgrad_wgmma_kernel`` (the weight products over tokens, from bf16
  scratch) in bf16 at D <= 128, ``gate_ffn_bwd_kernel`` in f32 and wider,
  ``_bwd_dq_kernel_chunk`` (l.533) and ``_bwd_dkdv_kernel_chunk`` (l.573)
  with the HSTU attention backward of ``csrc/hstu_attn_bwd_sm90.cuh`` at off
  0 (``attn_bwd_dq_wgmma_kernel``, which also sums the rel-pos gradient,
  and ``attn_bwd_dkdv_wgmma_kernel`` in bf16 at hd <= 128; the generic
  ``attn_bwd_dq_kernel`` and ``attn_bwd_dkdv_kernel`` in f32 and wider),
  and ``_bwd_proj_kernel_chunk`` (l.710) with ``proj_bwd_wgmma_kernel``
  (dWuvqk by ``wgrad_wgmma_kernel``) in bf16 at D <= 128,
  ``proj_bwd_kernel`` in f32 and wider, the gradients summed by
  ``reduce_rows_kernel``. Bound: compute, 93.5 GFLOP per block, 94.5 us.

- The ring units of a sequence-sharded mesh (the last section below):
  ``csrc/ring_pair.cu`` for one (query shard, key shard) pair, replacing
  ``_pair_attn_fwd_kernel`` (l.1269; in bf16 by ``pair_fwd_wgmma_kernel``,
  the single device's attention loop at the pair's offset), and
  ``_pair_dq_kernel`` (l.1304) and ``_pair_dkdv_kernel`` (l.1345) through
  the same attention backward as the single device's, and launches of their
  own for the pre and post stages and their backwards.

Variants. The TPU package takes the whole-sequence kernels up to
``wholeseq_max_l(D)`` and the chunked ones above it (:func:`chunked`), for
VMEM's sake alone. The CUDA kernels stage q, k, v and u through global
memory and stream key tiles at every L, so both variants are the same
kernels. They differ at one rounding point: the chunked attention stage
writes ``av`` in the activation dtype and the post stage's LN2 reads that
rounded value, where the whole-sequence kernel feeds LN2 the f32 sum. The
forward kernel rounds ``av`` there when the variant is chunked, and so do
the plain versions; the backward reads the saved ``av`` in both.

:class:`FusedBlockFn` ties them into autograd. It takes the block's f32
parameter leaves and casts inside, so weight gradients reach them in f32,
unrounded, as the JAX custom VJP delivers them.

Numerics (those of the TPU kernels): matmul operands in the activation dtype
with f32 accumulation; LN, SiLU, gating and residuals in f32; ``q*hd^-1/2``,
``v/L`` and ``silu(s)`` rounded to the activation dtype before their
products; LN eps 1e-8; division by the padded L; keys with token_type 0
masked, queries not. The backward rounds dout, dx13, dy, dav, ds and duvqk
to the activation dtype where they are product operands; dx leaves in the
activation dtype, every other gradient in f32.

Dropout: an element is kept iff its 32 random bits are >= ``uint32(p *
2^32)``, and a kept element is scaled by 1/(1-p). The TPU's in-kernel PRNG
cannot be reproduced on CUDA, so the bits are a counter-based hash
(:func:`dropout_bits`) that the kernels and the plain versions compute alike,
and the backward regenerates the masks instead of storing them.

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from . import kernels

FB_BLK = 128             # TPU stripe width: the gate's L granularity
FB_WHOLESEQ_MAX = 1024   # whole-sequence variant ceiling at D=64
FB_CHUNK = 512           # L-chunk width of the TPU's chunked kernels (gate)
FB_ATTN_BLK = 256        # the TPU's forward attention tile (ring gate)
FB_ATTN_BLK_BWD = 512
MAX_CHUNKED_L = 16384
_EPS = 1e-8


def wholeseq_max_l(D: int) -> int:
    """Longest L of the whole-sequence variant at width D; longer runs take
    the chunked variant."""
    return FB_WHOLESEQ_MAX * 64 // max(D, 64)


def chunked(L: int, D: int) -> bool:
    """Whether length L at width D takes the chunked variant (the JAX
    package's ``L > wholeseq_max_l(D)``; read at call time, so a test can
    shrink ``FB_WHOLESEQ_MAX``)."""
    return L > wholeseq_max_l(D)


#: widest model the fused kernels accept
MAX_FUSED_D = 64 * FB_ATTN_BLK_BWD // FB_BLK


def _chunk_of(Lc: int, D: int = 64):
    """Projection/FFN chunk width of the chunked kernels at length Lc."""
    for c in (FB_CHUNK, 256, 128):
        if Lc % c == 0 and D * c <= 128 * FB_CHUNK:
            return c
    return None


def fused_block_supported(cfg, L: int, backend: str) -> bool:
    """The fused-block gate of the JAX package with ``"cuda"`` in place of
    ``"tpu"``: the shapes on which it takes its Pallas fused kernels."""
    # imported here: ops.hstu_attention imports this module
    from .hstu_attention import _n_near

    if not (getattr(cfg, "fused_block", False) and backend == "cuda"):
        return False
    if cfg.block_type != "hstu" or cfg.ffn_type != "swiglu":
        return False
    if cfg.hidden_units > MAX_FUSED_D:
        return False
    if not (256 <= L and L % FB_BLK == 0):
        return False
    if L > wholeseq_max_l(cfg.hidden_units) and not (
            L <= MAX_CHUNKED_L
            and _chunk_of(L, cfg.hidden_units) is not None):
        return False
    if cfg.hidden_units % cfg.num_heads != 0:
        return False
    if (cfg.hidden_units // cfg.num_heads) % 8 != 0:
        return False
    try:
        _n_near(cfg.hstu_rel_pos_buckets, FB_BLK)
    except ValueError:
        return False
    return True


def _attn_blk(L: int, D: int = 64) -> int:
    """The TPU's forward attention tile at length L and width D, the tile
    whose bias slots the ring gate counts."""
    for blk in (FB_ATTN_BLK, FB_BLK):
        if L % blk == 0 and D * blk <= 64 * FB_ATTN_BLK_BWD:
            return blk
    return FB_BLK


def ring_fused_supported(cfg, L: int, n_seq: int, backend: str) -> bool:
    """The JAX package's gate of the per-shard fused path on a ``seq``
    mesh, with ``"cuda"`` in place of ``"tpu"``: the fused-block shape
    rules applied to the shard length L / n_seq."""
    from .hstu_attention import _n_near

    if not (getattr(cfg, "fused_block", False) and backend == "cuda"):
        return False
    if cfg.block_type != "hstu" or cfg.ffn_type != "swiglu":
        return False
    if L % n_seq:
        return False
    D = cfg.hidden_units
    if D > MAX_FUSED_D:
        return False
    Lc = L // n_seq
    if Lc < 256 or Lc % FB_BLK or _chunk_of(Lc, D) is None:
        return False
    if D % cfg.num_heads or (D // cfg.num_heads) % 8:
        return False
    try:
        _n_near(cfg.hstu_rel_pos_buckets, _attn_blk(Lc, D=D))
    except ValueError:
        return False
    return True


def block_operands(bp: Mapping, dtype: torch.dtype) -> dict:
    """Kernel-ready operands from a block parameter subtree
    ({attn_ln, ffn_ln, ffn{w13, w2}, hstu{uvqk, out, attn_ln, rab}}):
    weights in the activation dtype, LN pack / biases / rab in f32. On the
    stacked tree of every block each operand gains the leading
    [num_blocks] axis, so a caller builds them once for the whole chain."""
    f32 = torch.float32
    h = bp["hstu"]
    ln = torch.stack([bp["attn_ln"]["scale"], bp["attn_ln"]["bias"],
                      h["attn_ln"]["scale"], h["attn_ln"]["bias"],
                      bp["ffn_ln"]["scale"], bp["ffn_ln"]["bias"]],
                     dim=-2).to(f32)
    return {
        "ln": ln.contiguous(),                               # [6, D]
        "wuvqk": h["uvqk"]["w"].to(dtype).contiguous(),      # [D, 4D]
        "buvqk": h["uvqk"]["b"].to(f32).contiguous(),        # [4D]
        "wo": h["out"]["w"].to(dtype).contiguous(),          # [D, D]
        "bo": h["out"]["b"].to(f32).contiguous(),            # [D]
        "w13": bp["ffn"]["w13"].to(dtype).contiguous(),      # [D, 2F]
        "w2": bp["ffn"]["w2"].to(dtype).contiguous(),        # [F, D]
        "rab": h["rab"].to(f32).contiguous(),                # [H, NB]
    }


def _ln_stats(xf):
    """(xhat, rstd) of an f32 LayerNorm over the last axis."""
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) * (xf - mu)).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + _EPS)
    return (xf - mu) * rstd, rstd


def _ln(xf, g, b):
    return _ln_stats(xf)[0] * g + b


def _ln_bwd(dy, xhat, rstd, g):
    """dx of ``xhat * g + b`` over the last axis, with (dgamma, dbeta)
    summed over every token."""
    dxhat = dy * g
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    D = dy.shape[-1]
    return (rstd * (dxhat - m1 - xhat * m2),
            (dy * xhat).reshape(-1, D).sum(0), dy.reshape(-1, D).sum(0))


def _dsilu(s):
    sig = torch.sigmoid(s)
    return sig * (1.0 + s * (1.0 - sig))


def _mm(a, b):
    """Product of compute-dtype operands with f32 accumulation (bf16
    products are exact in f32)."""
    return torch.matmul(a.float(), b.float())


def _wsum(a, b):
    """Sum over every token of a^T b: [..., M] x [..., N] -> [M, N]."""
    return _mm(a.reshape(-1, a.shape[-1]).transpose(0, 1),
               b.reshape(-1, b.shape[-1]))


# ---------------------------------------------------------------------------
# dropout bits: the spec the CUDA kernels (csrc/fused_block_common.cuh) share
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32), without int64
    overflow (the constant is split into 16-bit halves)."""
    lo, hi = c & 0xFFFF, c >> 16
    return ((((a * hi) & 0xFFFF) << 16) + a * lo) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding uint32s."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_bits(seed, stream: torch.Tensor,
                 counter: torch.Tensor) -> torch.Tensor:
    """32 random bits per element, as int64 values in [0, 2^32), all
    arithmetic mod 2^32:

        key  = fmix32(seed + 0x9E3779B9 * stream)
        bits = fmix32(key ^ fmix32(counter))

    ``stream`` = 2 * batch row + site (0: the gate g, 1: the FFN activation
    f), ``counter`` = token * width + column; the arguments broadcast."""
    key = _fmix32((seed + _mul32(stream, 0x9E3779B9)) & _M32)
    return _fmix32(key ^ _fmix32(counter))


def drop_threshold(rate: float) -> int:
    """An element is kept iff its bits are >= uint32(rate * 2^32)."""
    return min(int(rate * 2.0 ** 32), _M32)


def keep_scale(rate: float) -> float:
    """1 / (1 - rate), rounded to f32 as the kernels take it."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def keep_mask(B: int, L: int, W: int, seed, site: int, rate: float,
              device) -> torch.Tensor:
    """[B, L, W] f32 keep mask of one dropout site: 1/(1-rate) where kept,
    else 0. ``seed`` is an int or a tensor holding one."""
    seed = torch.as_tensor(seed, device=device).to(torch.int64).reshape(())
    stream = (2 * torch.arange(B, device=device, dtype=torch.int64)
              + site)[:, None, None]
    counter = torch.arange(L * W, device=device,
                           dtype=torch.int64).reshape(1, L, W)
    keep = dropout_bits(seed, stream, counter) >= drop_threshold(rate)
    return keep.to(torch.float32) * keep_scale(rate)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _heads(t, H):
    B, L, D = t.shape
    return t.reshape(B, L, H, D // H).transpose(1, 2)


def _rows(t):
    B, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(B, L, H * hd)


def _projection(h1c, o, L, hd, cdt):
    """pre-activation, u (f32) and the rounded v/L, q*hd^-1/2, k."""
    D = h1c.shape[-1]
    pre = _mm(h1c, o["wuvqk"]) + o["buvqk"]
    uvqk = Fn.silu(pre)
    v = (uvqk[..., D:2 * D] * (1.0 / L)).to(cdt)
    q = (uvqk[..., 2 * D:3 * D] * (hd ** -0.5)).to(cdt)
    k = uvqk[..., 3 * D:].to(cdt)
    return pre, uvqk[..., :D], v, q, k


def _scores(q, k, rab, token_type, H, off=0):
    """s = q k^T + rab[h, min(dist, NB-1)] [B, H, Lq, Lk] in f32 (q is
    pre-scaled) and the causal ∧ key-valid mask; a query at row r and a key
    at column c lie at distance r + off - c (``off`` 0 on one sequence; the
    query shard's start minus the key shard's on a ring)."""
    Lq, Lk = q.shape[1], k.shape[1]
    dist = (torch.arange(Lq, device=q.device)[:, None] + off) \
        - torch.arange(Lk, device=q.device)[None, :]
    bucket = dist.clamp(0, rab.shape[1] - 1)
    mask = (dist >= 0)[None, None] & (token_type != 0)[:, None, None, :]
    s = _mm(_heads(q, H), _heads(k, H).transpose(-1, -2)) \
        + rab[:, bucket][None]
    return s, mask


def _rab_grad(ds, NB, off=0):
    """[H, NB] gradient of rab from ds [H, Lq, Lk] (batch-summed, zero off
    the causal valid pairs; pairs at distance r + off - c): distance d < NB
    - 1 is one diagonal, the clamped bucket NB - 1 the triangle below. Each
    is a torch sum, which is pairwise; scattering every pair into its
    bucket (index_add_) would add up to L^2 / 2 terms in one run and, at L
    = 16384, lose f32 precision the kernel keeps."""
    H, Lq, Lk = ds.shape
    drab = ds.new_zeros((H, NB))
    for d in range(NB - 1):
        if -Lq < off - d < Lk:
            drab[:, d] = torch.diagonal(ds, offset=off - d, dim1=-2,
                                        dim2=-1).sum(-1)
    drab[:, NB - 1] = torch.tril(ds, diagonal=off - (NB - 1)).sum((-2, -1))
    return drab


def _post_plain(xf, av, u, o, seed, rate, cdt):
    """The block after attention on f32 x, av and u: the gate, the
    out-projection, the residual, LN3, SwiGLU and the second residual."""
    B, L, D = xf.shape
    ln = o["ln"]
    F = o["w2"].shape[0]
    g = _ln(av, ln[2], ln[3]) * u
    if rate > 0.0:
        g = g * keep_mask(B, L, D, seed, 0, rate, xf.device)
    y = xf + _mm(g.to(cdt), o["wo"]) + o["bo"]
    x13 = _mm(_ln(y, ln[4], ln[5]).to(cdt), o["w13"])
    f = Fn.silu(x13[..., :F]) * x13[..., F:]
    if rate > 0.0:
        f = f * keep_mask(B, L, F, seed, 1, rate, xf.device)
    return (y + _mm(f.to(cdt), o["w2"])).to(cdt)


def _forward_plain(x, o, token_type, num_heads, seed, rate):
    cdt = x.dtype
    B, L, D = x.shape
    ln = o["ln"]
    xf = x.float()
    _, u, v, q, k = _projection(_ln(xf, ln[0], ln[1]).to(cdt), o, L,
                                D // num_heads, cdt)
    s, mask = _scores(q, k, o["rab"], token_type, num_heads)
    a = (Fn.silu(s) * mask).to(cdt)
    av = _rows(_mm(a, _heads(v, num_heads)))
    if chunked(L, D):
        av = av.to(cdt).float()   # the chunked variant's LN2 reads T(av)
    return _post_plain(xf, av, u, o, seed, rate, cdt), av.to(cdt)


def fused_hstu_block_plain(x: torch.Tensor, o: Mapping,
                           token_type: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the inference kernel, with its rounding
    points, on the same operands (:func:`block_operands` of one block)."""
    return _forward_plain(x, o, token_type, num_heads, 0, 0.0)[0]


def fused_hstu_block_train_plain(x: torch.Tensor, o: Mapping,
                                 token_type: torch.Tensor, num_heads: int,
                                 seed, rate: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's training mode: (out, av), with the two
    dropouts at ``rate`` (none at 0) and av in the activation dtype, the
    residual the backward reads (in the chunked variant, the value LN2
    read)."""
    return _forward_plain(x, o, token_type, num_heads, seed, rate)


def fused_hstu_block_bwd_plain(x: torch.Tensor, av: torch.Tensor,
                               dout: torch.Tensor, o: Mapping,
                               token_type: torch.Tensor, num_heads: int,
                               seed, rate: float) -> dict:
    """Plain version of the backward kernel, written out op by op with its
    rounding points (not autograd of the forward). Returns {"dx" (the
    activation dtype), and in f32 "ln" [6, D], "wuvqk", "buvqk", "wo",
    "bo", "w13", "w2", "rab" [H, NB]}."""
    cdt = x.dtype
    _, L, D = x.shape
    H = num_heads
    hd = D // H
    xf = x.float()
    pre, h1c, xhat1, rstd1, (u, v, q, k) = _recompute_projection(xf, o, L, hd,
                                                                 cdt)
    post = _post_bwd(xf, av, dout, o, u, seed, rate, cdt)

    # ---- attention: the ring's pair of shards at off 0 ----
    dq, drab, dk, dv = ring_pair_bwd_plain(q, k, v, post["dav"], token_type,
                                           o["rab"], 0, H)
    pre_g = _pre_bwd(o, pre, h1c, xhat1, rstd1, post["du"], dv,
                     dq * (hd ** -0.5), dk, post["dy"], L, cdt)
    return {"dx": pre_g["dx"], "ln": pre_g["ln"] + post["ln"],
            "wuvqk": pre_g["wuvqk"], "buvqk": pre_g["buvqk"],
            "wo": post["wo"], "bo": post["bo"], "w13": post["w13"],
            "w2": post["w2"], "rab": drab}


def _recompute_projection(xf, o, L, hd, cdt):
    """The backward's recompute of LN1 and the projection: (pre-activation,
    T(LN1(x)), its xhat and rstd, (u, v, q, k) as :func:`_projection`
    gives them)."""
    ln = o["ln"]
    xhat1, rstd1 = _ln_stats(xf)
    h1c = (xhat1 * ln[0] + ln[1]).to(cdt)
    pre, u, v, q, k = _projection(h1c, o, L, hd, cdt)
    return pre, h1c, xhat1, rstd1, (u, v, q, k)


def _post_bwd(xf, av, dout, o, u, seed, rate, cdt):
    """Backward of :func:`_post_plain` from the rounded av, op by op with
    the kernel's rounding points: {"dav" (T), "du", "dy" (f32, the residual
    path's dx), "ln" [6, D] (rows 2-5), "wo", "bo", "w13", "w2"}."""
    B, L, D = xf.shape
    ln = o["ln"]
    F = o["w2"].shape[0]
    xhat2, rstd2 = _ln_stats(av.float())
    av_ln = xhat2 * ln[2] + ln[3]
    keep1 = keep2 = None
    g = av_ln * u
    if rate > 0.0:
        keep1 = keep_mask(B, L, D, seed, 0, rate, xf.device)
        g = g * keep1
    gc = g.to(cdt)
    y = xf + _mm(gc, o["wo"]) + o["bo"]
    xhat3, rstd3 = _ln_stats(y)
    h2c = (xhat3 * ln[4] + ln[5]).to(cdt)
    x13 = _mm(h2c, o["w13"])
    x1, x3 = x13[..., :F], x13[..., F:]
    sx1 = Fn.silu(x1)
    f = sx1 * x3
    if rate > 0.0:
        keep2 = keep_mask(B, L, F, seed, 1, rate, xf.device)
        f = f * keep2

    doutc = dout.to(cdt)
    dw2 = _wsum(f.to(cdt), doutc)
    df = _mm(doutc, o["w2"].transpose(0, 1))
    if keep2 is not None:
        df = df * keep2
    dx13c = torch.cat([df * x3 * _dsilu(x1), df * sx1], -1).to(cdt)
    dw13 = _wsum(h2c, dx13c)
    dy_ln, dg3, db3 = _ln_bwd(_mm(dx13c, o["w13"].transpose(0, 1)), xhat3,
                              rstd3, ln[4])
    dy = dout.float() + dy_ln
    dyc = dy.to(cdt)
    dg = _mm(dyc, o["wo"].transpose(0, 1))
    if keep1 is not None:
        dg = dg * keep1
    dav, dg2, db2 = _ln_bwd(dg * u, xhat2, rstd2, ln[2])
    zero = torch.zeros_like(dg2)
    return {"dav": dav.to(cdt), "du": dg * av_ln, "dy": dy,
            "ln": torch.stack([zero, zero, dg2, db2, dg3, db3]),
            "wo": _wsum(gc, dyc), "bo": dy.reshape(-1, D).sum(0),
            "w13": dw13, "w2": dw2}


def _pre_bwd(o, pre, h1c, xhat1, rstd1, du, dv, dq, dk, dy, L, cdt):
    """Backward of LN1 and the projection from the f32 gradients of u, the
    1/L-scaled v, the silu output of q (dq already times hd^-1/2) and k,
    plus the residual ``dy``: {"dx" (T), "ln" [6, D] (rows 0-1), "wuvqk",
    "buvqk"}."""
    D = h1c.shape[-1]
    duvqk = torch.cat([du, dv * (1.0 / L), dq, dk], -1) * _dsilu(pre)
    duvqkc = duvqk.to(cdt)
    dx_ln, dg1, db1 = _ln_bwd(_mm(duvqkc, o["wuvqk"].transpose(0, 1)),
                              xhat1, rstd1, o["ln"][0])
    zero = torch.zeros_like(dg1)
    return {"dx": (dy + dx_ln).to(cdt),
            "ln": torch.stack([dg1, db1, zero, zero, zero, zero]),
            "wuvqk": _wsum(h1c, duvqkc),
            "buvqk": duvqk.reshape(-1, 4 * D).sum(0)}


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint

_WEIGHTS = ("wuvqk", "wo", "w13", "w2")


def _check(x: torch.Tensor, o: Mapping, token_type: torch.Tensor,
           num_heads: int, name: str, *extra: torch.Tensor):
    """Validate what the kernels take; returns (x contiguous, int32 valid
    mask, or None without a ``token_type``)."""
    B, L, D = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes bf16 or f32, not {x.dtype}")
    if L % 64 or D % 16 or D % num_heads:
        raise ValueError(f"{name} needs L % 64 == 0, D % 16 == 0 and "
                         f"D % num_heads == 0 (L={L}, D={D}, H={num_heads})")
    if token_type is not None and tuple(token_type.shape) != (B, L):
        raise ValueError(f"{name}: token_type has shape "
                         f"{tuple(token_type.shape)}, expected {(B, L)}")
    F = o["w2"].shape[0]
    H = o["rab"].shape[0]
    if F % 16 or H != num_heads or o["wuvqk"].shape != (D, 4 * D):
        raise ValueError(f"{name}: F={F} must be a multiple of 16 and rab "
                         f"must have {num_heads} heads (got {H})")
    for key, t in o.items():
        want = x.dtype if key in _WEIGHTS else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name}: {key} is {t.dtype}, not {want} "
                             f"(build the operands with "
                             f"block_operands(bp, x.dtype))")
    x = x.contiguous()
    # the kernels read token_type themselves: nonzero = valid key
    valid = None if token_type is None else \
        token_type.to(torch.int32).contiguous()
    for t in (x, *([valid] if valid is not None else []), *o.values(),
              *extra):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    return x, valid


def _seed_tensor(seed, device) -> torch.Tensor:
    """The dropout seed as a [1] int32 tensor on ``device`` (a tensor seed
    stays on the card: no host round trip)."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int32).reshape(1) \
            .contiguous()
    return torch.tensor([seed], dtype=torch.int32, device=device)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _fwd_fn():
    fn = kernels.load("fused_block").fused_block_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [_I] + [_P] * 17 + [_I] * 7 + [_F, _F, _U, _F, _P]
    return fn


def _launch_fwd(x, o, token_type, num_heads, train: bool, seed, rate):
    B, L, D = x.shape
    x, valid = _check(x, o, token_type, num_heads, "fused block kernel")
    q = torch.empty_like(x)
    k = torch.empty_like(x)
    v = torch.empty_like(x)
    u = torch.empty((B, L, D), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    av = torch.empty_like(x) if train else None
    drop = train and rate > 0.0
    seed_t = _seed_tensor(seed, x.device) if drop else None
    fn = _fwd_fn()
    with torch.cuda.device(x.device):
        rc = fn(int(x.dtype == torch.bfloat16), x.data_ptr(),
                valid.data_ptr(), o["ln"].data_ptr(), o["wuvqk"].data_ptr(),
                o["buvqk"].data_ptr(), o["wo"].data_ptr(), o["bo"].data_ptr(),
                o["w13"].data_ptr(), o["w2"].data_ptr(), o["rab"].data_ptr(),
                q.data_ptr(), k.data_ptr(), v.data_ptr(), u.data_ptr(),
                out.data_ptr(), av.data_ptr() if train else None,
                seed_t.data_ptr() if drop else None, B, L, D, num_heads,
                o["w2"].shape[0], o["rab"].shape[1], int(chunked(L, D)),
                float(D // num_heads) ** -0.5, 1.0 / L,
                drop_threshold(rate) if drop else 0,
                keep_scale(rate) if drop else 1.0, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"fused_block_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    return out, av


def fused_hstu_block(x: torch.Tensor, ops: Mapping, token_type: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """One full HSTU block on [B, L, D] activations (bf16 or f32), inference
    forward. ``ops`` is ``block_operands(bp, x.dtype)`` of one block, built
    once by the caller; ``token_type`` [B, L] (0 = padding key). CPU
    tensors take the plain version; CUDA tensors launch the kernel (counted
    in ``fused_hstu_block.launches``)."""
    if x.device.type == "cpu":
        return fused_hstu_block_plain(x, ops, token_type, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_hstu_block: no kernel for {x.device}")
    out, _ = _launch_fwd(x, ops, token_type, num_heads, False, 0, 0.0)
    fused_hstu_block.launches += 1
    return out


fused_hstu_block.launches = 0


def fused_hstu_block_train(x: torch.Tensor, ops: Mapping,
                           token_type: torch.Tensor, num_heads: int, seed,
                           rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's training forward: (out, av), with dropout at ``rate``
    from ``seed`` (an int, or a tensor holding one; no dropout at rate 0).
    CPU tensors take the plain version; CUDA tensors launch the kernel's
    training instance (counted in ``fused_hstu_block_train.launches``)."""
    if x.device.type == "cpu":
        return fused_hstu_block_train_plain(x, ops, token_type, num_heads,
                                            seed, rate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_hstu_block_train: no kernel for {x.device}")
    out = _launch_fwd(x, ops, token_type, num_heads, True, seed, rate)
    fused_hstu_block_train.launches += 1
    return out


fused_hstu_block_train.launches = 0


class _BwdArgs(ctypes.Structure):
    """Mirror of ``BwdArgs`` in csrc/fused_block_bwd.cu, field for field."""

    _fields_ = ([(n, _P) for n in (
        "x", "valid", "ln", "wuvqk", "buvqk", "wo", "bo", "w13", "w2", "rab",
        "av", "dout", "seed", "q", "k", "v", "dav", "du", "dy", "dv", "dq",
        "dk", "part", "part_rab", "dx", "grads", "drab", "fs", "dx13s",
        "h2s", "gs", "dys", "h1s", "duvqks", "psum")]
        + [(n, _I) for n in (
            "B", "L", "D", "H", "F", "NB", "G", "P", "off_w2", "off_w13",
            "off_wo", "off_bo", "off_ln", "off_wuvqk", "off_buvqk", "cot_t")]
        + [("scale", _F), ("inv_len", _F), ("dq_scale", _F), ("thr", _U),
           ("keep_scale", _F)])


#: weight, LN and bias gradients in the order of the backward kernel's
#: partial-sum rows: name -> shape as a function of (D, F)
_BWD_GRADS = (("w2", lambda D, F: (F, D)), ("w13", lambda D, F: (D, 2 * F)),
              ("wo", lambda D, F: (D, D)), ("bo", lambda D, F: (D,)),
              ("ln", lambda D, F: (6, D)),
              ("wuvqk", lambda D, F: (D, 4 * D)),
              ("buvqk", lambda D, F: (4 * D,)))


def bwd_layout(D: int, F: int):
    """({name: (offset, shape)}, row width P) of the backward kernel's
    partial sums; every segment starts on a 64-float (256-byte) boundary,
    which keeps the kernel's tensor-core tiles aligned."""
    layout, off = {}, 0
    for name, shape_of in _BWD_GRADS:
        shape = shape_of(D, F)
        layout[name] = (off, shape)
        off += -(-int(np.prod(shape)) // 64) * 64
    return layout, off


def block_wgmma(dtype: torch.dtype, D: int) -> bool:
    """Whether the block's backward takes its wgmma instances
    (``gate_ffn_bwd_wgmma_kernel`` and ``proj_bwd_wgmma_kernel``, their
    weight products by ``wgrad_wgmma_kernel``): bf16 at D <= 128, every
    fused preset; f32 (the tight check instance) and wider models take
    ``gate_ffn_bwd_kernel`` and ``proj_bwd_kernel``. This is the one place
    of the rule: the wrappers pass the wgmma instances' scratch
    (:func:`_wgmma_scratch`) exactly then, and the CUDA source takes each
    instance exactly when its scratch is there (a launch it cannot make
    fails). The forward's kernels are chosen in ``csrc/fused_block.cu``
    alone, by the same rule (``proj_wgmma_kernel``, and
    ``attn_ffn_wgmma_kernel`` with heads of 8k columns, which the fused
    gate asks for)."""
    return dtype == torch.bfloat16 and D <= 128


def _wgmma_scratch(x: torch.Tensor, F: int, gate: bool = True,
                   proj: bool = True) -> dict:
    """The scratch of the backward's wgmma instances on x's tokens: the
    bf16 operands of their weight products over tokens, the gate/FFN's
    T(f) [.., F], T(dx13) [.., 2F], T(h2), T(g) and T(dy) [.., D], the
    projection's T(h1) [.., D] and T(duvqk) [.., 4D]; and the projection's
    per-tile column sums ``psum`` (f32, [B L / 64, 6D]). Empty where the
    kernels take the other instances."""
    B, L, D = x.shape
    if not block_wgmma(x.dtype, D):
        return {}
    widths = ((("fs", F), ("dx13s", 2 * F), ("h2s", D), ("gs", D),
               ("dys", D)) if gate else ()) + \
        ((("h1s", D), ("duvqks", 4 * D)) if proj else ())
    out = {n: torch.empty((B, L, w), dtype=x.dtype, device=x.device)
           for n, w in widths}
    if proj:
        out["psum"] = torch.empty(B * L // 64 * 6 * D, dtype=torch.float32,
                                  device=x.device)
    return out


def _bwd_fn():
    fn = kernels.load("fused_block_bwd").fused_block_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [_I, ctypes.POINTER(_BwdArgs), _P]
    return fn


def _launch_bwd(x, av, dout, o, token_type, num_heads, seed, rate):
    B, L, D = x.shape
    x, valid = _check(x, o, token_type, num_heads, "fused block backward",
                      av, dout)
    if av.shape != x.shape or dout.shape != x.shape or \
            av.dtype != x.dtype or dout.dtype != x.dtype:
        raise ValueError("fused block backward: av and dout must match x in "
                         "shape and dtype")
    F = o["w2"].shape[0]
    H, NB = o["rab"].shape
    dev = x.device
    f32 = torch.float32
    layout, P = bwd_layout(D, F)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = min(B * L // 64, 2 * sms)
    drop = rate > 0.0
    scratch = {n: torch.empty_like(x) for n in ("q", "k", "v", "dav")}
    scratch.update({n: torch.empty((B, L, D), dtype=f32, device=dev)
                    for n in ("du", "dy", "dv", "dq", "dk")})
    part = torch.zeros((G, P), dtype=f32, device=dev)
    part_rab = torch.empty((B * L // 16, H * NB), dtype=f32, device=dev)
    dx = torch.empty_like(x)
    grads = torch.empty(P, dtype=f32, device=dev)
    drab = torch.empty((H, NB), dtype=f32, device=dev)
    seed_t = _seed_tensor(seed, dev) if drop else None
    ptrs = dict(x=x, valid=valid, av=av, dout=dout, part=part,
                part_rab=part_rab, dx=dx, grads=grads, drab=drab, **scratch,
                **_wgmma_scratch(x, F),
                **{n: o[n] for n in ("ln", "wuvqk", "buvqk", "wo", "bo",
                                     "w13", "w2", "rab")})
    args = _BwdArgs(
        **{n: t.data_ptr() for n, t in ptrs.items()},
        seed=seed_t.data_ptr() if drop else None,
        B=B, L=L, D=D, H=H, F=F, NB=NB, G=G, P=P,
        **{f"off_{n}": off for n, (off, _) in layout.items()},
        cot_t=0, scale=float(D // num_heads) ** -0.5, inv_len=1.0 / L,
        dq_scale=1.0, thr=drop_threshold(rate) if drop else 0,
        keep_scale=keep_scale(rate) if drop else 1.0)
    fn = _bwd_fn()
    with torch.cuda.device(dev):
        rc = fn(int(x.dtype == torch.bfloat16), ctypes.byref(args),
                _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fused_block_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    out = {name: grads[off:off + int(np.prod(shape))].view(shape)
           for name, (off, shape) in layout.items()}
    out.update(dx=dx, rab=drab)
    return out


def fused_hstu_block_bwd(x: torch.Tensor, av: torch.Tensor,
                         dout: torch.Tensor, ops: Mapping,
                         token_type: torch.Tensor, num_heads: int, seed,
                         rate: float) -> dict:
    """The block's backward from the forward's x and av and the output
    cotangent: {"dx", "ln", "wuvqk", "buvqk", "wo", "bo", "w13", "w2",
    "rab"} (see :func:`fused_hstu_block_bwd_plain`). ``seed`` and ``rate``
    are the training forward's, so the dropout masks agree. CPU tensors
    take the plain version; CUDA tensors launch the kernel (counted in
    ``fused_hstu_block_bwd.launches``)."""
    if x.device.type == "cpu":
        return fused_hstu_block_bwd_plain(x, av, dout, ops, token_type,
                                          num_heads, seed, rate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_hstu_block_bwd: no kernel for {x.device}")
    out = _launch_bwd(x, av, dout, ops, token_type, num_heads, seed, rate)
    fused_hstu_block_bwd.launches += 1
    return out


fused_hstu_block_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

#: the block parameter leaves FusedBlockFn takes, in order
BLOCK_LEAVES = (("attn_ln", "scale"), ("attn_ln", "bias"),
                ("hstu", "attn_ln", "scale"), ("hstu", "attn_ln", "bias"),
                ("ffn_ln", "scale"), ("ffn_ln", "bias"),
                ("hstu", "uvqk", "w"), ("hstu", "uvqk", "b"),
                ("hstu", "out", "w"), ("hstu", "out", "b"),
                ("ffn", "w13"), ("ffn", "w2"), ("hstu", "rab"))


def leaves_of(bp: Mapping, paths) -> list:
    """The leaves of a block parameter subtree at ``paths``."""
    out = []
    for path in paths:
        node = bp
        for key in path:
            node = node[key]
        out.append(node)
    return out


def _nest(leaves):
    tree: dict = {}
    for path, t in zip(BLOCK_LEAVES, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


class FusedBlockFn(torch.autograd.Function):
    """One fused HSTU block with its hand-written backward.

    ``apply(x, token_type, seed, rate, train, num_heads, *leaves)``: ``x``
    [B, L, D] in the compute dtype; ``leaves`` the block's parameter leaves
    in :data:`BLOCK_LEAVES` order (f32). The kernel operands (weight casts,
    the LN stack) are built inside, so the gradients returned to the leaves
    are the backward's f32 sums, unrounded. Dropout runs iff ``train`` and
    ``rate`` > 0; the forward always produces the av residual."""

    @staticmethod
    def forward(ctx, x, token_type, seed, rate, train, num_heads, *leaves):
        rate = float(rate) if train else 0.0
        with torch.no_grad():
            ops = block_operands(_nest(leaves), x.dtype)
            out, av = fused_hstu_block_train(x, ops, token_type, num_heads,
                                             seed, rate)
        ctx.save_for_backward(x, av, token_type,
                              seed if isinstance(seed, torch.Tensor)
                              else torch.tensor(seed), *ops.values())
        ctx.keys = tuple(ops)
        ctx.rate, ctx.num_heads = rate, num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        x, av, token_type, seed, *opv = ctx.saved_tensors
        ops = dict(zip(ctx.keys, opv))
        g = fused_hstu_block_bwd(x, av, dout.contiguous(), ops, token_type,
                                 ctx.num_heads, seed, ctx.rate)
        grads = list(g["ln"]) + [g["wuvqk"], g["buvqk"], g["wo"], g["bo"],
                                 g["w13"], g["w2"], g["rab"]]
        return (g["dx"], None, None, None, None, None, *grads)


def fused_hstu_block_autograd(x: torch.Tensor, bp: Mapping,
                              token_type: torch.Tensor, seed,
                              num_heads: int, rate: float = 0.0,
                              train: bool = False) -> torch.Tensor:
    """:class:`FusedBlockFn` on a block parameter subtree (the encoder's
    per-block slice of the stacked tree)."""
    return FusedBlockFn.apply(x, token_type, seed, rate, train, num_heads,
                              *leaves_of(bp, BLOCK_LEAVES))


# ---------------------------------------------------------------------------
# the ring units: one block on one shard of a sequence-sharded ring
# ---------------------------------------------------------------------------
#
# Counterparts of the JAX package's ring_pre_proj, ring_pair_attn and
# ring_post_gate (l.1401-1659), which parallel/ring_fused.py composes on a
# ``seq`` mesh: the pre stage (LN1, projection, silu) on the local shard, S
# ring steps in which one pair kernel computes the local queries against the
# key shard in hand at its global offset, then the post stage (gate,
# out-projection, residual, LN3, SwiGLU, residual). Their rounding points
# are the ring's: the S f32 partials sum in ring order and round to T once;
# each pair's dq, dk, dv round to T; the post stage returns dav and dx in T,
# the pre stage dx in T, and x's gradient is the sum of the two in T.
#
# Kernels, each replacing a TPU kernel of the JAX file:
#   ring_pre_fwd   proj_wgmma_kernel alone (csrc/fused_block.cu; bf16 at
#                  D <= 128, else proj_kernel), l.452
#   ring_post_fwd  attn_ffn_wgmma_kernel's post half on a given T(av) (bf16
#                  at D <= 128; else attn_ffn_kernel's), l.502
#   ring_pair_fwd  pair_fwd_wgmma_kernel (csrc/ring_pair.cu: the attention
#                  loop of attn_ffn_wgmma_kernel at the pair's offset; bf16
#                  with heads of 8k columns up to 128, else pair_fwd_kernel),
#                  l.1269
#   ring_pair_dq   attn_bwd_dq_wgmma_kernel (csrc/hstu_attn_bwd_sm90.cuh;
#                  bf16 at hd <= 128, else attn_bwd_dq_kernel) +
#                  reduce_rows_kernel, l.1304
#   ring_pair_dkdv attn_bwd_dkdv_wgmma_kernel (else attn_bwd_dkdv_kernel),
#                  l.1345 (the single device's fused backward launches both
#                  at off 0)
#   ring_post_bwd  gate_ffn_bwd_wgmma_kernel + wgrad_wgmma_kernel (bf16 at
#                  D <= 128; else gate_ffn_bwd_kernel) alone
#                  (csrc/fused_block_bwd.cu), l.612
#   ring_pre_bwd   proj_bwd_wgmma_kernel + wgrad_wgmma_kernel (bf16 at D
#                  <= 128; else proj_bwd_kernel) alone, no residual, l.710

def ring_pre_fwd_plain(x: torch.Tensor, o: Mapping, seq_len: int,
                       num_heads: int):
    """Plain version of the pre stage on a shard x [B, Lc, D]: (q, k, v in
    the activation dtype, u in f32); q scaled by hd^-1/2, v by 1/seq_len,
    the whole sequence's length."""
    cdt = x.dtype
    _, u, v, q, k = _projection(_ln(x.float(), o["ln"][0], o["ln"][1])
                                .to(cdt), o, seq_len,
                                x.shape[-1] // num_heads, cdt)
    return q, k, v, u.contiguous()


def ring_pre_bwd_plain(x, o, dq, dk, dv, du, seq_len: int,
                       num_heads: int) -> dict:
    """Plain version of the pre stage's backward from the gradients of its
    outputs (dq w.r.t. the scaled q: times hd^-1/2 here; dv w.r.t. the
    scaled v). The residual slot is zero: the post stage owns the residual
    path. Returns {"dx" (T), "ln" [6, D] (rows 0-1), "wuvqk", "buvqk"}."""
    cdt = x.dtype
    hd = x.shape[-1] // num_heads
    xf = x.float()
    pre, h1c, xhat1, rstd1, _ = _recompute_projection(xf, o, seq_len, hd,
                                                      cdt)
    return _pre_bwd(o, pre, h1c, xhat1, rstd1, du.float(), dv.float(),
                    dq.float() * (hd ** -0.5), dk.float(),
                    torch.zeros_like(xf), seq_len, cdt)


def ring_post_fwd_plain(x, av, u, o: Mapping, seed, rate: float):
    """Plain version of the post stage on a shard: x and av [B, Lc, D] in
    the activation dtype, u in f32; dropout at ``rate`` from ``seed``."""
    return _post_plain(x.float(), av.float(), u, o, seed, rate, x.dtype)


def ring_post_bwd_plain(x, av, dout, o, seed, rate: float, seq_len: int,
                        num_heads: int) -> dict:
    """Plain version of the post stage's backward (u recomputed from x, as
    the kernel does): {"dav" (T), "du", "dy" (f32), "ln" [6, D] (rows 2-5),
    "wo", "bo", "w13", "w2"}."""
    cdt = x.dtype
    xf = x.float()
    *_, (u, _, _, _) = _recompute_projection(
        xf, o, seq_len, x.shape[-1] // num_heads, cdt)
    return _post_bwd(xf, av, dout, o, u, seed, rate, cdt)


def ring_pair_fwd_plain(q, k, v, valid, rab, off: int, num_heads: int):
    """Plain version of the pair forward: the f32 partial [B, Lq, D] of the
    queries q [B, Lq, D] against the keys k, v [B, Lk, D] (``valid`` [B,
    Lk], nonzero = valid key) at distance r + off - c."""
    s, mask = _scores(q, k, rab, valid, num_heads, off)
    a = (Fn.silu(s) * mask).to(q.dtype)
    return _rows(_mm(a, _heads(v, num_heads)))


def _pair_ds(q, k, v, dav, valid, rab, off, H):
    s, mask = _scores(q, k, rab, valid, H, off)
    dot_b = _heads(dav.to(q.dtype), H)
    ds = _mm(dot_b, _heads(v, H).transpose(-1, -2)) * _dsilu(s) * mask
    return s, mask, dot_b, ds


def _pair_dq(k, ds, rab, off, H):
    return (_rows(_mm(ds.to(k.dtype), _heads(k, H))),
            _rab_grad(ds.sum(0), rab.shape[1], off))


def _pair_dkdv(q, s, mask, dot_b, ds, H):
    a = (Fn.silu(s) * mask).to(q.dtype)
    dk = _mm(ds.to(q.dtype).transpose(-1, -2), _heads(q, H))
    return _rows(dk), _rows(_mm(a.transpose(-1, -2), dot_b))


def ring_pair_dq_plain(q, k, v, dav, valid, rab, off: int, num_heads: int):
    """Plain version of the pair's dq kernel: (dq w.r.t. the scaled q,
    drab [H, NB]), both f32."""
    _, _, _, ds = _pair_ds(q, k, v, dav, valid, rab, off, num_heads)
    return _pair_dq(k, ds, rab, off, num_heads)


def ring_pair_dkdv_plain(q, k, v, dav, valid, rab, off: int,
                         num_heads: int):
    """Plain version of the pair's dk/dv kernel: (dk, dv w.r.t. the scaled
    v), both f32."""
    s, mask, dot_b, ds = _pair_ds(q, k, v, dav, valid, rab, off, num_heads)
    return _pair_dkdv(q, s, mask, dot_b, ds, num_heads)


def ring_pair_bwd_plain(q, k, v, dav, valid, rab, off: int, num_heads: int):
    """Both plain pair backwards from one computation of ds: (dq, drab, dk,
    dv) as :func:`ring_pair_dq_plain` and :func:`ring_pair_dkdv_plain` give
    them. The single device's plain backward is this at off 0."""
    s, mask, dot_b, ds = _pair_ds(q, k, v, dav, valid, rab, off, num_heads)
    return (*_pair_dq(k, ds, rab, off, num_heads),
            *_pair_dkdv(q, s, mask, dot_b, ds, num_heads))


class _PairArgs(ctypes.Structure):
    """Mirror of ``PairArgs`` in csrc/ring_pair.cu, field for field."""

    _fields_ = ([(n, _P) for n in (
        "q", "k", "v", "valid", "rab", "dav", "av", "dq", "dk", "dv",
        "part_rab", "drab")]
        + [(n, _I) for n in ("B", "Lq", "Lk", "D", "H", "NB", "off")])


def _future(off: int, Lq: int) -> bool:
    """Whether every pair lies in the future (the key shard after the
    query shard): the partial and its gradients are 0, and no kernel
    launches."""
    return off + Lq <= 0


def _pair_launch(which, q, k, v, valid, rab, off, num_heads, dav=None):
    B, Lq, D = q.shape
    Lk = k.shape[1]
    name = f"ring pair kernel ({which})"
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes bf16 or f32, not {q.dtype}")
    if k.shape != (B, Lk, D) or v.shape != k.shape or \
            k.dtype != q.dtype or v.dtype != q.dtype or \
            (dav is not None and (dav.shape != q.shape
                                  or dav.dtype != q.dtype)):
        raise ValueError(f"{name}: k and v must be [B, Lk, D] and dav like "
                         "q, all in q's dtype")
    if Lq % 16 or Lk % 16 or D % 16 or D % num_heads:
        raise ValueError(f"{name} needs Lq, Lk and D multiples of 16 and D "
                         f"% num_heads == 0 (Lq={Lq}, Lk={Lk}, D={D}, "
                         f"H={num_heads})")
    if tuple(valid.shape) != (B, Lk) or rab.dtype != torch.float32 or \
            rab.dim() != 2 or rab.shape[0] != num_heads:
        raise ValueError(f"{name}: valid must be [B, Lk] and rab f32 [H, "
                         "NB] with num_heads rows")
    valid = valid.to(torch.int32).contiguous()
    H, NB = rab.shape
    dev, f32 = q.device, torch.float32
    outs = {}
    if which == "fwd":
        outs["av"] = torch.empty((B, Lq, D), dtype=f32, device=dev)
    elif which == "dq":
        outs["dq"] = torch.empty((B, Lq, D), dtype=f32, device=dev)
        outs["part_rab"] = torch.empty((B * Lq // 16, H * NB), dtype=f32,
                                       device=dev)
        outs["drab"] = torch.empty((H, NB), dtype=f32, device=dev)
    else:
        outs["dk"] = torch.empty((B, Lk, D), dtype=f32, device=dev)
        outs["dv"] = torch.empty((B, Lk, D), dtype=f32, device=dev)
    ins = dict(q=q, k=k, v=v, valid=valid, rab=rab,
               **({} if dav is None else {"dav": dav}))
    for t in ins.values():
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    args = _PairArgs(**{n: t.data_ptr() for n, t in {**ins, **outs}.items()},
                     B=B, Lq=Lq, Lk=Lk, D=D, H=H, NB=NB, off=int(off))
    fn = getattr(kernels.load("ring_pair"), f"ring_pair_{which}")
    fn.restype = ctypes.c_int
    fn.argtypes = [_I, ctypes.POINTER(_PairArgs), _P]
    with torch.cuda.device(dev):
        rc = fn(int(q.dtype == torch.bfloat16), ctypes.byref(args),
                _stream(dev))
    if rc != 0:
        raise RuntimeError(f"ring_pair_{which} kernel launch failed: CUDA "
                           f"error {rc}")
    return outs


def _on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain version);
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    return True


def ring_pair_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor, rab: torch.Tensor, off: int,
                  num_heads: int) -> torch.Tensor:
    """The f32 partial of one (query shard, key shard) pair (see
    :func:`ring_pair_fwd_plain`). A pair wholly in the future is 0 without
    a launch; CPU tensors take the plain version; CUDA tensors launch the
    kernel (counted in ``ring_pair_fwd.launches``)."""
    if _future(off, q.shape[1]):
        return q.new_zeros(q.shape, dtype=torch.float32)
    if not _on_card(q, "ring_pair_fwd"):
        return ring_pair_fwd_plain(q, k, v, valid, rab, off, num_heads)
    out = _pair_launch("fwd", q, k, v, valid, rab, off, num_heads)["av"]
    ring_pair_fwd.launches += 1
    return out


ring_pair_fwd.launches = 0


def ring_pair_dq(q, k, v, dav, valid, rab, off: int, num_heads: int):
    """(dq w.r.t. the scaled q, drab) of one pair, both f32, from the
    partial's cotangent ``dav`` (in q's dtype). Launches counted in
    ``ring_pair_dq.launches``; the future and CPU cases as
    :func:`ring_pair_fwd`'s."""
    if _future(off, q.shape[1]):
        return (q.new_zeros(q.shape, dtype=torch.float32),
                rab.new_zeros(rab.shape))
    if not _on_card(q, "ring_pair_dq"):
        return ring_pair_dq_plain(q, k, v, dav, valid, rab, off, num_heads)
    out = _pair_launch("dq", q, k, v, valid, rab, off, num_heads, dav)
    ring_pair_dq.launches += 1
    return out["dq"], out["drab"]


ring_pair_dq.launches = 0


def ring_pair_dkdv(q, k, v, dav, valid, rab, off: int, num_heads: int):
    """(dk, dv w.r.t. the scaled v) of one pair's key shard, both f32.
    Launches counted in ``ring_pair_dkdv.launches``; the future and CPU
    cases as :func:`ring_pair_fwd`'s."""
    if _future(off, q.shape[1]):
        return (k.new_zeros(k.shape, dtype=torch.float32),
                k.new_zeros(k.shape, dtype=torch.float32))
    if not _on_card(q, "ring_pair_dkdv"):
        return ring_pair_dkdv_plain(q, k, v, dav, valid, rab, off, num_heads)
    out = _pair_launch("dkdv", q, k, v, valid, rab, off, num_heads, dav)
    ring_pair_dkdv.launches += 1
    return out["dk"], out["dv"]


ring_pair_dkdv.launches = 0


def _stage_fn():
    fn = kernels.load("fused_block").fused_block_stage
    fn.restype = ctypes.c_int
    fn.argtypes = [_I, _I] + [_P] * 15 + [_I] * 5 + [_F, _F, _U, _F, _P]
    return fn


def ring_pre_fwd(x: torch.Tensor, ops: Mapping, seq_len: int,
                 num_heads: int):
    """The pre stage on a shard (see :func:`ring_pre_fwd_plain`). CPU
    tensors take the plain version; CUDA tensors launch the projection
    alone (``proj_wgmma_kernel`` in bf16 at D <= 128; counted in
    ``ring_pre_fwd.launches``)."""
    if not _on_card(x, "ring_pre_fwd"):
        return ring_pre_fwd_plain(x, ops, seq_len, num_heads)
    B, Lc, D = x.shape
    x, _ = _check(x, ops, None, num_heads, "ring pre stage")
    q, k, v = (torch.empty_like(x) for _ in range(3))
    u = torch.empty((B, Lc, D), dtype=torch.float32, device=x.device)
    P = lambda n: ops[n].data_ptr()   # noqa: E731
    with torch.cuda.device(x.device):
        rc = _stage_fn()(int(x.dtype == torch.bfloat16), 0, x.data_ptr(),
                         P("ln"), P("wuvqk"), P("buvqk"), None, None, None,
                         None, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         u.data_ptr(), None, None, None, B, Lc, D, num_heads,
                         ops["w2"].shape[0], float(D // num_heads) ** -0.5,
                         1.0 / seq_len, 0, 1.0, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"ring pre stage launch failed: CUDA error {rc}")
    ring_pre_fwd.launches += 1
    return q, k, v, u


ring_pre_fwd.launches = 0


def ring_post_fwd(x: torch.Tensor, av: torch.Tensor, u: torch.Tensor,
                  ops: Mapping, seed, rate: float) -> torch.Tensor:
    """The post stage on a shard (see :func:`ring_post_fwd_plain`). CPU
    tensors take the plain version; CUDA tensors launch the forward's
    second kernel's post half alone (``attn_ffn_wgmma_kernel`` in bf16 at
    D <= 128; counted in ``ring_post_fwd.launches``)."""
    if not _on_card(x, "ring_post_fwd"):
        return ring_post_fwd_plain(x, av, u, ops, seed, rate)
    B, Lc, D = x.shape
    x, _ = _check(x, ops, None, ops["rab"].shape[0], "ring post stage",
                  av, u)
    if av.shape != x.shape or av.dtype != x.dtype or u.shape != x.shape or \
            u.dtype != torch.float32:
        raise ValueError("ring post stage: av must match x, u be f32 "
                         "[B, Lc, D]")
    out = torch.empty_like(x)
    drop = rate > 0.0
    seed_t = _seed_tensor(seed, x.device) if drop else None
    P = lambda n: ops[n].data_ptr()   # noqa: E731
    with torch.cuda.device(x.device):
        rc = _stage_fn()(int(x.dtype == torch.bfloat16), 1, x.data_ptr(),
                         P("ln"), None, None, P("wo"), P("bo"), P("w13"),
                         P("w2"), None, None, None, u.data_ptr(),
                         out.data_ptr(), av.data_ptr(),
                         seed_t.data_ptr() if drop else None, B, Lc, D,
                         ops["rab"].shape[0], ops["w2"].shape[0], 1.0, 1.0,
                         drop_threshold(rate) if drop else 0,
                         keep_scale(rate) if drop else 1.0, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"ring post stage launch failed: CUDA error {rc}")
    ring_post_fwd.launches += 1
    return out


ring_post_fwd.launches = 0


def _stage_bwd_fn():
    fn = kernels.load("fused_block_bwd").fused_block_bwd_stage
    fn.restype = ctypes.c_int
    fn.argtypes = [_I, ctypes.POINTER(_BwdArgs), _I, _P]
    return fn


def _launch_bwd_stage(stage, x, ops, num_heads, seq_len, seed, rate, keys,
                      cot_t=0, dq_scale=1.0, **bufs):
    """One backward stage (0: gate/FFN, 1: projection) on a shard; returns
    the gradients named in ``keys`` from its reduced partial sums."""
    B, Lc, D = x.shape
    F = ops["w2"].shape[0]
    H, NB = ops["rab"].shape
    dev = x.device
    layout, P = bwd_layout(D, F)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = min(B * Lc // 64, 2 * sms)
    part = torch.zeros((G, P), dtype=torch.float32, device=dev)
    grads = torch.empty(P, dtype=torch.float32, device=dev)
    drop = rate > 0.0
    seed_t = _seed_tensor(seed, dev) if drop else None
    ptrs = dict(x=x, part=part, grads=grads, **bufs,
                **_wgmma_scratch(x, F, gate=stage == 0, proj=stage == 1),
                **{n: ops[n] for n in ("ln", "wuvqk", "buvqk", "wo", "bo",
                                       "w13", "w2", "rab")})
    args = _BwdArgs(
        **{n: t.data_ptr() for n, t in ptrs.items()},
        seed=seed_t.data_ptr() if drop else None,
        B=B, L=Lc, D=D, H=H, F=F, NB=NB, G=G, P=P,
        **{f"off_{n}": off for n, (off, _) in layout.items()},
        cot_t=cot_t, scale=float(D // num_heads) ** -0.5,
        inv_len=1.0 / seq_len, dq_scale=dq_scale,
        thr=drop_threshold(rate) if drop else 0,
        keep_scale=keep_scale(rate) if drop else 1.0)
    with torch.cuda.device(dev):
        rc = _stage_bwd_fn()(int(x.dtype == torch.bfloat16),
                             ctypes.byref(args), stage, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"ring backward stage {stage} launch failed: "
                           f"CUDA error {rc}")
    return {n: grads[off:off + int(np.prod(shape))].view(shape)
            for n, (off, shape) in layout.items() if n in keys}


def ring_post_bwd(x, av, dout, ops: Mapping, seed, rate: float,
                  seq_len: int, num_heads: int) -> dict:
    """The post stage's backward (see :func:`ring_post_bwd_plain`). CPU
    tensors take the plain version; CUDA tensors launch the gate/FFN
    backward alone (``gate_ffn_bwd_wgmma_kernel`` + ``wgrad_wgmma_kernel``
    where :func:`block_wgmma`; counted in ``ring_post_bwd.launches``)."""
    if not _on_card(x, "ring_post_bwd"):
        return ring_post_bwd_plain(x, av, dout, ops, seed, rate, seq_len,
                                   num_heads)
    x, _ = _check(x, ops, None, num_heads, "ring post stage backward", av,
                  dout)
    if av.shape != x.shape or dout.shape != x.shape or \
            av.dtype != x.dtype or dout.dtype != x.dtype:
        raise ValueError("ring post stage backward: av and dout must match "
                         "x in shape and dtype")
    f32 = torch.float32
    bufs = {n: torch.empty_like(x) for n in ("q", "k", "v", "dav")}
    bufs.update({n: torch.empty(x.shape, dtype=f32, device=x.device)
                 for n in ("du", "dy")})
    out = _launch_bwd_stage(0, x, ops, num_heads, seq_len, seed, rate,
                            ("w2", "w13", "wo", "bo", "ln"), av=av,
                            dout=dout, **bufs)
    ring_post_bwd.launches += 1
    return dict(out, dav=bufs["dav"], du=bufs["du"], dy=bufs["dy"])


ring_post_bwd.launches = 0


def ring_pre_bwd(x, ops: Mapping, dq, dk, dv, du, seq_len: int,
                 num_heads: int) -> dict:
    """The pre stage's backward (see :func:`ring_pre_bwd_plain`). CPU
    tensors take the plain version; CUDA tensors launch the projection
    backward alone, with no residual (``proj_bwd_wgmma_kernel`` +
    ``wgrad_wgmma_kernel`` where :func:`block_wgmma`; counted in
    ``ring_pre_bwd.launches``). The kernels read dq, dk and dv in x's
    dtype, as the pairs' backward returns them, and du in f32, and apply
    hd^-1/2 to dq in f32 (``f32(dq) * hd^-1/2``, then dsilu), as the plain
    version does."""
    if not _on_card(x, "ring_pre_bwd"):
        return ring_pre_bwd_plain(x, ops, dq, dk, dv, du, seq_len, num_heads)
    ins = {"dq": dq, "dk": dk, "dv": dv, "du": du}
    for n, t in ins.items():
        want = torch.float32 if n == "du" else x.dtype
        if t.shape != x.shape or t.dtype != want:
            raise ValueError(f"ring pre stage backward: {n} must be {want} "
                             f"of x's shape {tuple(x.shape)}, not {t.dtype} "
                             f"{tuple(t.shape)}")
    ins = {n: t.contiguous() for n, t in ins.items()}
    x, _ = _check(x, ops, None, num_heads, "ring pre stage backward",
                  *ins.values())
    hd = x.shape[-1] // num_heads
    dx = torch.empty_like(x)
    out = _launch_bwd_stage(1, x, ops, num_heads, seq_len, 0, 0.0,
                            ("ln", "wuvqk", "buvqk"), cot_t=1,
                            dq_scale=float(hd) ** -0.5, dx=dx, **ins)
    ring_pre_bwd.launches += 1
    return dict(out, dx=dx)


ring_pre_bwd.launches = 0


#: the block leaves each ring stage differentiates, in BLOCK_LEAVES' terms
PRE_LEAVES = BLOCK_LEAVES[0:2] + BLOCK_LEAVES[6:8]
POST_LEAVES = BLOCK_LEAVES[2:6] + BLOCK_LEAVES[8:12]


class RingPreProjFn(torch.autograd.Function):
    """The pre stage with its kernel backward. ``apply(x, ops, seq_len,
    num_heads, *leaves)``: ``ops`` the block's :func:`block_operands`
    (built once per block by the caller), ``leaves`` its
    :data:`PRE_LEAVES` (f32), which take the stage's weight gradients.
    Returns (q, k, v, u)."""

    @staticmethod
    def forward(ctx, x, ops, seq_len, num_heads, *leaves):
        ctx.save_for_backward(x)
        ctx.ops, ctx.seq_len, ctx.num_heads = ops, seq_len, num_heads
        return ring_pre_fwd(x, ops, seq_len, num_heads)

    @staticmethod
    def backward(ctx, dq, dk, dv, du):
        (x,) = ctx.saved_tensors
        g = ring_pre_bwd(x, ctx.ops, dq, dk, dv, du, ctx.seq_len,
                         ctx.num_heads)
        return (g["dx"], None, None, None, g["ln"][0], g["ln"][1],
                g["wuvqk"], g["buvqk"])


class RingPairAttnFn(torch.autograd.Function):
    """One pair of the ring with its kernel backward. ``apply(q, k, v,
    rab, valid, off, num_heads)`` -> the f32 partial; the backward returns
    dq, dk, dv in the activation dtype and drab in f32 (nothing for a pair
    wholly in the future)."""

    @staticmethod
    def forward(ctx, q, k, v, rab, valid, off, num_heads):
        ctx.save_for_backward(q, k, v, rab, valid)
        ctx.off, ctx.num_heads = off, num_heads
        return ring_pair_fwd(q, k, v, valid, rab, off, num_heads)

    @staticmethod
    def backward(ctx, dav):
        q, k, v, rab, valid = ctx.saved_tensors
        if _future(ctx.off, q.shape[1]):
            return (None,) * 7
        dav = dav.to(q.dtype).contiguous()
        args = (q, k, v, dav, valid, rab, ctx.off, ctx.num_heads)
        dq, drab = ring_pair_dq(*args)
        dk, dv = ring_pair_dkdv(*args)
        cdt = q.dtype
        return (dq.to(cdt), dk.to(cdt), dv.to(cdt), drab, None, None, None)


class RingPostGateFn(torch.autograd.Function):
    """The post stage with its kernel backward. ``apply(x, av, u, ops,
    seed, rate, seq_len, num_heads, *leaves)``: ``leaves`` the block's
    :data:`POST_LEAVES`; dropout at ``rate`` (0: none) from ``seed``.
    Returns the block's output; the backward gives x the residual path's
    gradient and av, u theirs (u's recomputed from x)."""

    @staticmethod
    def forward(ctx, x, av, u, ops, seed, rate, seq_len, num_heads,
                *leaves):
        ctx.save_for_backward(x, av, seed if isinstance(seed, torch.Tensor)
                              else torch.tensor(seed))
        ctx.ops, ctx.rate = ops, rate
        ctx.seq_len, ctx.num_heads = seq_len, num_heads
        return ring_post_fwd(x, av, u, ops, seed, rate)

    @staticmethod
    def backward(ctx, dout):
        x, av, seed = ctx.saved_tensors
        g = ring_post_bwd(x, av, dout.contiguous(), ctx.ops, seed, ctx.rate,
                          ctx.seq_len, ctx.num_heads)
        ln = g["ln"]
        return (g["dy"].to(x.dtype), g["dav"], g["du"], None, None, None,
                None, None, ln[2], ln[3], ln[4], ln[5], g["wo"], g["bo"],
                g["w13"], g["w2"])
