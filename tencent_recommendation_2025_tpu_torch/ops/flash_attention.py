"""Causal, key-padding-masked softmax attention ("flash MHA"): CUDA kernels,
plain versions, autograd.

Counterpart of ``tencent_recommendation_2025_tpu/ops/flash_attention.py``,
the parity presets' attention (``block_type="mha"``). Per batch row and
head, on head-packed [B, L, D] q, k, v (D = H * hd):

    s   = T(q * hd^-1/2) k^T                        (f32 sums)
    p   = safe softmax of s over the causal, valid keys (f32; a query row
          with no valid key gives p = 0, so left padding outputs zeros)
    out = T(p) @ v                                  (f32 sums, out in T)

with T the compute dtype (bf16 on the card's product path, f32 in the
checks). The forward also gives each query row's softmax max and sum
(``stats`` [2, B, H, L] f32: finfo(f32).min and 0 on a row with no visible
key), which the backward takes instead of recomputing them: p = exp(s -
max) / max(sum, 1e-30) in f32, dv = T(p)^T do, ds = T(p * (dp - rowsum(dp *
p))) with dp = do v^T, dq = ds k * hd^-1/2, dk = ds^T T(q * hd^-1/2); dq, dk
and dv in T.

Kernels (``csrc/flash_attention.cu``): ``flash_fwd_wgmma_kernel`` replaces
``_fwd_kernel`` (l.50); ``flash_bwd_dq_wgmma_kernel`` and
``flash_bwd_dkdv_wgmma_kernel`` replace ``_bwd_kernel`` (l.81): Hopper
``wgmma`` products with register accumulators on swizzled shared-memory
tiles fed by a cp.async ring (``csrc/sm90_mma.cuh``), for bf16 at any head
dim up to 128 (zero-padded to 16, 32, 64 or 128 columns). f32 (the tight
check instance) and heads of 129-256 keep the first kernels
(``flash_fwd_kernel``, ``flash_bwd_dq_kernel``, ``flash_bwd_dkdv_kernel``:
WMMA or FMA products through shared memory). The TPU kernel computes each
128-query stripe's exact softmax before it rounds p; the CUDA forward keeps
that rounding point by walking a query tile's key tiles twice, first for
the row max and sum, then for T(p) @ v with p normalised. The plain
versions below are the TPU kernel's arithmetic, so both rounding points
agree. Bound at baseline_o1's shape (B=128, L=1024, D=64, H=1) on the H100:
bytes, 0.020 ms forward; operations, 0.044 ms backward.

The encoder takes these where the JAX package's ``make_attention_cores``
does: 256 <= L, L % 128 == 0 and L * max(D, 64) <= 1024 * 64; longer MHA
runs dense. Each wrapper takes its plain version for tensors on the CPU and
launches its kernel for CUDA tensors (counted in ``flash_mha_fwd.launches``
and ``flash_mha_bwd.launches``); it never falls back. The kernels take any
head dim up to 256 (``MAX_HEAD_DIM``) and L a multiple of 64, bf16 or f32;
anything else raises, as does a backward on CUDA tensors without the
forward's stats. A wider head raises ``NotImplementedError``: no route
reaches one, since the gate's L * max(D, 64) <= 1024 * 64 at 256 <= L caps
D, and so hd, at 256 (JAX ``models/encoder.py:188, 204``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import kernels
from .fused_block import _heads, _mm, _rows, _stream
from .hstu_attention import causal_valid, check_attention_inputs, valid_int32

MAX_FLASH_L = 1024
#: the widest head the flash kernels take (the gate caps D at 256)
MAX_HEAD_DIM = 256


def safe_masked_softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis where ``mask`` is True; all-masked rows
    give 0 (the max is taken without a gradient)."""
    neg = torch.finfo(s.dtype).min
    masked = torch.where(mask, s, torch.full_like(s, neg))
    m = masked.amax(-1, keepdim=True).detach()
    e = torch.exp(masked - m) * mask.to(s.dtype)
    z = e.sum(-1, keepdim=True)
    return e / torch.clamp(z, min=1e-30)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, valid, num_heads):
    """(T(q * hd^-1/2) in heads, s [B, H, L, L] f32, the causal and
    key-valid mask)."""
    L, D = q.shape[1], q.shape[2]
    hd = D // num_heads
    qs = _heads((q.float() * hd ** -0.5).to(q.dtype), num_heads)
    s = _mm(qs, _heads(k, num_heads).transpose(-1, -2))
    return qs, s, causal_valid(valid, L)


def softmax_stats(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each row's max over its visible scores (finfo min where none is
    visible) and sum of exp(s - max) over them: [2, *s.shape[:-1]] f32, as
    ``safe_masked_softmax`` computes them."""
    neg = torch.finfo(s.dtype).min
    masked = torch.where(mask, s, torch.full_like(s, neg))
    m = masked.amax(-1)
    z = (torch.exp(masked - m[..., None]) * mask.to(s.dtype)).sum(-1)
    return torch.stack([m, z])


def _probs_from_stats(s, mask, stats):
    """p from the rows' max and sum, as ``safe_masked_softmax`` forms it."""
    neg = torch.finfo(s.dtype).min
    masked = torch.where(mask, s, torch.full_like(s, neg))
    e = torch.exp(masked - stats[0][..., None]) * mask.to(s.dtype)
    return e / torch.clamp(stats[1][..., None], min=1e-30)


def flash_mha_fwd_plain(q, k, v, valid, num_heads: int,
                        return_stats: bool = False):
    """Plain PyTorch version of the forward kernel, with its rounding
    points; with ``return_stats``, (out, stats [2, B, H, L] f32)."""
    _, s, mask = _scores(q, k, valid, num_heads)
    stats = softmax_stats(s, mask)
    p = _probs_from_stats(s, mask, stats)
    out = _rows(_mm(p.to(q.dtype), _heads(v, num_heads))).to(q.dtype)
    return (out, stats) if return_stats else out


def flash_mha_bwd_plain(q, k, v, dout, valid, num_heads: int,
                        stats: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernels, written out op by op with
    their rounding points: (dq, dk, dv) in the compute dtype. p comes from
    the forward's ``stats`` where given, else from the scores' own."""
    cdt = q.dtype
    hd = q.shape[2] // num_heads
    qs, s, mask = _scores(q, k, valid, num_heads)
    if stats is None:
        stats = softmax_stats(s, mask)
    else:
        check_stats(stats, q, num_heads)
    p = _probs_from_stats(s, mask, stats)
    do = _heads(dout.to(cdt), num_heads)
    dv = _mm(p.to(cdt).transpose(-1, -2), do)
    dp = _mm(do, _heads(v, num_heads).transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(cdt)
    dq = _mm(ds, _heads(k, num_heads)) * hd ** -0.5
    dk = _mm(ds.transpose(-1, -2), qs)
    return _rows(dq).to(cdt), _rows(dk).to(cdt), _rows(dv).to(cdt)


def check_stats(stats: torch.Tensor, q: torch.Tensor, num_heads: int):
    """Raises ValueError unless ``stats`` is the forward's [2, B, H, L] f32
    tensor for ``q``, contiguous and on its device."""
    B, L, _ = q.shape
    want = (2, B, num_heads, L)
    if not isinstance(stats, torch.Tensor) or tuple(stats.shape) != want \
            or stats.dtype != torch.float32:
        got = (tuple(stats.shape), stats.dtype) \
            if isinstance(stats, torch.Tensor) else type(stats).__name__
        raise ValueError(f"flash attention backward: stats must be the "
                         f"forward's {want} float32 row max and sum, got "
                         f"{got}")
    if stats.device != q.device or not stats.is_contiguous():
        raise ValueError(f"flash attention backward: stats must be "
                         f"contiguous on {q.device}, got {stats.device}")


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _fn(name: str, n_ptr: int):
    fn = getattr(kernels.load("flash_attention"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [_I] + [_P] * n_ptr + [_I] * 4 + [_F, _P]
    return fn


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor, num_heads: int,
                  return_stats: bool = False):
    """The forward kernel on head-packed [B, L, D] q, k, v; ``valid`` [B, L]
    (nonzero = valid key). With ``return_stats``, (out, stats): each query
    row's softmax max and sum, [2, B, H, L] f32, for ``flash_mha_bwd``. CPU
    tensors take the plain version; CUDA tensors launch the kernel (counted
    in ``flash_mha_fwd.launches``)."""
    if q.device.type == "cpu":
        return flash_mha_fwd_plain(q, k, v, valid, num_heads, return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_fwd: no kernel for {q.device}")
    check_attention_inputs("flash attention kernel", num_heads, q, k, v,
                           max_head_dim=MAX_HEAD_DIM)
    B, L, D = q.shape
    vi = valid_int32(valid, q.shape)
    out = torch.empty_like(q)
    stats = torch.empty((2, B, num_heads, L), dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        rc = _fn("flash_attn_fwd", 6)(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), vi.data_ptr(), out.data_ptr(), stats.data_ptr(), B,
            L, D, num_heads, float(D // num_heads) ** -0.5, _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed: CUDA error "
                           f"{rc}")
    flash_mha_fwd.launches += 1
    return (out, stats) if return_stats else out


flash_mha_fwd.launches = 0


def flash_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor, valid: torch.Tensor, num_heads: int,
                  stats: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels: (dq, dk, dv), p from the forward's ``stats``
    (``flash_mha_fwd(..., return_stats=True)``). CPU tensors take the plain
    version (which recomputes the stats where none are given); CUDA tensors
    need the stats and launch the kernels (one count in
    ``flash_mha_bwd.launches``)."""
    if q.device.type == "cpu":
        return flash_mha_bwd_plain(q, k, v, dout, valid, num_heads, stats)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_bwd: no kernel for {q.device}")
    check_attention_inputs("flash attention backward", num_heads, q, k, v,
                           dout, max_head_dim=MAX_HEAD_DIM)
    if stats is None:
        raise ValueError("flash_mha_bwd: the kernels take the forward's "
                         "stats (flash_mha_fwd(..., return_stats=True))")
    check_stats(stats, q, num_heads)
    B, L, D = q.shape
    vi = valid_int32(valid, q.shape)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # each row's rowsum(dp * p), from the dq kernel to the dk/dv kernel
    delta = torch.empty((B, num_heads, L), dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        rc = _fn("flash_attn_bwd", 10)(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), vi.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), delta.data_ptr(),
            B, L, D, num_heads, float(D // num_heads) ** -0.5,
            _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    flash_mha_bwd.launches += 1
    return dq, dk, dv


flash_mha_bwd.launches = 0


class FlashMHAFn(torch.autograd.Function):
    """``apply(q, k, v, valid, num_heads)``: the forward kernel, and the
    backward kernels for dq, dk, dv from the forward's row stats."""

    @staticmethod
    def forward(ctx, q, k, v, valid, num_heads):
        out, stats = flash_mha_fwd(q, k, v, valid, num_heads,
                                   return_stats=True)
        ctx.save_for_backward(q, k, v, valid, stats)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, stats = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(q, k, v, dout.contiguous(), valid,
                                   ctx.num_heads, stats)
        return dq, dk, dv, None, None


def flash_mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Head-packed causal flash MHA: q/k/v [B, L, D] (D = H * hd); valid
    [B, L] key padding. Returns [B, L, D], differentiable in q, k, v."""
    return FlashMHAFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            valid, num_heads)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """[B, H, L, hd] interface (transposes into the packed layout)."""
    B, H, L, hd = q.shape

    def pack(t):
        return t.transpose(1, 2).reshape(B, L, H * hd)

    out = flash_mha_packed(pack(q), pack(k), pack(v), valid, H)
    return out.reshape(B, L, H, hd).transpose(1, 2)
