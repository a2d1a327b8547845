"""Fused pre-norm HSTU block forward: CUDA kernel, plain version and gate.

Counterpart of ``tencent_recommendation_2025_tpu/ops/fused_block.py``. One
call runs a whole HSTU block (pre-norm, SwiGLU FFN) on [B, L, D]
activations and returns ``x + block(x)``:

    h    = LN(x; ln1)
    uvqk = silu(h @ Wuvqk + b);  u, v, q, k = split(uvqk)
    av   = (silu(q k^T * hd^-1/2 + rab) * causal * key_valid / L) @ v
    y    = x + (LN(av; ln2) * u) @ Wo + bo
    out  = y + (silu(x1) * x3) @ W2,   [x1 | x3] = LN(y; ln3) @ W13

Kernel: ``csrc/fused_block.cu`` replaces the TPU kernel
``tencent_recommendation_2025_tpu/ops/fused_block.py::_fwd_kernel`` (l.274)
in inference (``train=False``: no dropout). Its bound on the H100 at the
flagship shape (B=128, L=1024, D=64, F=256, H=1) is compute: 35.4 GFLOP of
products per block, 36 us at 989 TFLOP/s bf16, against 33.5 MB of
activation traffic (10 us at 3.35 TB/s). The source says how its design
meets that. The backward (``_bwd_kernel``) belongs to the training slice.

Numerics (those of the TPU kernel): matmul operands in the activation dtype
with f32 accumulation; LN, SiLU, gating and residuals in f32; ``q*hd^-1/2``,
``v/L`` and ``silu(s)`` rounded to the activation dtype before their
products; LN eps 1e-8; division by the padded L; keys with token_type 0
masked, queries not.

:func:`fused_hstu_block` takes the plain PyTorch version for a tensor on the
CPU and launches the kernel for a CUDA tensor; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch
import torch.nn.functional as Fn

from . import kernels

FB_BLK = 128             # TPU stripe width: the gate's L granularity
FB_WHOLESEQ_MAX = 1024   # whole-sequence kernel ceiling at D=64
FB_CHUNK = 512           # L-chunk width of the (unported) chunked kernels
FB_ATTN_BLK_BWD = 512
MAX_CHUNKED_L = 16384
_EPS = 1e-8


def wholeseq_max_l(D: int) -> int:
    """Longest L the whole-sequence kernel takes at width D; longer runs
    need the chunked kernels (not ported)."""
    return FB_WHOLESEQ_MAX * 64 // max(D, 64)


#: widest model the fused kernels accept
MAX_FUSED_D = 64 * FB_ATTN_BLK_BWD // FB_BLK


def _chunk_of(Lc: int, D: int = 64):
    """Projection/FFN chunk width of the chunked kernels at length Lc."""
    for c in (FB_CHUNK, 256, 128):
        if Lc % c == 0 and D * c <= 128 * FB_CHUNK:
            return c
    return None


def _n_near(buckets: int, blk: int = FB_BLK) -> int:
    """Non-constant rel-pos bias slots of the TPU kernels (at most 8)."""
    needed = (buckets - 2 + blk - 1) // blk + 1
    if needed > 8:
        raise ValueError(
            f"hstu_rel_pos_buckets={buckets} needs {needed} non-constant "
            f"bias tile slots but the kernel supports at most 8 "
            f"(buckets <= {7 * blk + 2})")
    return needed


def fused_block_supported(cfg, L: int, backend: str) -> bool:
    """The fused-block gate of the JAX package with ``"cuda"`` in place of
    ``"tpu"``: the shapes on which it takes its Pallas fused kernels."""
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


def _ln(xf, g, b):
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) * (xf - mu)).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + _EPS) * g + b


def _mm(a, b):
    """Product of compute-dtype operands with f32 accumulation (bf16
    products are exact in f32)."""
    return torch.matmul(a.float(), b.float())


def fused_hstu_block_plain(x: torch.Tensor, o: Mapping,
                           token_type: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points, on
    the same operands (:func:`block_operands` of one block)."""
    cdt = x.dtype
    B, L, D = x.shape
    hd = D // num_heads
    ln = o["ln"]
    F = o["w2"].shape[0]
    NB = o["rab"].shape[1]
    xf = x.float()
    uvqk = Fn.silu(_mm(_ln(xf, ln[0], ln[1]).to(cdt), o["wuvqk"])
                   + o["buvqk"])
    u = uvqk[..., :D]
    v = (uvqk[..., D:2 * D] * (1.0 / L)).to(cdt)
    q = (uvqk[..., 2 * D:3 * D] * (hd ** -0.5)).to(cdt)
    k = uvqk[..., 3 * D:].to(cdt)

    def heads(t):
        return t.reshape(B, L, num_heads, hd).transpose(1, 2)

    pos = torch.arange(L, device=x.device)
    dist = pos[:, None] - pos[None, :]
    bias = o["rab"][:, dist.clamp(0, NB - 1)]                 # [H, L, L]
    mask = (dist >= 0)[None, None] & (token_type != 0)[:, None, None, :]
    s = _mm(heads(q), heads(k).transpose(-1, -2)) + bias[None]
    a = (Fn.silu(s) * mask).to(cdt)
    av = _mm(a, heads(v)).transpose(1, 2).reshape(B, L, D)
    g = _ln(av, ln[2], ln[3]) * u
    y = xf + _mm(g.to(cdt), o["wo"]) + o["bo"]
    x13 = _mm(_ln(y, ln[4], ln[5]).to(cdt), o["w13"])
    f = Fn.silu(x13[..., :F]) * x13[..., F:]
    return (y + _mm(f.to(cdt), o["w2"])).to(cdt)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _kernel_fn():
    fn = kernels.load("fused_block").fused_block_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [_I] + [_P] * 15 + [_I] * 6 + [_F, _F, _P]
    return fn


def _launch(x: torch.Tensor, o: Mapping, token_type: torch.Tensor,
            num_heads: int) -> torch.Tensor:
    B, L, D = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused block kernel takes bf16 or f32, not "
                         f"{x.dtype}")
    if L % 64 or D % 16 or D % num_heads:
        raise ValueError(f"fused block kernel needs L % 64 == 0, D % 16 == 0 "
                         f"and D % num_heads == 0 (L={L}, D={D}, "
                         f"H={num_heads})")
    if tuple(token_type.shape) != (B, L):
        raise ValueError(f"fused block kernel: token_type has shape "
                         f"{tuple(token_type.shape)}, expected {(B, L)}")
    F = o["w2"].shape[0]
    H, NB = o["rab"].shape
    if F % 16 or H != num_heads or o["wuvqk"].shape != (D, 4 * D):
        raise ValueError(f"fused block kernel: F={F} must be a multiple of "
                         f"16 and rab must have {num_heads} heads (got {H})")
    for name, t in o.items():
        want = x.dtype if name in ("wuvqk", "wo", "w13", "w2") \
            else torch.float32
        if t.dtype != want:
            raise ValueError(f"fused block kernel: {name} is {t.dtype}, not "
                             f"{want} (build the operands with "
                             f"block_operands(bp, x.dtype))")
    x = x.contiguous()
    # the kernel reads token_type itself: nonzero = valid key
    valid = token_type.to(torch.int32).contiguous()
    tensors = [x, valid, *o.values()]
    for t in tensors:
        if t.device != x.device:
            raise ValueError("fused block kernel: operands on different "
                             "devices")
        if not t.is_contiguous():
            raise ValueError("fused block kernel: operands must be "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError("fused block kernel: operands must be 16-byte "
                             "aligned")
    q = torch.empty_like(x)
    k = torch.empty_like(x)
    v = torch.empty_like(x)
    u = torch.empty((B, L, D), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(int(x.dtype == torch.bfloat16), x.data_ptr(),
                valid.data_ptr(), o["ln"].data_ptr(), o["wuvqk"].data_ptr(),
                o["buvqk"].data_ptr(), o["wo"].data_ptr(), o["bo"].data_ptr(),
                o["w13"].data_ptr(), o["w2"].data_ptr(), o["rab"].data_ptr(),
                q.data_ptr(), k.data_ptr(), v.data_ptr(), u.data_ptr(),
                out.data_ptr(), B, L, D, num_heads, F, NB,
                float(D // num_heads) ** -0.5, 1.0 / L, stream)
    if rc != 0:
        raise RuntimeError(f"fused_block_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    fused_hstu_block.launches += 1
    return out


def fused_hstu_block(x: torch.Tensor, ops: Mapping, token_type: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """One full HSTU block on [B, L, D] activations (bf16 or f32), forward
    only. ``ops`` is ``block_operands(bp, x.dtype)`` of one block, built
    once by the caller; ``token_type`` [B, L] (0 = padding key). CPU
    tensors take the plain version; CUDA tensors launch the kernel (counted
    in ``fused_hstu_block.launches``)."""
    if x.device.type == "cpu":
        return fused_hstu_block_plain(x, ops, token_type, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_hstu_block: no kernel for {x.device}")
    return _launch(x, ops, token_type, num_heads)


fused_hstu_block.launches = 0
