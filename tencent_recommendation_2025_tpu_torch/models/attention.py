"""Softmax multi-head attention, the parity presets' block attention.

Counterpart of ``tencent_recommendation_2025_tpu/models/attention.py``:
separate Q/K/V/O projections with bias, a boolean mask, scale
1/sqrt(head_dim), attention-weight dropout on the dense path. The masked
softmax is safe: a fully masked query row (left padding) gives zeros, not
NaN. Scores and softmax are f32; the products take the compute dtype.

The encoder swaps the dense inner loop for the flash MHA kernels
(``ops/flash_attention.py``) where the JAX package takes its Pallas kernel;
on that path the attention weights take no dropout, as in the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..ops.flash_attention import safe_masked_softmax
from .embedding import linear_init
from .hstu import dropout


def init_mha_params(gen: torch.Generator, d_model: int):
    return {"q": linear_init(gen, d_model, d_model),
            "k": linear_init(gen, d_model, d_model),
            "v": linear_init(gen, d_model, d_model),
            "o": linear_init(gen, d_model, d_model)}


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def mha(params: Mapping, x: torch.Tensor, mask: Optional[torch.Tensor],
        num_heads: int, dropout_rate: float = 0.0, train: bool = False,
        gen: Optional[torch.Generator] = None, core=None) -> torch.Tensor:
    """Self-attention. ``x`` [B, L, D]; ``mask`` [B, L, L] bool (True =
    attend), unused when ``core`` is given.

    ``core(q, k, v) -> out`` replaces the dense inner loop on head-packed
    [B, L, D] projections (the flash MHA kernels); the attention weights
    then take no dropout. In training the dense path's weights take dropout
    from ``gen``."""
    dtype = x.dtype

    def proj(p, t):
        return t @ p["w"].to(dtype) + p["b"].to(dtype)

    q, k, v = (proj(params[n], x) for n in ("q", "k", "v"))
    if core is not None:
        return proj(params["o"], core(q, k, v))
    hd = x.shape[-1] // num_heads
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    probs = safe_masked_softmax(scores * hd ** -0.5, mask[:, None])
    probs = dropout(probs, dropout_rate, train, gen)
    out = torch.matmul(probs.to(dtype).float(), vh.float()).to(dtype)
    return proj(params["o"], _merge_heads(out))
