"""HSTU pointwise-gated attention block, dense PyTorch version.

Counterpart of ``tencent_recommendation_2025_tpu/models/hstu.py``: one
packed projection D -> 4D gives U (gate), V, Q, K through SiLU; attention
weights are pointwise, ``silu(QK^T / sqrt(hd) + rab) * mask / L`` with no
softmax; ``rab`` is a learned bias over clamped causal distance; the output
is ``(LayerNorm(A @ V) * U) @ Wo + bo`` without the residual.

This is the path the encoder takes wherever the JAX package runs plain XLA
(the CPU, short or ragged sequences), and the oracle the fused kernel is
tested against. With a ``core`` the attention inner loop is the standalone
HSTU attention kernel's instead (``ops/hstu_attention.py``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as Fn

from .embedding import layernorm, layernorm_init, linear_init, xavier_normal


def init_hstu_params(gen: torch.Generator, d_model: int, num_heads: int,
                     rel_pos_buckets: int = 128):
    return {
        "uvqk": {"w": xavier_normal(gen, (d_model, 4 * d_model)),
                 "b": torch.zeros(4 * d_model)},
        "out": linear_init(gen, d_model, d_model),
        "attn_ln": layernorm_init(d_model, 1.0),
        "rab": torch.randn((num_heads, rel_pos_buckets), generator=gen)
        * 0.02,
    }


def rel_pos_bias(rab: torch.Tensor, seq_len: int) -> torch.Tensor:
    """[H, buckets] -> [H, L, L] causal distance bias (distance clamped)."""
    buckets = rab.shape[-1]
    pos = torch.arange(seq_len, device=rab.device)
    dist = (pos[:, None] - pos[None, :]).clamp(0, buckets - 1)
    return rab[:, dist]


def dropout(x: torch.Tensor, rate: float, train: bool,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with keep probability 1 - rate, masks drawn from
    ``gen`` (on x's device); the identity unless training with a rate and a
    generator, as the JAX package's guard reads."""
    if not (train and rate > 0.0 and gen is not None):
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def hstu_project(params: Mapping, x: torch.Tensor):
    """(u, v, q, k), each [B, L, D]: silu of the packed D -> 4D
    projection."""
    dtype = x.dtype
    uvqk = Fn.silu(x @ params["uvqk"]["w"].to(dtype)
                   + params["uvqk"]["b"].to(dtype))
    return torch.split(uvqk, x.shape[-1], dim=-1)


def hstu_output(params: Mapping, av: torch.Tensor, u: torch.Tensor,
                dropout_rate: float = 0.0, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """``(LayerNorm(av) * u) @ Wo + bo``, the gated product taking dropout
    from ``gen`` in training."""
    dtype = av.dtype
    ln = {"scale": params["attn_ln"]["scale"].to(dtype),
          "bias": params["attn_ln"]["bias"].to(dtype)}
    gated = dropout(layernorm(ln, av) * u, dropout_rate, train, gen)
    return gated @ params["out"]["w"].to(dtype) + params["out"]["b"].to(dtype)


def hstu_block(params: Mapping, x: torch.Tensor,
               mask: Optional[torch.Tensor], num_heads: int,
               dropout_rate: float = 0.0, train: bool = False,
               gen: Optional[torch.Generator] = None,
               core=None) -> torch.Tensor:
    """x [B, L, D]; mask [B, L, L] bool (True = attend). Returns the block
    output without the residual; in training the gated output takes
    dropout from ``gen``.

    ``core(q, k, v, rab) -> av`` replaces the dense pointwise-attention
    inner loop on head-packed [B, L, D] post-SiLU q, k, v (the standalone
    HSTU attention kernels, ``ops/hstu_attention.py``); ``mask`` is then
    unused. The JAX package's unpacked [B, H, L, hd] cores and its
    ``fused_silu`` variant are set nowhere in it and are not ported."""
    dtype = x.dtype
    B, L, D = x.shape
    hd = D // num_heads
    u, v, q, k = hstu_project(params, x)
    if core is not None:
        return hstu_output(params, core(q, k, v, params["rab"]), u,
                           dropout_rate, train, gen)

    def heads(t):
        return t.reshape(B, L, num_heads, hd).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    scores = scores * (hd ** -0.5)
    scores = scores + rel_pos_bias(params["rab"].float(), L)[None]
    attn = Fn.silu(scores) * mask[:, None].float()
    attn = attn / float(L)
    av = torch.matmul(attn.to(dtype).float(), vh.float()).to(dtype)
    av = av.transpose(1, 2).reshape(B, L, D)
    return hstu_output(params, av, u, dropout_rate, train, gen)
