"""Softmax multi-head attention, the parity presets' block attention.

Counterpart of ``tencent_recommendation_2025_tpu/models/attention.py``:
separate Q/K/V/O projections with bias, a boolean mask, scale
1/sqrt(head_dim), attention-weight dropout on the dense path. The masked
softmax is safe: a fully masked query row (left padding) gives zeros, not
NaN. Scores and softmax are f32; the products take the compute dtype.

The encoder swaps the dense inner loop for the flash MHA kernels
(``ops/flash_attention.py``) where the JAX package takes its Pallas kernel;
on that path the attention weights take no dropout, as in the JAX package.
On a model mesh the layer is tensor-parallel (q, k, v column-split by
heads, o row-split; ``parallel/partition.py``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..ops.flash_attention import safe_masked_softmax
from ..parallel.partition import ModelShards, column_parallel, row_parallel
from .embedding import linear_init
from .hstu import dropout, shard_keeps


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


def _dense_heads(q, k, v, mask, num_heads: int, keep=None,
                 rate: float = 0.0) -> torch.Tensor:
    """The dense inner loop on head-packed q, k, v of ``num_heads`` heads:
    the masked softmax in f32, its weights times ``keep`` / (1 - rate)
    where a dropout mask is given."""
    dtype = q.dtype
    hd = q.shape[-1] // num_heads
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    probs = safe_masked_softmax(scores * hd ** -0.5, mask[:, None])
    if keep is not None:
        probs = probs * keep.to(probs.dtype) / (1.0 - rate)
    out = torch.matmul(probs.to(dtype).float(), vh.float()).to(dtype)
    return _merge_heads(out)


def mha(params: Mapping, x: torch.Tensor, mask: Optional[torch.Tensor],
        num_heads: int, dropout_rate: float = 0.0, train: bool = False,
        gen: Optional[torch.Generator] = None, core=None) -> torch.Tensor:
    """Self-attention. ``x`` [B, L, D]; ``mask`` [B, L, L] bool (True =
    attend), unused when ``core`` is given.

    ``core(q, k, v) -> out`` replaces the dense inner loop on head-packed
    [B, L, D] projections (the flash MHA kernels); the attention weights
    then take no dropout. In training the dense path's weights take dropout
    from ``gen``. With the projections split over a model mesh
    (``ModelShards``) the layer is tensor-parallel (:func:`_mha_tp`)."""
    if isinstance(params["q"]["w"], ModelShards):
        return _mha_tp(params, x, mask, num_heads, dropout_rate, train, gen,
                       core)
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


def _mha_tp(params, x, mask, num_heads, rate, train, gen, core):
    """The tensor-parallel layer: q, k, v column-split (each shard its
    heads' columns, behind ``copy_to_model``), o row-split, its partial
    products summed over the model group before the replicated bias. With
    H % M == 0 each shard attends over its H / M heads (the core built for
    them; the dense weights take their heads of the whole [B, H, L, L]
    dropout draw); otherwise q, k and v gather whole, every shard attends
    over all heads and keeps its columns of the output."""
    dtype = x.dtype
    q, k, v = (column_parallel(x, params[n]["w"].to(dtype),
                               params[n]["b"].to(dtype))
               for n in ("q", "k", "v"))
    mesh, M = q.mesh, q.size
    if num_heads % M == 0:
        hm = num_heads // M
        if core is not None:
            outs = [core(*t) for t in zip(q.parts, k.parts, v.parts)]
        else:
            B, L = x.shape[:2]
            keeps = shard_keeps((B, num_heads, L, L), 1, rate, train, gen,
                                mesh, x.device) or [None] * len(q.parts)
            outs = [_dense_heads(qm, km, vm, mask, hm, kp, rate)
                    for qm, km, vm, kp in zip(q.parts, k.parts, v.parts,
                                              keeps)]
        out = ModelShards(outs, mesh)
    else:
        qw, kw, vw = (mesh.gather_from_model(t.parts) for t in (q, k, v))
        if core is not None:
            whole = core(qw, kw, vw)
        else:
            B, L = x.shape[:2]
            keep = torch.rand((B, num_heads, L, L), generator=gen,
                              device=x.device) >= rate \
                if train and rate > 0.0 and gen is not None else None
            whole = _dense_heads(qw, kw, vw, mask, num_heads, keep, rate)
        out = ModelShards(mesh.scatter_to_model(whole), mesh)
    return row_parallel(out, params["o"]["w"], dtype) \
        + params["o"]["b"].to(dtype)
