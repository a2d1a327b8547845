"""HSTU pointwise-gated attention block, dense PyTorch version.

Counterpart of ``tencent_recommendation_2025_tpu/models/hstu.py``: one
packed projection D -> 4D gives U (gate), V, Q, K through SiLU; attention
weights are pointwise, ``silu(QK^T / sqrt(hd) + rab) * mask / L`` with no
softmax; ``rab`` is a learned bias over clamped causal distance; the output
is ``(LayerNorm(A @ V) * U) @ Wo + bo`` without the residual.

This is the path the encoder takes wherever the JAX package runs plain XLA
(the CPU, short or ragged sequences), and the oracle the fused kernel is
tested against. With a ``core`` the attention inner loop is the standalone
HSTU attention kernel's instead (``ops/hstu_attention.py``). On a model
mesh the block is tensor-parallel: u, v, q, k column-split (each shard its
heads' columns), the output projection row-split (``parallel/
partition.py``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as Fn

from ..parallel.partition import ModelShards, column_parallel, row_parallel
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


def shard_keeps(shape, dim: int, rate: float, train: bool,
                gen: Optional[torch.Generator], mesh, device):
    """The keep masks of a tensor split along ``dim`` over the model axis:
    one draw of the whole ``shape`` (the single device's mask), split, the
    shards this process holds; None without dropout."""
    if not (train and rate > 0.0 and gen is not None):
        return None
    keep = torch.rand(tuple(shape), generator=gen, device=device) >= rate
    chunks = keep.chunk(mesh.shape["model"], dim=dim)
    return [chunks[m] for m in mesh.model_indices]


def _keep(x: torch.Tensor, keep, rate: float) -> torch.Tensor:
    return x if keep is None else x * keep.to(x.dtype) / (1.0 - rate)


def dropout_shards(x: ModelShards, rate: float, train: bool,
                   gen: Optional[torch.Generator]) -> ModelShards:
    """:func:`dropout` of a tensor split along its last dim over the model
    axis: each shard its columns of the whole-width draw."""
    shape = list(x.parts[0].shape)
    shape[-1] *= x.size
    keeps = shard_keeps(shape, -1, rate, train, gen, x.mesh,
                        x.parts[0].device)
    if keeps is None:
        return x
    return ModelShards([_keep(p, k, rate) for p, k in zip(x.parts, keeps)],
                       x.mesh)


def hstu_project(params: Mapping, x: torch.Tensor,
                 fused_silu: bool = False):
    """(u, v, q, k), each [B, L, D]: silu of the packed D -> 4D
    projection; with ``fused_silu`` (a core that applies the SiLU to q, k
    and v itself, as the JAX package's hook reads ``core.fused_silu``)
    silu(u) and the PRE-activation v, q, k. With the projection
    column-split over a model mesh (a ``ModelShards``), each is a
    ``ModelShards`` of the shard's columns of u, v, q and k (the shard's
    heads)."""
    dtype = x.dtype
    w, b = params["uvqk"]["w"], params["uvqk"]["b"]

    def act(uvqk):
        if not fused_silu:
            return torch.split(Fn.silu(uvqk), uvqk.shape[-1] // 4, dim=-1)
        u, v, q, k = torch.split(uvqk, uvqk.shape[-1] // 4, dim=-1)
        return Fn.silu(u), v, q, k

    if isinstance(w, ModelShards):
        parts = [act(t) for t in
                 column_parallel(x, w.to(dtype), b.to(dtype)).parts]
        return tuple(ModelShards([p[i] for p in parts], w.mesh)
                     for i in range(4))
    return act(x @ w.to(dtype) + b.to(dtype))


def hstu_output(params: Mapping, av: torch.Tensor, u,
                dropout_rate: float = 0.0, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """``(LayerNorm(av) * u) @ Wo + bo``, the gated product taking dropout
    from ``gen`` in training. On a model mesh (``u`` a ``ModelShards``)
    ``av`` is whole: its LayerNorm spans all of D, each shard keeps its
    columns (``scatter_to_model``), gates them with its u and takes its
    rows of Wo; the partial products sum over the model group
    (:func:`parallel.partition.row_parallel`) before the replicated
    bias."""
    dtype = av.dtype
    ln = {"scale": params["attn_ln"]["scale"].to(dtype),
          "bias": params["attn_ln"]["bias"].to(dtype)}
    bo = params["out"]["b"].to(dtype)
    if isinstance(u, ModelShards):
        y = ModelShards(u.mesh.scatter_to_model(layernorm(ln, av)), u.mesh)
        gated = dropout_shards(y.map(torch.mul, u), dropout_rate, train, gen)
        return row_parallel(gated, params["out"]["w"], dtype) + bo
    gated = dropout(layernorm(ln, av) * u, dropout_rate, train, gen)
    return gated @ params["out"]["w"].to(dtype) + bo


def dense_av(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             rab: torch.Tensor, mask: torch.Tensor,
             num_heads: int) -> torch.Tensor:
    """The dense pointwise-attention inner loop on head-packed [B, L, D]
    q, k, v (D = num_heads * hd), ``rab`` [num_heads, buckets], ``mask``
    [B, L, L]: av [B, L, D] in q's dtype."""
    dtype = q.dtype
    B, L, D = q.shape
    hd = D // num_heads

    def heads(t):
        return t.reshape(B, L, num_heads, hd).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    scores = scores * (hd ** -0.5)
    scores = scores + rel_pos_bias(rab.float(), L)[None]
    attn = Fn.silu(scores) * mask[:, None].float()
    attn = attn / float(L)
    av = torch.matmul(attn.to(dtype).float(), vh.float()).to(dtype)
    return av.transpose(1, 2).reshape(B, L, D)


def hstu_attend(q, k, v, rab: torch.Tensor, mask: Optional[torch.Tensor],
                num_heads: int, core=None) -> torch.Tensor:
    """av [B, L, D] of post-SiLU q, k, v (pre-activation for a core with
    ``fused_silu``): ``core(q, k, v, rab)`` where one is given, else the
    dense loop (:func:`dense_av`). On a model mesh (q, k, v
    ``ModelShards``) with H % M == 0 each shard runs its H / M heads
    with its rows of ``rab`` (``scatter_to_model``; the core built for H /
    M heads) and av gathers whole; otherwise q, k and v gather whole and
    every shard runs all H heads (the core built for H)."""
    if not isinstance(q, ModelShards):
        return core(q, k, v, rab) if core is not None else \
            dense_av(q, k, v, rab, mask, num_heads)
    mesh, M = q.mesh, q.size
    if num_heads % M == 0:
        rabs = mesh.scatter_to_model(rab, dim=0)
        avs = [core(qm, km, vm, rm) if core is not None else
               dense_av(qm, km, vm, rm, mask, num_heads // M)
               for qm, km, vm, rm in zip(q.parts, k.parts, v.parts, rabs)]
        return mesh.gather_from_model(avs)
    qw, kw, vw = (mesh.gather_from_model(t.parts) for t in (q, k, v))
    return core(qw, kw, vw, rab) if core is not None else \
        dense_av(qw, kw, vw, rab, mask, num_heads)


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
    unused. A core whose ``fused_silu`` attribute is True takes the
    pre-activation q, k, v and applies the SiLU itself (e.g.
    ``hstu_attention_packed(..., silu_qkv=True)``), as in the JAX package
    (``models/hstu.py:79-82``), where no route sets it either; only u goes
    through the SiLU here then. The JAX package's unpacked [B, H, L, hd]
    cores are set nowhere in it and are not ported. With the parameters
    split over a model mesh (``ModelShards``) the block is tensor-parallel
    (:func:`hstu_project`, :func:`hstu_attend`, :func:`hstu_output`)."""
    u, v, q, k = hstu_project(params, x, getattr(core, "fused_silu", False))
    av = hstu_attend(q, k, v, params["rab"], mask, num_heads, core)
    return hstu_output(params, av, u, dropout_rate, train, gen)
