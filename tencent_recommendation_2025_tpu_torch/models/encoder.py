"""Sequence encoder: fused embeddings -> N blocks -> final LayerNorm.

Counterpart of ``tencent_recommendation_2025_tpu/models/encoder.py``, the
inference forward: sqrt(D) scaling, learned absolute positions 1..L zeroed
on padding ids, the causal ∧ key-padding mask, pre-norm HSTU blocks with a
SwiGLU (or ReLU) FFN, final LayerNorm(eps=1e-8).

Routing mirrors the JAX package's. Where it takes a Pallas kernel on a TPU,
the port takes its CUDA kernel on the card (the fused whole-sequence block,
``ops/fused_block``), or raises ``NotImplementedError`` naming the kernel
not ported yet. Where it runs plain XLA, the port runs plain PyTorch on any
device. On the CPU every path is plain.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as Fn

from ..config import ModelConfig
from ..ops import fused_block as FB
from .embedding import layernorm, layernorm_init, linear_init, torch_dtype
from .hstu import hstu_block, init_hstu_params


def swiglu_hidden_dim(d_model: int, mult: float, multiple_of: int) -> int:
    """2/3 rule, then round up to ``multiple_of``."""
    hidden = int(2 * (d_model * mult) / 3)
    return multiple_of * (-(-hidden // multiple_of))


def init_ffn_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    D = cfg.hidden_units
    if cfg.ffn_type == "swiglu":
        H = swiglu_hidden_dim(D, cfg.ffn_hidden_mult, cfg.ffn_multiple_of)
        return {"w13": linear_init(gen, D, 2 * H)["w"],
                "w2": linear_init(gen, H, D)["w"]}
    return {"fc1": linear_init(gen, D, D), "fc2": linear_init(gen, D, D)}


def ffn(params: Mapping, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    if "w13" in params:
        x1, x3 = torch.chunk(x @ params["w13"].to(dtype), 2, dim=-1)
        return (Fn.silu(x1) * x3) @ params["w2"].to(dtype)
    h = x @ params["fc1"]["w"].to(dtype) + params["fc1"]["b"].to(dtype)
    h = Fn.relu(h)
    return h @ params["fc2"]["w"].to(dtype) + params["fc2"]["b"].to(dtype)


def init_block_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    if cfg.block_type != "hstu":
        raise NotImplementedError(
            "softmax-MHA blocks (the baseline/baseline_o1 parity presets) "
            "are not ported yet: ROADMAP Queue 1, Parity presets")
    ln_scale = 0.0 if cfg.reference_init else 1.0
    return {
        "attn_ln": layernorm_init(cfg.hidden_units, ln_scale),
        "ffn_ln": layernorm_init(cfg.hidden_units, ln_scale),
        "ffn": init_ffn_params(gen, cfg),
        "hstu": init_hstu_params(gen, cfg.hidden_units, cfg.num_heads,
                                 cfg.hstu_rel_pos_buckets),
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def block_params(blocks: Mapping, i: int) -> Dict:
    """Block i of the stacked [num_blocks, ...] parameter tree."""
    if isinstance(blocks, dict):
        return {k: block_params(v, i) for k, v in blocks.items()}
    return blocks[i]


def init_encoder_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Blocks are stored stacked: every leaf gains a leading [num_blocks]
    axis, as in the JAX package."""
    ln_scale = 0.0 if cfg.reference_init else 1.0
    per_block = [init_block_params(gen, cfg) for _ in range(cfg.num_blocks)]
    return {"blocks": _stack(per_block),
            "last_ln": layernorm_init(cfg.hidden_units, ln_scale)}


def positional_take(pos_table: torch.Tensor,
                    seq_ids: torch.Tensor) -> torch.Tensor:
    """Positions 1..L, zeroed (row 0) on padding ids."""
    L = seq_ids.shape[1]
    poss = torch.arange(1, L + 1, device=seq_ids.device)[None, :] \
        * (seq_ids != 0)
    return pos_table[poss]


def attention_mask(seq_ids: torch.Tensor,
                   token_type: torch.Tensor) -> torch.Tensor:
    """[B, L, L] bool: causal (tril) ∧ key-not-padding."""
    L = seq_ids.shape[1]
    pos = torch.arange(L, device=seq_ids.device)
    causal = (pos[None, :] <= pos[:, None])[None]
    return causal & (token_type != 0)[:, None, :]


def _cast_ln(p, dtype):
    return {"scale": p["scale"].to(dtype), "bias": p["bias"].to(dtype)}


def block_route(cfg: ModelConfig, L: int, backend: str) -> str:
    """How the encoder runs its HSTU blocks at length L on ``backend``
    ("cuda" or "cpu"): "fused" (the fused block kernel, one launch per
    block) or "dense" (plain PyTorch). Raises ``NotImplementedError`` where
    the JAX package would take a Pallas kernel the port has not ported."""
    D = cfg.hidden_units
    if FB.fused_block_supported(cfg, L, backend):
        if L > FB.wholeseq_max_l(D):
            raise NotImplementedError(
                f"L={L} > wholeseq_max_l({D})={FB.wholeseq_max_l(D)} takes "
                "the chunked fused kernels (ops/fused_block.py::"
                "_fwd_pre_kernel_chunk, _fwd_attn_kernel_chunk, "
                "_fwd_post_kernel_chunk), not ported yet: ROADMAP Queue 2")
        return "fused"
    if backend == "cuda" and cfg.use_flash_attention and 256 <= L \
            and L % 128 == 0:
        raise NotImplementedError(
            "this shape takes the standalone HSTU attention kernels "
            "(ops/hstu_attention.py::_fwd_kernel / _fwd_kernel_chunk) in the "
            "JAX package, not ported yet: ROADMAP Queue 2")
    return "dense"


def encode(params: Mapping, fused_emb: torch.Tensor, seq_ids: torch.Tensor,
           token_type: torch.Tensor, pos_table: torch.Tensor,
           cfg: ModelConfig, train: bool = False, mesh=None,
           route: Optional[str] = None) -> torch.Tensor:
    """fused_emb [B, L, D] (output of embedding.fuse_sequence) -> [B, L, D].
    Inference only. ``route`` overrides :func:`block_route`: "fused" on CPU
    tensors runs the plain version of the fused kernel (the card's
    arithmetic, for checks); by default the route follows the device."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh, pipeline and ring encoder branches are not ported: "
            "ROADMAP Queue 1, Multi-device layer")
    if train:
        raise NotImplementedError(
            "the training forward (dropout, fused_block _bwd_kernel) is not "
            "ported yet: ROADMAP Queue 1, Training path")
    if cfg.block_type != "hstu":
        raise NotImplementedError(
            "softmax-MHA blocks (the baseline/baseline_o1 parity presets, "
            "ops/flash_attention.py kernels) are not ported yet: ROADMAP "
            "Queue 1, Parity presets")
    dtype = torch_dtype(cfg.dtype)
    B, L, D = fused_emb.shape
    x = fused_emb.to(dtype) * torch.tensor(D ** 0.5, dtype=dtype)
    x = x + positional_take(pos_table, seq_ids).to(dtype)
    blocks = params["blocks"]

    if route is None:
        route = block_route(cfg, L, fused_emb.device.type)
    if route == "fused":
        ops = FB.block_operands(blocks, dtype)   # every block's, at once
        for i in range(cfg.num_blocks):
            x = FB.fused_hstu_block(x, block_params(ops, i), token_type,
                                    cfg.num_heads)
        return layernorm(_cast_ln(params["last_ln"], dtype), x)

    mask = attention_mask(seq_ids, token_type)
    for i in range(cfg.num_blocks):
        bp = block_params(blocks, i)
        h = layernorm(_cast_ln(bp["attn_ln"], dtype), x)
        x = x + hstu_block(bp["hstu"], h, mask, cfg.num_heads)
        h = layernorm(_cast_ln(bp["ffn_ln"], dtype), x)
        x = x + ffn(bp["ffn"], h)
    return layernorm(_cast_ln(params["last_ln"], dtype), x)
