"""Sequence encoder: fused embeddings -> N blocks -> final LayerNorm.

Counterpart of ``tencent_recommendation_2025_tpu/models/encoder.py``:
sqrt(D) scaling, learned absolute positions 1..L zeroed on padding ids,
embedding dropout in training, the causal ∧ key-padding mask, final
LayerNorm(eps=1e-8). Blocks: pre-norm HSTU with a SwiGLU or ReLU FFN, or
softmax MHA (the parity presets) with pre-LN (``norm_first``) or the
reference's post-LN wiring.

Routing mirrors the JAX package's. Where it takes a Pallas kernel on a TPU,
the port takes its CUDA kernel on the card (the fused block in its
whole-sequence or chunked variant, ``ops/fused_block``; the standalone HSTU
attention, whole-sequence or chunked, ``ops/hstu_attention``; flash MHA,
``ops/flash_attention``; on a ``seq`` mesh, the per-shard fused blocks and
ring pair kernels of ``parallel/ring_fused``). Where it runs plain XLA, the
port runs plain PyTorch on any device (on a ``seq`` mesh the unfused ring,
``parallel/ring_attention``). On the CPU every path is plain. On a
``model`` mesh (tensor parallelism) the fused kernels are off, as the JAX
package's ``mesh_trivial`` turns them off, and every block runs
tensor-parallel: its projections split over the model shards, each
shard's attention core on its own heads (``models/hstu.py``,
``models/attention.py``, :func:`ffn`). On a ``pipe`` mesh the blocks run
as a GPipe schedule over the stages (``parallel/pipeline_parallel``), each
microbatch on the route the single device takes at its shape.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as Fn
import torch.utils.checkpoint

from ..config import ModelConfig
from ..ops import flash_attention as FA
from ..ops import fused_block as FB
from ..ops import hstu_attention as HA
from .attention import init_mha_params, mha
from .embedding import layernorm, layernorm_init, linear_init, torch_dtype
from .hstu import (dropout, dropout_shards, hstu_attend, hstu_block,
                   hstu_output, hstu_project, init_hstu_params)
from ..parallel import ring_attention as RA
from ..parallel.mesh import (check_mesh, model_size, pipe_blocks,
                             pipe_size, seq_size)
from ..parallel.pipeline_parallel import shard_schedule
from ..parallel.partition import ModelShards, column_parallel, row_parallel
from ..parallel.ring_fused import ring_fused_encode


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


def ffn(params: Mapping, x: torch.Tensor, rate: float = 0.0,
        train: bool = False,
        gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """SwiGLU (packed ``w13``, ``w2``) or ReLU (``fc1``, ``fc2``). On a model
    mesh the input weight is column-split (each shard its columns of w1
    and w3, or of fc1) and the output weight row-split: the hidden takes
    its columns of the whole-width dropout draw, the partial products sum
    over the model group before fc2's replicated bias."""
    dtype = x.dtype
    w_in = params["w13"] if "w13" in params else params["fc1"]["w"]
    if isinstance(w_in, ModelShards):
        if "w13" in params:
            h = column_parallel(x, w_in.to(dtype)).map(_swiglu)
            h = dropout_shards(h, rate, train, gen)
            return row_parallel(h, params["w2"], dtype)
        h = column_parallel(x, w_in.to(dtype),
                            params["fc1"]["b"].to(dtype))
        h = dropout_shards(h, rate, train, gen).map(Fn.relu)
        h = row_parallel(h, params["fc2"]["w"], dtype) \
            + params["fc2"]["b"].to(dtype)
        return dropout(h, rate, train, gen)
    if "w13" in params:
        h = dropout(_swiglu(x @ params["w13"].to(dtype)), rate, train, gen)
        return h @ params["w2"].to(dtype)
    h = x @ params["fc1"]["w"].to(dtype) + params["fc1"]["b"].to(dtype)
    h = Fn.relu(dropout(h, rate, train, gen))
    h = h @ params["fc2"]["w"].to(dtype) + params["fc2"]["b"].to(dtype)
    return dropout(h, rate, train, gen)


def _swiglu(x13: torch.Tensor) -> torch.Tensor:
    x1, x3 = torch.chunk(x13, 2, dim=-1)
    return Fn.silu(x1) * x3


def init_block_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """One block's parameters; ``reference_init`` zeroes its LN scales, as
    the reference's init zeroes every 1-D parameter."""
    ln_scale = 0.0 if cfg.reference_init else 1.0
    p = {"attn_ln": layernorm_init(cfg.hidden_units, ln_scale),
         "ffn_ln": layernorm_init(cfg.hidden_units, ln_scale),
         "ffn": init_ffn_params(gen, cfg)}
    if cfg.block_type == "hstu":
        p["hstu"] = init_hstu_params(gen, cfg.hidden_units, cfg.num_heads,
                                     cfg.hstu_rel_pos_buckets)
    else:
        p["attn"] = init_mha_params(gen, cfg.hidden_units)
    return p


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


class _PositionalTake(torch.autograd.Function):
    """Positions 1..L zeroed on padding ids, with the JAX package's
    scatter-free backward: position l always reads row l + 1 (or the zero
    row 0), so the table gradient is the batch sum of the valid positions'
    cotangents written at rows 1..L, and row 0 gets none."""

    @staticmethod
    def forward(ctx, pos_table, seq_ids):
        L = seq_ids.shape[1]
        valid = seq_ids != 0
        poss = torch.arange(1, L + 1, device=seq_ids.device)[None, :] * valid
        ctx.save_for_backward(valid)
        ctx.rows = pos_table.shape[0]
        return pos_table[poss]

    @staticmethod
    def backward(ctx, cot):
        (valid,) = ctx.saved_tensors
        L, D = cot.shape[1], cot.shape[2]
        summed = (cot.float() * valid[..., None]).sum(0)        # [L, D]
        dtable = cot.new_zeros((ctx.rows, D), dtype=torch.float32)
        dtable[1:L + 1] = summed
        return dtable, None


def positional_take(pos_table: torch.Tensor,
                    seq_ids: torch.Tensor) -> torch.Tensor:
    """Positions 1..L, zeroed (row 0) on padding ids."""
    return _PositionalTake.apply(pos_table, seq_ids)


def attention_mask(seq_ids: torch.Tensor,
                   token_type: torch.Tensor) -> torch.Tensor:
    """[B, L, L] bool: causal (tril) ∧ key-not-padding."""
    L = seq_ids.shape[1]
    pos = torch.arange(L, device=seq_ids.device)
    causal = (pos[None, :] <= pos[:, None])[None]
    return causal & (token_type != 0)[:, None, :]


def _cast_ln(p, dtype):
    return {"scale": p["scale"].to(dtype), "bias": p["bias"].to(dtype)}


def block_route(cfg: ModelConfig, L: int, backend: str, mesh=None) -> str:
    """How the encoder runs its blocks at length L on ``backend`` ("cuda" or
    "cpu"), as the JAX package chooses between its fused block and
    ``make_attention_cores`` (``"cuda"`` in place of ``"tpu"``). On a mesh
    whose ``seq`` axis is S > 1:

    - "ring_fused": the per-shard fused blocks and the ring pair kernels
      where ``FB.ring_fused_supported`` passes (JAX encoder l.340-356);
    - "ring": otherwise, the blocks with the unfused ring attention cores
      (JAX l.171-185).

    Without one:

    - "fused": the fused HSTU block kernels, whole-sequence or chunked
      variant by ``FB.chunked``;
    - "core": the blocks' attention inner loop in a kernel: the standalone
      HSTU attention kernels for an HSTU block the fused gate refuses (a
      ReLU FFN, say) at 256 <= L, L % 128 == 0 (past ``HA._use_long``,
      where the JAX package takes its chunked kernels, the same kernels
      launch under the chunked wrappers' own counters); the flash MHA
      kernels for an MHA block there with L * max(D, 64) <= 1024 * 64;
    - "dense": plain PyTorch (MHA beyond the flash gate, as in the JAX
      package).

    On a mesh whose ``model`` axis is M > 1 the fused kernels are off, as
    the JAX package's ``mesh_trivial`` turns them off: "core" or "dense" by
    the gates above, "ring" with a seq axis too; each shard's attention
    core then runs its H / M heads (all H where M does not divide H).

    The HSTU kernels take any head dim; flash MHA's gate caps D, and so
    its heads, at 256."""
    S, M = seq_size(mesh), model_size(mesh)
    if S > 1:
        return "ring_fused" if M == 1 and FB.ring_fused_supported(
            cfg, L, S, backend) else "ring"
    if M == 1 and FB.fused_block_supported(cfg, L, backend):
        return "fused"
    if backend != "cuda" or not cfg.use_flash_attention \
            or not (256 <= L and L % 128 == 0):
        return "dense"
    D = cfg.hidden_units
    if cfg.block_type == "hstu":
        return "core"
    if L * max(D, 64) <= FA.MAX_FLASH_L * 64:
        return "core"
    return "dense"


def attention_core(cfg: ModelConfig, token_type: torch.Tensor, mesh=None,
                   seq_len: Optional[int] = None,
                   heads: Optional[int] = None):
    """The attention inner loop of the "core" route on head-packed
    [B, L, heads * hd] q, k, v: flash MHA for an MHA block, ``core(q, k,
    v)``; the standalone HSTU attention for an HSTU block, ``core(q, k, v,
    rab)``. Keys with token_type 0 are masked; HSTU divides by the padded
    L. ``heads``: the heads of one call (default ``cfg.num_heads``; a model
    shard's H / M). With a ``seq`` mesh, the unfused ring's cores
    (``token_type`` then this process's shard on a process mesh, and
    ``seq_len`` the whole sequence's L)."""
    valid = token_type != 0
    L = token_type.shape[1] if seq_len is None else seq_len
    H = cfg.num_heads if heads is None else heads
    if seq_size(mesh) > 1:
        if cfg.block_type == "hstu":
            hd = cfg.hidden_units // cfg.num_heads
            return lambda q, k, v, rab: RA.ring_hstu_attention(
                mesh, q, k, v, valid, rab, H, hd ** -0.5, L)
        return lambda q, k, v: RA.ring_attention(mesh, q, k, v, valid, H)
    if cfg.block_type == "hstu":
        return lambda q, k, v, rab: HA.hstu_attention_packed(
            q, k, v, valid, rab, L, H)
    return lambda q, k, v: FA.flash_mha_packed(q, k, v, valid, H)


def encode(params: Mapping, fused_emb: torch.Tensor, seq_ids: torch.Tensor,
           token_type: torch.Tensor, pos_table: torch.Tensor,
           cfg: ModelConfig, train: bool = False,
           gen: Optional[torch.Generator] = None, mesh=None,
           route: Optional[str] = None) -> torch.Tensor:
    """fused_emb [B, L, D] (output of embedding.fuse_sequence) -> [B, L, D].

    ``train`` with ``cfg.dropout_rate`` > 0 and a generator ``gen`` (on the
    activations' device) applies dropout: on the embeddings, and inside each
    block. ``route`` overrides :func:`block_route`: "fused" or "core" on
    CPU tensors runs the plain versions of those kernels (the card's
    arithmetic, for checks); by default the route follows the device.

    The fused route differentiates through :class:`ops.fused_block.
    FusedBlockFn` whenever autograd records (its backward is the backward
    kernel, which recomputes from x and av itself, so no checkpoint wraps
    it); under ``torch.no_grad`` it takes the inference kernel with every
    block's operands built once. The dense and core routes checkpoint each
    block in training when ``cfg.remat_blocks``, as the JAX package's remat
    does: an MHA block's flash forward then runs again in the backward, an
    HSTU block's attention core does not (its output is kept).

    A ``mesh`` (``parallel/mesh``) whose ``seq`` axis is S > 1 takes the
    ring routes. Every process computes the embeddings of its whole rows;
    the blocks run on its shards of L (all S on a local mesh), and the
    output gathers along L before the final LayerNorm. On a mesh whose
    ``model`` axis is M > 1 the blocks' parameters come split
    (``parallel.partition.tp_view``) and every block is tensor-parallel
    (``models/hstu.py``, ``models/attention.py``, :func:`ffn`).

    On a mesh whose ``pipe`` axis is P > 1 the blocks run as a GPipe
    schedule of the mesh's ``pp_microbatches`` microbatches a data column
    (:func:`_pipe_blocks`), and the final LayerNorm on the rows' own
    stage. ``fused_emb`` holds the rows of one data shard: a
    process mesh's own (its stage's ``params["blocks"]`` are its NB / P
    blocks), or one shard's on a local mesh (whole blocks), which the
    trainer calls once a shard."""
    if mesh is not None:
        check_mesh(mesh, "the encoder")
    dtype = torch_dtype(cfg.dtype)
    B, L, D = fused_emb.shape
    x = fused_emb.to(dtype) * torch.tensor(D ** 0.5, dtype=dtype)
    x = x + positional_take(pos_table, seq_ids).to(dtype)
    rate = cfg.dropout_rate
    use_dropout = train and rate > 0.0 and gen is not None
    x = dropout(x, rate, use_dropout, gen)
    blocks = params["blocks"]

    if route is None:
        route = block_route(cfg, L, fused_emb.device.type, mesh)
    if (route in ("ring_fused", "ring")) != (seq_size(mesh) > 1):
        raise ValueError(f"route {route!r} with a mesh of seq "
                         f"{seq_size(mesh)}: the ring routes, and only they, "
                         "take a seq mesh")
    if pipe_size(mesh) > 1:
        x = _pipe_blocks(blocks, x, token_type, cfg, use_dropout, gen, train,
                         route, mesh)
    elif route == "ring_fused":
        # every seq rank holds the whole rows; the blocks run on its shards
        seeds = torch.randint(0, 2 ** 31 - 1, (cfg.num_blocks,),
                              generator=gen, device=gen.device) \
            if use_dropout else torch.zeros(cfg.num_blocks,
                                            dtype=torch.int64)
        x = mesh.gather_seq(ring_fused_encode(
            mesh, blocks, mesh.seq_shards(x), mesh.seq_shards(token_type),
            seeds, cfg, use_dropout, L))
    elif route == "ring" and mesh.process:
        # this process's shard through the blocks, the whole rows after
        (x,), (tt_run,) = mesh.seq_shards(x), mesh.seq_shards(token_type)
        x = mesh.gather_seq([_blocks(params, x, seq_ids, tt_run, cfg,
                                     use_dropout, gen, train, route, mesh,
                                     L)])
    else:
        x = _blocks(params, x, seq_ids, token_type, cfg, use_dropout, gen,
                    train, route, mesh, L)
    return layernorm(_cast_ln(params["last_ln"], dtype), x)


def _pipe_blocks(blocks, x, token_type, cfg, use_dropout, gen, train, route,
                 mesh):
    """The block stack of one data shard's rows on a pipe mesh (before the
    final LayerNorm). The rows split into M / P contiguous microbatches,
    the layout ``parallel/pipeline_parallel`` names (the encoder is
    row-independent: a row's output does not depend on which microbatch
    holds it); each microbatch's ``x`` and ``token_type`` ride the conveyor
    together, and each stage runs its blocks on the route the single
    device takes at the microbatch's shape (the fused kernels where
    seq = model = 1 and the gate passes, as the JAX pp body does).

    Dropout: this shard draws one seed per (microbatch, block) from its own
    generator, and the seeds ride with the rows, so a mask depends on
    neither the stage that runs it nor the schedule, and no two
    microbatches (of this or another shard) share one. The fused kernel
    seeds each row by its index within the launch, the seed by microbatch:
    the JAX package folds the microbatch index into the block keys for the
    same reason (row r of every microbatch would draw one mask)."""
    P, NB, M = mesh.shape["pipe"], cfg.num_blocks, mesh.pp_microbatches
    rows = x.shape[0]
    m_loc = M // P
    if M % P or rows % m_loc:
        raise ValueError(f"{rows} rows of a data shard do not split into "
                         f"pp_microbatches={M} / pipe {P} microbatches")
    stage = pipe_blocks(NB, mesh)
    act = {"x": x, "tt": token_type}
    if use_dropout:
        seeds = torch.randint(0, 2 ** 31 - 1, (m_loc, NB), generator=gen,
                              device=gen.device)
        act["seed"] = seeds.repeat_interleave(rows // m_loc, dim=0)
    grad = torch.is_grad_enabled()
    fused = route == "fused"
    stacked = {"b": torch.arange(NB)[stage],
               "bp": FB.block_operands(blocks, x.dtype)
               if fused and not grad else blocks}
    zero = torch.zeros((), dtype=torch.int64)
    rate, H = cfg.dropout_rate, cfg.num_heads
    L = x.shape[1]

    def block_fn(a, sp):
        b = int(sp["b"])
        if fused and grad:
            seed = a["seed"][0, b] if use_dropout else zero
            xo = FB.fused_hstu_block_autograd(a["x"], sp["bp"], a["tt"],
                                              seed, H, rate, use_dropout)
        elif fused:
            xo = FB.fused_hstu_block(a["x"], sp["bp"], a["tt"], H)
        else:
            seed = int(a["seed"][0, b]) if use_dropout else None
            xo = _block_step(cfg, a["tt"], a["tt"], use_dropout, train,
                             route, None, L)(a["x"], sp["bp"], seed)
        return dict(a, x=xo)

    return shard_schedule(mesh, block_fn, stacked, act, M)["x"]


def _blocks(params, x, seq_ids, token_type, cfg, use_dropout, gen, train,
            route, mesh, seq_len):
    """The block stack on the "fused", "core", "dense" and "ring" routes
    (before the final LayerNorm); on a process mesh's "ring" route, over
    this process's shard of x and ``token_type`` (``seq_len`` the whole
    sequence's L)."""
    rate = cfg.dropout_rate
    blocks = params["blocks"]
    if route == "fused":
        if torch.is_grad_enabled():
            # per-block dropout seeds stay on the device (no host sync)
            seeds = torch.randint(0, 2 ** 31 - 1, (cfg.num_blocks,),
                                  generator=gen, device=gen.device) \
                if use_dropout else torch.zeros(cfg.num_blocks,
                                                dtype=torch.int64)
            for i in range(cfg.num_blocks):
                x = FB.fused_hstu_block_autograd(
                    x, block_params(blocks, i), token_type, seeds[i],
                    cfg.num_heads, rate, use_dropout)
        else:
            ops = FB.block_operands(blocks, x.dtype)  # every block's at once
            for i in range(cfg.num_blocks):
                x = FB.fused_hstu_block(x, block_params(ops, i), token_type,
                                        cfg.num_heads)
        return x

    # each block draws its masks from a generator of its own, rebuilt from
    # an int seed, so that a checkpointed block's recompute draws them again
    seeds = torch.randint(0, 2 ** 31 - 1, (cfg.num_blocks,), generator=gen,
                          device=gen.device).tolist() if use_dropout \
        else [None] * cfg.num_blocks
    if use_dropout and mesh is not None and mesh.process:
        # distinct masks on every (data, seq) shard, as the fused ring's.
        # A local mesh runs the whole sequence here and draws whole-sequence
        # masks, so on this route it stands in for a process mesh only with
        # dropout off (the fused ring folds the shard seeds on both)
        si, di = mesh.seq_indices[0], mesh.data_index
        seeds = [s + si * 1000003 + di * 10007 for s in seeds]
    step = _block_step(cfg, seq_ids, token_type, use_dropout, train, route,
                       mesh, seq_len)
    for i in range(cfg.num_blocks):
        x = step(x, block_params(blocks, i), seeds[i])
    return x


def _block_step(cfg, seq_ids, token_type, use_dropout, train, route, mesh,
                seq_len):
    """``step(x, block params, seed) -> x``: one block on the "core",
    "dense" and "ring" routes, with its attention core (or its dense mask)
    built here once for the blocks that share ``token_type``, and the
    checkpoints of ``cfg.remat_blocks``."""
    rate = cfg.dropout_rate
    H = cfg.num_heads
    M = model_size(mesh)
    dtype = torch_dtype(cfg.dtype)
    # a model shard's core runs its H / M heads, or all H where M does not
    # divide H (models/hstu.hstu_attend, models/attention._mha_tp)
    core = attention_core(cfg, token_type, mesh, seq_len,
                          heads=H // M if H % M == 0 else H) \
        if route in ("core", "ring") else None
    # the dense [B, L, L] mask only where no core runs; a core masks by
    # token_type itself
    mask = attention_mask(seq_ids, token_type) if core is None else None

    def ln(p, t):
        return layernorm(_cast_ln(p, dtype), t)

    def run_block(x, bp, seed):
        bg = _block_generator(seed, x.device)
        if cfg.block_type == "hstu":     # pre-norm by design
            x = x + hstu_block(bp["hstu"], ln(bp["attn_ln"], x), mask, H,
                               rate, use_dropout, bg, core=core)
            return x + ffn(bp["ffn"], ln(bp["ffn_ln"], x), rate, use_dropout,
                           bg)
        if cfg.norm_first:
            x = x + mha(bp["attn"], ln(bp["attn_ln"], x), mask, H, rate,
                        use_dropout, bg, core=core)
            return x + ffn(bp["ffn"], ln(bp["ffn_ln"], x), rate, use_dropout,
                           bg)
        # post-LN, the reference's default wiring
        x = ln(bp["attn_ln"], x + mha(bp["attn"], x, mask, H, rate,
                                      use_dropout, bg, core=core))
        return ln(bp["ffn_ln"], x + ffn(bp["ffn"], x, rate, use_dropout, bg))

    def hstu_pre(x, bp):
        return hstu_project(bp["hstu"], ln(bp["attn_ln"], x),
                            getattr(core, "fused_silu", False))

    def hstu_post(x, av, u, bp, seed):
        bg = _block_generator(seed, x.device)
        x = x + hstu_output(bp["hstu"], av, u, rate, use_dropout, bg)
        return x + ffn(bp["ffn"], ln(bp["ffn_ln"], x), rate, use_dropout, bg)

    remat = train and cfg.remat_blocks and torch.is_grad_enabled()
    # the JAX remat policy saves the HSTU core's output ("hstu_av"): the
    # checkpoints wrap the parts before and after the core, which runs once
    split = remat and core is not None and cfg.block_type == "hstu"
    ckpt = functools.partial(torch.utils.checkpoint.checkpoint,
                             use_reentrant=False)

    def step(x, bp, seed):
        if split:
            u, v, q, k = ckpt(hstu_pre, x, bp)
            av = hstu_attend(q, k, v, bp["hstu"]["rab"], None, H, core)
            return ckpt(hstu_post, x, av, u, bp, seed)
        if remat:
            return ckpt(run_block, x, bp, seed)
        return run_block(x, bp, seed)

    return step


def _block_generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A block's dropout generator, rebuilt from its int seed (None: no
    dropout)."""
    if seed is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
