"""The yardstick's arithmetic: peaks of the card, operations and bytes of
the work a cell's shapes need, and the analytic step count behind ``mfu``.

Frozen copies, so that a change to the program cannot move them: the
fused block's bounds are ``chip_smoke.py``'s ``fused_block_bound`` and
``fused_block_bwd_bound`` (PERF.md section 6 rows 1-2); the step count is
``train/trainer.py``'s ``analytic_step_flops`` (with its
``tower_dedup_capacity``) as it stood when the benchmark was written.
"""

from __future__ import annotations

import math

#: an H100 SXM's published dense bf16 rate and memory rate (NVIDIA's data
#: sheet), at its full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

#: the user tokens a row holds (the towers' K gathered positions)
USER_TOKENS = 2


def bound_s(flops: float, nbytes: float) -> float:
    """Least seconds of a piece of work on one card."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def swiglu_hidden(D: int, mult: float = 4.0, multiple_of: int = 256) -> int:
    h = int(2 * (D * mult) / 3)
    return multiple_of * (-(-h // multiple_of))


def _param_bytes(D, H, F, NB, elem):
    weights = (D * 4 * D + D * D + D * 2 * F + F * D) * elem
    return weights + (6 * D + 4 * D + D + H * NB) * 4


def fused_block_fwd(B, L, D, H, F, elem=2, train=True, NB=128):
    """(flops, bytes) of one fused block forward: the projection, q.k^T
    and a.v causal (L(L+1)/2 key pairs a query row), Wo, W13, W2; inputs
    read once, outputs written once (training also writes av)."""
    flops = (2 * B * L * D * 4 * D + 2 * B * D * L * (L + 1)
             + 2 * B * L * D * D + 2 * B * L * D * 2 * F + 2 * B * L * F * D)
    acts = (3 if train else 2) * B * L * D * elem
    return flops, acts + B * L * 4 + _param_bytes(D, H, F, NB, elem)


def fused_block_bwd(B, L, D, H, F, elem=2, NB=128):
    """(flops, bytes) of one fused block backward: the recompute, the four
    causal attention products, each weight product twice; x, av and dout
    in, dx out, the mask, the weights in and their f32 gradients out."""
    M = B * L
    causal = B * D * L * (L + 1)
    flops = (2 * M * D * 4 * D + causal + 2 * M * D * D + 2 * M * D * 2 * F
             + 4 * causal
             + 2 * (2 * M * D * 4 * D + 2 * M * D * D + 2 * M * D * 2 * F
                    + 2 * M * F * D))
    grads = (D * 4 * D + D * D + D * 2 * F + F * D + 6 * D + 5 * D
             + H * NB) * 4
    nbytes = 4 * M * D * elem + M * 4 + _param_bytes(D, H, F, NB, elem) \
        + grads
    return flops, nbytes


def tower_dims(D: int, mm_dims) -> tuple:
    """(user tower input, item tower input) widths of the TencentGR
    schema: 4 user sparse + 4 user array features, 14 item sparse."""
    return D * (4 + 1 + 4), D * (14 + 1) + D * len(mm_dims)


#: the sampled softmax's shared negatives (the presets' count)
N_NEG = 128


def dedup_capacity(B, L, loss_type, cap_frac, itemnum):
    """The tower dedup's rows in one process."""
    n = B * L + B
    n += N_NEG if loss_type == "sampled_softmax" else B * L
    cap = min(int(math.ceil(n * cap_frac)), itemnum + 1)
    return max(16, -(-cap // 8) * 8)


def step_flops(cfg, B: int, dedup: bool) -> float:
    """Matmul and attention operations of one training step of the global
    batch B (forward and twice it backward), elementwise work left out;
    ``dedup``: the towers over the dedup's rows (one process)."""
    m, t = cfg["model"], cfg["train"]
    L, D, H = m["maxlen"] + 1, m["hidden_units"], m["num_heads"]
    M = B * L
    proj = 2 * M * D * 4 * D + 2 * M * D * D
    F = swiglu_hidden(D, m["ffn_hidden_mult"], m["ffn_multiple_of"])
    ffn = 2 * M * D * 2 * F + 2 * M * F * D
    attn = B * L * (L + 1) / 2 * H * 4 * (D // H)
    blocks = m["num_blocks"] * (proj + ffn + attn)
    mm_dims = [32 for _ in cfg["data"]["mm_emb_ids"]]
    userdim, itemdim = tower_dims(D, mm_dims)
    mm = sum(mm_dims)
    item_tok = M + B
    item_tok += N_NEG if t["loss_type"] == "sampled_softmax" else M
    if dedup:
        item_tok = dedup_capacity(B, L, t["loss_type"],
                                  t["tower_dedup_cap_frac"],
                                  cfg["data"]["itemnum"])
    towers = 2 * item_tok * (itemdim + mm) * D \
        + 2 * B * (USER_TOKENS + 1) * userdim * D
    return 3.0 * (blocks + towers)


def predict_flops(cfg, B: int) -> float:
    """Operations of one predict batch: the forward of the blocks and of
    the towers at every position (no dedup when serving)."""
    m = cfg["model"]
    L, D, H = m["maxlen"] + 1, m["hidden_units"], m["num_heads"]
    M = B * L
    F = swiglu_hidden(D, m["ffn_hidden_mult"], m["ffn_multiple_of"])
    blocks = m["num_blocks"] * (2 * M * D * 4 * D + 2 * M * D * D
                                + 2 * M * D * 2 * F + 2 * M * F * D
                                + B * L * (L + 1) / 2 * H * 4 * (D // H))
    mm_dims = [32 for _ in cfg["data"]["mm_emb_ids"]]
    userdim, itemdim = tower_dims(D, mm_dims)
    towers = 2 * M * (itemdim + sum(mm_dims)) * D \
        + 2 * B * (USER_TOKENS + 1) * userdim * D
    return blocks + towers


def mips_bound_s(Q: int, N: int, D: int) -> float:
    """Least seconds of an exact top-k over an f32 corpus: the corpus read
    once, or the 2QND scoring operations at the bf16 peak."""
    return bound_s(2.0 * Q * N * D, 4.0 * N * D)
