"""RQ-VAE semantic-ID tokenizer and generative-retrieval head.

Counterpart of ``tencent_recommendation_2025_tpu/models/rqvae.py``: plain
functions on tensors over nested parameter dicts (the JAX pytree's names,
its ``enc`` / ``dec`` / ``heads`` lists kept as lists).

- an MLP encoder maps item representations to a latent, quantized by L
  levels of residual nearest-codebook lookup (``argmin ||c||^2 - 2 r.c``,
  the JAX formula, so that the codes agree); an MLP decoder reconstructs
  the input through the straight-through estimator;
- codebooks move by an EMA (K-means style) update, never by gradient;
- a per-level linear head predicts the codes of a query's positive item
  autoregressively; candidates score by their code's log-likelihood, and
  beam search decodes codes without a corpus.

The JAX package has no Pallas kernel here: every function is plain torch.
Top-k selections follow ``jax.lax.top_k``'s order (ties by the lower index,
:func:`top_k`), so that items sharing a semantic id rank as there.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from ..config import RQVAEConfig
from .embedding import linear, linear_init

#: elements of one row chunk of :func:`top_k`'s masks
_TOPK_CHUNK_ELEMS = 1 << 27


def tree_map(fn, tree):
    """``fn`` on every tensor of a nest of dicts and lists."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values by the lower index first
    (``torch.topk`` promises no order among ties). The k-th value's
    threshold selects every larger value and the first equal ones; rows go
    in chunks, so the masks stay small."""
    if x.dim() > 2:
        v, i = top_k(x.reshape(-1, x.shape[-1]), k)
        return v.reshape(*x.shape[:-1], k), i.reshape(*x.shape[:-1], k)
    rows = max(1, _TOPK_CHUNK_ELEMS // max(x.shape[-1], 1))
    if x.shape[0] > rows:
        parts = [top_k(x[s:s + rows], k) for s in range(0, x.shape[0], rows)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    kth = torch.topk(x, k, dim=-1).values[:, -1:]
    above = x > kth
    equal = x == kth
    need = k - above.sum(-1, keepdim=True)
    keep = above | (equal & (torch.cumsum(equal, -1, dtype=torch.int32)
                             <= need))
    idx = keep.nonzero()[:, 1].reshape(x.shape[0], k)     # ascending index
    vals, order = torch.sort(torch.gather(x, 1, idx), dim=-1,
                             descending=True, stable=True)
    return vals, torch.gather(idx, 1, order)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def init_rqvae_params(gen: torch.Generator, cfg: RQVAEConfig,
                      input_dim: int, device="cpu") -> Dict:
    """Parameters with the JAX init's shapes and distributions, drawn on
    the CPU from ``gen`` (the numbers differ from the JAX package's)."""
    dims = [input_dim, *cfg.enc_hidden, cfg.code_dim]
    enc = [linear_init(gen, dims[i], dims[i + 1])
           for i in range(len(dims) - 1)]
    ddims = [cfg.code_dim, *reversed(cfg.enc_hidden), input_dim]
    dec = [linear_init(gen, ddims[i], ddims[i + 1])
           for i in range(len(ddims) - 1)]
    codebooks = torch.randn((cfg.num_levels, cfg.codebook_size,
                             cfg.code_dim), generator=gen) * 0.1
    params = {"enc": enc, "dec": dec, "codebooks": codebooks,
              # EMA statistics for codebook updates
              "ema_counts": torch.ones((cfg.num_levels, cfg.codebook_size)),
              "ema_sums": codebooks.clone()}
    return tree_map(lambda t: t.to(device), params)


def _mlp(layers: List[Mapping], x: torch.Tensor, final_act: bool = False):
    for i, p in enumerate(layers):
        x = linear(p, x)
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def nearest_code(residual: torch.Tensor, codebook: torch.Tensor
                 ) -> torch.Tensor:
    """argmin_j ||r - c_j||^2 over [N, d] residuals and [C, d] codes via one
    matmul: ||r||^2 is constant in j, so argmin(||c||^2 - 2 r.c)."""
    dots = residual @ codebook.T                     # [N, C]
    c2 = torch.sum(codebook ** 2, dim=-1)            # [C]
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=-1)


def quantize(params: Mapping, z: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual quantization. z [N, d] -> (z_q [N, d], codes [N, L])."""
    codebooks = params["codebooks"]
    residual = z
    z_q = torch.zeros_like(z)
    codes = []
    for l in range(codebooks.shape[0]):
        idx = nearest_code(residual, codebooks[l])
        c = codebooks[l][idx]
        codes.append(idx)
        z_q = z_q + c
        residual = residual - c
    return z_q, torch.stack(codes, dim=-1)


def rqvae_forward(params: Mapping, x: torch.Tensor, cfg: RQVAEConfig):
    """Returns (recon, z, z_q, codes, losses dict)."""
    z = _mlp(params["enc"], x)
    with torch.no_grad():
        z_q, codes = quantize(params, z)
    # straight-through: the decoder sees z + sg(z_q - z)
    z_st = z + (z_q - z).detach()
    recon = _mlp(params["dec"], z_st)
    recon_loss = torch.mean(torch.sum((recon - x) ** 2, dim=-1))
    commit = torch.mean(torch.sum((z - z_q.detach()) ** 2, dim=-1))
    loss = recon_loss + cfg.commit_beta * commit
    return recon, z, z_q, codes, {"loss": loss, "recon": recon_loss,
                                  "commit": commit}


@torch.no_grad()
def ema_codebook_update(params: Dict, z: torch.Tensor, codes: torch.Tensor,
                        cfg: RQVAEConfig) -> Dict:
    """K-means-style EMA codebook update (no gradient through codebooks)."""
    decay = cfg.ema_decay
    codebooks = params["codebooks"]
    counts, sums = params["ema_counts"], params["ema_sums"]
    residual = z
    new_cb, new_counts, new_sums = [], [], []
    for l in range(cfg.num_levels):
        onehot = Fn.one_hot(codes[:, l], cfg.codebook_size).to(z.dtype)
        cnt = onehot.sum(dim=0)                       # [C]
        s = onehot.T @ residual                       # [C, d]
        c_new = decay * counts[l] + (1 - decay) * cnt
        s_new = decay * sums[l] + (1 - decay) * s
        new_cb.append(s_new / torch.clamp_min(c_new[:, None], 1e-5))
        new_counts.append(c_new)
        new_sums.append(s_new)
        residual = residual - codebooks[l][codes[:, l]]
    return {**params, "codebooks": torch.stack(new_cb),
            "ema_counts": torch.stack(new_counts),
            "ema_sums": torch.stack(new_sums)}


@torch.no_grad()
def tokenize(params: Mapping, x: torch.Tensor) -> torch.Tensor:
    """Item representations [N, input_dim] -> semantic ids [N, L]."""
    return quantize(params, _mlp(params["enc"], x))[1]


# ---------------------------------------------------------------------------
# Generative-retrieval decode head
# ---------------------------------------------------------------------------

def init_genret_params(gen: torch.Generator, cfg: RQVAEConfig,
                       query_dim: int, device="cpu") -> Dict:
    """Per-level classifiers over codebook entries, conditioned on the query
    vector and the (teacher-forced) embeddings of previous-level codes."""
    heads = [linear_init(gen, query_dim + l * cfg.code_dim,
                         cfg.codebook_size) for l in range(cfg.num_levels)]
    return tree_map(lambda t: t.to(device), {"heads": heads})


def genret_logits(gparams: Mapping, rq_params: Mapping, query: torch.Tensor,
                  codes: torch.Tensor, cfg: RQVAEConfig) -> List:
    """Teacher-forced level logits. query [B, Dq], codes [B, L] ->
    list of [B, C] logits per level."""
    codebooks = rq_params["codebooks"]
    out = []
    ctx = query
    for l in range(cfg.num_levels):
        out.append(linear(gparams["heads"][l], ctx))
        ctx = torch.cat([ctx, codebooks[l][codes[:, l]]], dim=-1)
    return out


def genret_loss(gparams: Mapping, rq_params: Mapping, query: torch.Tensor,
                codes: torch.Tensor, cfg: RQVAEConfig) -> torch.Tensor:
    logits = genret_logits(gparams, rq_params, query, codes, cfg)
    loss = 0.0
    for l, lg in enumerate(logits):
        lp = torch.log_softmax(lg, dim=-1)
        loss = loss - torch.mean(torch.gather(lp, 1, codes[:, l:l + 1]))
    return loss / cfg.num_levels


@torch.no_grad()
def genret_score_items(gparams: Mapping, rq_params: Mapping,
                       query: torch.Tensor, item_codes: torch.Tensor,
                       cfg: RQVAEConfig) -> torch.Tensor:
    """Fast approximate scoring: log-likelihood of each item's semantic id
    with the level context following the ARGMAX code (exact only for items
    on the dominant beam). query [B, Dq], item_codes [N, L] -> [B, N]."""
    codebooks = rq_params["codebooks"]
    scores = torch.zeros((query.shape[0], item_codes.shape[0]),
                         dtype=torch.float32, device=query.device)
    ctx = query
    for l in range(cfg.num_levels):
        logits = linear(gparams["heads"][l], ctx)          # [B, C]
        scores = scores + torch.log_softmax(logits, dim=-1)[
            :, item_codes[:, l]]
        if l + 1 < cfg.num_levels:
            best = torch.argmax(logits, dim=-1)
            ctx = torch.cat([ctx, codebooks[l][best]], dim=-1)
    return scores


@torch.no_grad()
def genret_score_items_exact(gparams: Mapping, rq_params: Mapping,
                             query: torch.Tensor, item_codes: torch.Tensor,
                             cfg: RQVAEConfig,
                             chunk_n: int = 4096) -> torch.Tensor:
    """EXACT autoregressive log-likelihood of every candidate's semantic id:
    each item's level-l context carries the item's OWN previous codes
    (teacher forcing), not the argmax beam.

    The level head is linear, so its logits split into a query part and a
    prev-codes part: logits[b, n] = query_b @ Wq + prev_n @ Wp + bias, two
    small matmuls per level; only the [B, n_chunk, C] log-softmax
    materializes, chunked over candidates.
    query [B, Dq], item_codes [N, L] -> [B, N].
    """
    codebooks = rq_params["codebooks"]
    B, Dq = query.shape
    out = []
    for s in range(0, item_codes.shape[0], chunk_n):
        codes = item_codes[s:s + chunk_n]                  # [n, L]
        n = codes.shape[0]
        scores = torch.zeros((B, n), dtype=torch.float32,
                             device=query.device)
        prev_feat = torch.zeros((n, 0), dtype=query.dtype,
                                device=query.device)
        for l in range(cfg.num_levels):
            w = gparams["heads"][l]["w"]                   # [Dq + l*d, C]
            bq = query @ w[:Dq] + gparams["heads"][l]["b"]  # [B, C]
            bp = prev_feat @ w[Dq:]                        # [n, C]
            lp = torch.log_softmax(bq[:, None, :] + bp[None, :, :], dim=-1)
            scores = scores + torch.gather(
                lp, 2, codes[None, :, l:l + 1].expand(B, n, 1))[..., 0]
            del lp
            if l + 1 < cfg.num_levels:
                prev_feat = torch.cat([prev_feat, codebooks[l][codes[:, l]]],
                                      dim=-1)
        out.append(scores)
    return torch.cat(out, dim=1)


@torch.no_grad()
def genret_beam_decode(gparams: Mapping, rq_params: Mapping,
                       query: torch.Tensor, cfg: RQVAEConfig,
                       beam_width: int = 10
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decode over level-wise codes: generative retrieval with
    no candidate corpus at decode time.

    query [B, Dq] -> (codes [B, W, L], log-prob scores [B, W]), beams sorted
    best-first: level 0 takes the top-W codes, each later level expands W
    beams x C codes and re-selects the top W.
    """
    codebooks = rq_params["codebooks"]
    B, Dq = query.shape
    C = cfg.codebook_size
    W = min(beam_width, C)

    lp0 = torch.log_softmax(linear(gparams["heads"][0], query), dim=-1)
    scores, code0 = top_k(lp0, W)                          # [B, W]
    codes = code0[..., None]                               # [B, W, 1]
    ctx = torch.cat([query[:, None].expand(B, W, Dq), codebooks[0][code0]],
                    dim=-1)                                # [B, W, Dq+d]
    for l in range(1, cfg.num_levels):
        lp = torch.log_softmax(linear(gparams["heads"][l], ctx), dim=-1)
        cand = scores[..., None] + lp                      # [B, W, C]
        scores, flat = top_k(cand.reshape(B, W * C), W)
        parent = flat // C                                 # [B, W]
        code = flat % C
        codes = torch.cat([
            torch.gather(codes, 1,
                         parent[..., None].expand(B, W, codes.shape[2])),
            code[..., None]], dim=-1)
        if l + 1 < cfg.num_levels:
            ctx = torch.cat([
                torch.gather(ctx, 1,
                             parent[..., None].expand(B, W, ctx.shape[2])),
                codebooks[l][code]], dim=-1)
    return codes, scores


def beam_retrieve(beam_codes, beam_scores, item_codes, k: int = 10):
    """Map decoded beams back to candidate items (host-side): items whose
    semantic id equals a beam inherit that beam's score (ties broken by
    item order); returns [B, k] candidate indices, -1 where beams cover
    fewer than k items. beam_codes [B, W, L] / item_codes [N, L] numpy."""
    beam_codes = np.asarray(beam_codes)
    item_codes = np.asarray(item_codes)
    index = {}
    for n, c in enumerate(map(tuple, item_codes.tolist())):
        index.setdefault(c, []).append(n)
    B, W, L = beam_codes.shape
    out = np.full((B, k), -1, np.int64)
    for b in range(B):
        hits = []
        for w in range(W):
            for n in index.get(tuple(beam_codes[b, w].tolist()), []):
                hits.append(n)
                if len(hits) >= k:
                    break
            if len(hits) >= k:
                break
        out[b, :len(hits)] = hits[:k]
    return out
