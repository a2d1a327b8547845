"""RQ-VAE semantic-ID training and generative retrieval.

Counterpart of ``tencent_recommendation_2025_tpu/train/rqvae_trainer.py``.

Stage 1, the tokenizer: train the RQ-VAE (``models/rqvae.py``) on item
representations, then emit ``[num_items, L]`` semantic ids. Stage 2, the
generative-retrieval head: train per-level code classifiers on (query
vector, positive item's semantic id) pairs, so that retrieval decodes
code by code instead of scoring the whole corpus.

Adam is optax's (``torch.optim.Adam``: the same moments, bias correction
and eps). The codebooks and EMA statistics take no gradient, so optax moves
them by exactly 0 and they stay out of the optimizer here; the EMA update
follows each optimizer step, on that step's forward. A step is a function
of its batch's indices: the trainers draw them from a seeded generator on
the device, and a caller may replay any other draws.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import RQVAEConfig
from ..models import rqvae as R


@dataclasses.dataclass
class RQVAEResult:
    params: Dict
    semantic_ids: np.ndarray          # [num_items+1, L] (row 0 = padding)
    final_losses: Dict[str, float]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _index_gen(seed: int, dev: torch.device) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _linear_leaves(layers):
    return [p[k] for p in layers for k in ("w", "b")]


def rqvae_step(params: Dict, reprs: torch.Tensor, cfg: RQVAEConfig
               ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """One training step of the tokenizer as a function of the batch's
    item indices: Adam on the encoder and decoder, then the EMA codebook
    update on the step's ``z`` and codes. Updates ``params`` in place;
    returns the step's losses."""
    leaves = _linear_leaves(params["enc"]) + _linear_leaves(params["dec"])
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)

    def step(idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = reprs[idx]
        _, z, _, codes, losses = R.rqvae_forward(params, x, cfg)
        opt.zero_grad(set_to_none=True)
        losses["loss"].backward()
        opt.step()
        params.update(R.ema_codebook_update(params, z.detach(), codes, cfg))
        return {k: v.detach() for k, v in losses.items()}

    return step


def genret_step(gp: Dict, rq_params: Dict, queries: torch.Tensor,
                codes_all: torch.Tensor, pos: torch.Tensor,
                cfg: RQVAEConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """One training step of the decode head as a function of the batch's
    pair indices (Adam, lr 1e-3); updates ``gp`` in place, returns the
    loss."""
    leaves = _linear_leaves(gp["heads"])
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)

    def step(idx: torch.Tensor) -> torch.Tensor:
        codes = codes_all[pos[idx]]
        loss = R.genret_loss(gp, rq_params, queries[idx], codes, cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def _detached(tree):
    return R.tree_map(lambda t: t.detach().requires_grad_(False), tree)


def train_rqvae(item_reprs: np.ndarray, cfg: RQVAEConfig,
                num_steps: int = 2000, batch_size: int = 1024,
                seed: int = 0, verbose: bool = False, device="cuda",
                timings: Optional[dict] = None) -> RQVAEResult:
    """item_reprs [N, D_in] (row per item id, row 0 = padding, ignored).
    ``timings``, when given, receives the training and tokenizing seconds
    (synchronised with the device)."""
    dev = torch.device(device)
    n, d_in = item_reprs.shape
    params = R.init_rqvae_params(torch.Generator().manual_seed(seed), cfg,
                                 d_in, device=dev)
    reprs = torch.as_tensor(np.asarray(item_reprs, np.float32), device=dev)
    step = rqvae_step(params, reprs, cfg)
    gen = _index_gen(seed + 1, dev)
    _sync(dev)
    t0 = time.perf_counter()
    losses = None
    for i in range(num_steps):
        idx = torch.randint(1, n, (batch_size,), generator=gen, device=dev)
        losses = step(idx)
        if verbose and (i + 1) % 200 == 0:
            print(f"  rqvae step {i + 1}: "
                  f"recon {float(losses['recon']):.4f} "
                  f"commit {float(losses['commit']):.4f}")
    _sync(dev)
    t1 = time.perf_counter()
    params = _detached(params)
    ids = []
    bs = 8192
    for s in range(0, n, bs):
        ids.append(R.tokenize(params, reprs[s:s + bs]).to(torch.int32).cpu())
    semantic_ids = torch.cat(ids).numpy()
    semantic_ids[0] = 0
    if timings is not None:
        timings.update(rq_train_s=t1 - t0, rq_steps=num_steps,
                       tokenize_s=time.perf_counter() - t1, tokenize_items=n)
    return RQVAEResult(params=params, semantic_ids=semantic_ids,
                       final_losses={k: float(v) for k, v in losses.items()})


def train_genret_head(rq: RQVAEResult, queries: np.ndarray,
                      pos_item_ids: np.ndarray, cfg: RQVAEConfig,
                      num_steps: int = 1000, batch_size: int = 1024,
                      seed: int = 0, device="cuda",
                      timings: Optional[dict] = None) -> Dict:
    """queries [M, Dq] with aligned positive item ids [M]."""
    dev = torch.device(device)
    gp = R.init_genret_params(torch.Generator().manual_seed(seed), cfg,
                              queries.shape[1], device=dev)
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    codes_all = torch.as_tensor(np.asarray(rq.semantic_ids, np.int64),
                                device=dev)
    pos = torch.as_tensor(np.asarray(pos_item_ids, np.int64), device=dev)
    m = q.shape[0]
    step = genret_step(gp, rq.params, q, codes_all, pos, cfg)
    gen = _index_gen(seed + 2, dev)
    _sync(dev)
    t0 = time.perf_counter()
    loss = None
    for _ in range(num_steps):
        loss = step(torch.randint(0, m, (min(batch_size, m),), generator=gen,
                                  device=dev))
    _sync(dev)
    if timings is not None:
        timings.update(head_train_s=time.perf_counter() - t0,
                       head_steps=num_steps)
    return {"params": _detached(gp), "final_loss": float(loss)}


def _fill(idx: np.ndarray, fill: np.ndarray) -> None:
    """Places the beams left empty (-1) take the exact scorer's best items
    not already in the row, in order."""
    for b, row in enumerate(idx):
        missing = row < 0
        if missing.any():
            pool = [f for f in fill[b] if f not in set(row)]
            row[missing] = pool[: missing.sum()]


def genret_retrieve(gp: Dict, rq: RQVAEResult, queries: np.ndarray,
                    cfg: RQVAEConfig, k: int = 10, batch: int = 1024,
                    method: str = "exact", beam_width: int = 32,
                    device="cuda") -> np.ndarray:
    """Top-k item ids per query from the generative decode head.

    method:
    - "exact": teacher-forced log-likelihood of every candidate's semantic
      id (genret_score_items_exact), the gold scoring;
    - "beam": beam-search decode (no per-candidate scoring; true generative
      retrieval), beams mapped back to items; slots the beams don't cover
      fill from the exact scorer;
    - "flat": the argmax-context approximation (kept for comparison).
    """
    dev = torch.device(device)
    codes = torch.as_tensor(np.asarray(rq.semantic_ids[1:], np.int64),
                            device=dev)                    # no padding row
    score = R.genret_score_items if method == "flat" else \
        R.genret_score_items_exact
    out = []
    for s in range(0, len(queries), batch):
        q = torch.as_tensor(np.asarray(queries[s:s + batch], np.float32),
                            device=dev)
        if method == "beam":
            bc, bs = R.genret_beam_decode(gp, rq.params, q, cfg, beam_width)
            idx = R.beam_retrieve(bc.cpu().numpy(), bs.cpu().numpy(),
                                  rq.semantic_ids[1:], k)
            if (idx < 0).any():   # beams covered < k items: fill by scoring
                _, fill = R.top_k(score(gp, rq.params, q, codes, cfg), k)
                _fill(idx, fill.cpu().numpy())
        else:
            _, idx = R.top_k(score(gp, rq.params, q, codes, cfg), k)
            idx = idx.cpu().numpy()
        out.append(idx + 1)  # back to 1-based item ids
    return np.concatenate(out, axis=0)
