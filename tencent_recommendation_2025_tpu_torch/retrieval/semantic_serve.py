"""Generative (semantic-ID) serving: query.fbin -> id100.u64bin.

Counterpart of ``tencent_recommendation_2025_tpu/retrieval/semantic_serve
.py``. Serves the reference's retrieval file contract (query vectors in,
top-k retrieval ids out) with beam-search generative retrieval instead of
vector search:

1. the serving corpus embeddings tokenize through the trained RQ-VAE
   (``models/rqvae.tokenize``): candidates are coded on the fly, so items
   unseen at tokenizer-training time still serve;
2. queries beam-decode level-wise semantic codes through the decode head
   (``genret_beam_decode``), beams map back to candidate rows;
3. top-k slots the beams don't cover fill from the exact teacher-forced
   scorer (``genret_score_items_exact``), the rule of
   ``train.rqvae_trainer.genret_retrieve``.

Artifacts (RQ-VAE params, decode head, dims) sit under
``MODEL_OUTPUT_PATH/semantic`` in the checkpoint layout of both packages:
the JAX tree's leaf paths (``head/heads/0/b``, ..., ``rq/enc/2/w``) in its
order, and the meta keys ``rqvae_config``, ``input_dim`` and
``query_dim``. Artifacts either package wrote load in the other.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..config import RetrievalConfig, RQVAEConfig
from ..data import formats

SEMANTIC_SUBDIR = "semantic"


def _leaves(tree, prefix=""):
    """(tree path, tensor) in the JAX package's flattening order: dict keys
    sorted, lists by position."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix[:-1], tree)]
    return [leaf for k, v in items for leaf in _leaves(v, f"{prefix}{k}/")]


def save_semantic_artifacts(model_output_path, rq_params, head_params,
                            rqcfg: RQVAEConfig, input_dim: int,
                            query_dim: int) -> Path:
    """Persist the tokenizer + decode head next to the model checkpoint."""
    from ..train import checkpoint as CK

    meta = CK._meta(0, 0.0, None, {
        "rqvae_config": dataclasses.asdict(rqcfg),
        "input_dim": int(input_dim), "query_dim": int(query_dim)})
    leaves = dict(_leaves({"rq": rq_params, "head": head_params}))
    return CK._write(Path(model_output_path) / SEMANTIC_SUBDIR, leaves, meta,
                     0, 0.0)


def load_semantic_artifacts(model_output_path, device="cpu"
                            ) -> Tuple[dict, dict, RQVAEConfig]:
    """(RQ-VAE params, decode head, config) on ``device``; the leaves'
    paths and shapes are held to the config's."""
    from ..bridge import tree_from_jax
    from ..models import rqvae as R
    from ..train import checkpoint as CK

    art_dir = Path(model_output_path) / SEMANTIC_SUBDIR
    ck = CK.latest_checkpoint(art_dir)
    assert ck is not None, (
        f"no semantic artifacts under {art_dir}: run cli.semantic on this "
        "checkpoint first (--ann_method semantic serves its outputs)")
    meta = json.loads((ck / CK.META_FILE).read_text())
    rc = dict(meta["rqvae_config"])
    rc["enc_hidden"] = tuple(rc["enc_hidden"])
    rqcfg = RQVAEConfig(**rc)
    gen = torch.Generator().manual_seed(0)
    template = {"rq": R.init_rqvae_params(gen, rqcfg, meta["input_dim"]),
                "head": R.init_genret_params(gen, rqcfg, meta["query_dim"])}
    state = tree_from_jax(ck, device=device)
    want = [(p, tuple(t.shape)) for p, t in _leaves(template)]
    have = [(p, tuple(t.shape)) for p, t in _leaves(state)]
    if have != want:
        raise ValueError(f"semantic artifacts {ck} do not match their "
                         f"config: {sorted(set(have) ^ set(want))[:5]}")
    return state["rq"], state["head"], rqcfg


def run_semantic_ann(result_dir, model_output_path,
                     cfg: RetrievalConfig = RetrievalConfig(),
                     beam_width: int = 32,
                     dataset_file="embedding.fbin", id_file="id.u64bin",
                     query_file="query.fbin",
                     result_file="id100.u64bin", device="cuda") -> Path:
    """Drop-in twin of ``retrieval.ann.run_ann`` for the generative path:
    same on-disk inputs, same ``id100.u64bin`` output of retrieval ids."""
    from ..models import rqvae as R

    dev = torch.device(device)
    result_dir = Path(result_dir)
    out = result_dir / result_file
    corpus = formats.load_fbin(result_dir / dataset_file)
    ids = formats.load_u64bin(result_dir / id_file)[:, 0]
    queries = formats.load_fbin(result_dir / query_file)
    rq_params, head, rqcfg = load_semantic_artifacts(model_output_path, dev)

    # 1) tokenize the serving corpus (works for tokenizer-unseen items)
    cand = torch.cat([R.tokenize(rq_params, torch.as_tensor(
        np.asarray(corpus[s:s + 8192], np.float32), device=dev))
        for s in range(0, len(corpus), 8192)])
    cand_codes = cand.cpu().numpy()

    # 2) beam decode + 3) exact-scored fill (genret_retrieve's rule)
    k = cfg.top_k
    rows = []
    for s in range(0, len(queries), 1024):
        q = torch.as_tensor(np.asarray(queries[s:s + 1024], np.float32),
                            device=dev)
        bc, bs = R.genret_beam_decode(head, rq_params, q, rqcfg, beam_width)
        idx = R.beam_retrieve(bc.cpu().numpy(), bs.cpu().numpy(),
                              cand_codes, k)
        if (idx < 0).any():
            _, fill = R.top_k(R.genret_score_items_exact(
                head, rq_params, q, cand, rqcfg), min(k, len(cand_codes)))
            fill = fill.cpu().numpy()
            for b, row in enumerate(idx):
                missing = row < 0
                if missing.any():
                    pool = [f for f in fill[b] if f not in set(row)]
                    pool += [0] * int(missing.sum())      # degenerate corpus
                    row[missing] = pool[: int(missing.sum())]
        rows.append(idx)
    top_rows = np.concatenate(rows, axis=0)
    formats.save_result_ids(ids[np.maximum(top_rows, 0)], out)
    return out
