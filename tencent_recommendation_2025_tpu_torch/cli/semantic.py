"""Semantic-ID pipeline entry point (BASELINE.json configs[2]) on the H100.

Counterpart of ``tencent_recommendation_2025_tpu/cli/semantic.py``, with
its arguments and output files. From a trained sequence-model checkpoint
(either package's) under ``MODEL_OUTPUT_PATH``:

1. encode every item through the item tower (id emb + features +
   multimodal) to build item representations;
2. train the RQ-VAE tokenizer on them and write ``semantic_ids.npy``
   ([itemnum+1, L] int32) to ``EVAL_RESULT_PATH``;
3. build (query, positive) pairs from the training sequences (the query
   the sequence model's ``predict``, the positive the last supervised
   target), train the generative decode head, and save the tokenizer and
   head under ``MODEL_OUTPUT_PATH/semantic`` for ``cli.infer --ann_method
   semantic``;
4. self-evaluate decode-head retrieval HR@10 on the training pairs against
   exact MIPS over the same item representations (``semantic_eval.json``).

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; without CUDA and without ``--device cpu`` it raises.

    TRAIN_DATA_PATH=... MODEL_OUTPUT_PATH=... EVAL_RESULT_PATH=... \\
    python -m tencent_recommendation_2025_tpu_torch.cli.semantic \\
        --preset hstu_flagship --maxlen 1023
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="baseline")
    p.add_argument("--maxlen", default=None, type=int)
    p.add_argument("--hidden_units", default=None, type=int)
    p.add_argument("--num_blocks", default=None, type=int)
    p.add_argument("--num_heads", default=None, type=int)
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--mm_emb_id", nargs="+", default=["81"], type=str)
    p.add_argument("--rq_levels", default=None, type=int)
    p.add_argument("--rq_codebook", default=None, type=int)
    p.add_argument("--rq_steps", default=2000, type=int)
    p.add_argument("--head_steps", default=1000, type=int)
    p.add_argument("--num_query_users", default=2048, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None, timings: Optional[dict] = None) -> dict:
    """Run the pipeline; returns what ``semantic_eval.json`` holds.
    ``timings``, when given, receives the seconds and counts of each stage
    (synchronised with the device)."""
    args = get_args(argv)

    import time

    import torch

    from ..config import EnvPaths, PRESETS
    from ..data.dataset import TrainSampler
    from ..data.featurizer import FusedVocab, build_item_tables
    from ..data.pipeline import collate_train
    from ..data.readers import TencentGRData
    from ..data.schema import FeatureSchema
    from ..models.baseline import SeqRecModel
    from ..retrieval.mips import retrieve_topk
    from ..retrieval.semantic_serve import save_semantic_artifacts
    from ..train import checkpoint as CK
    from ..train.rqvae_trainer import (genret_retrieve, train_genret_head,
                                       train_rqvae)
    from ..train.trainer import device_tables, put_batch
    from .infer import _sync, resolve_device

    dev = resolve_device(args.device)
    timings = {} if timings is None else timings
    env = EnvPaths.from_env()
    assert env.train_data_path, "TRAIN_DATA_PATH must be set"
    out_dir = Path(env.eval_result_path or ".")
    out_dir.mkdir(parents=True, exist_ok=True)

    cfg = PRESETS[args.preset]()
    over = {k: getattr(args, k) for k in
            ("hidden_units", "num_blocks", "num_heads", "maxlen", "dtype")
            if getattr(args, k) is not None}
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, **over),
        features=dataclasses.replace(cfg.features,
                                     mm_emb_ids=tuple(args.mm_emb_id)))
    rq_over = {}
    if args.rq_levels:
        rq_over["num_levels"] = args.rq_levels
    if args.rq_codebook:
        rq_over["codebook_size"] = args.rq_codebook
    rqcfg = dataclasses.replace(cfg.rqvae, **rq_over)

    data = TencentGRData(env.train_data_path,
                         mm_emb_ids=cfg.features.mm_emb_ids)
    schema = FeatureSchema.from_indexer(data.indexer,
                                        cfg.features.mm_emb_ids,
                                        cfg.features.array_cap)
    fused = FusedVocab.build(schema)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema, fused=fused,
                        usernum=data.usernum, itemnum=data.itemnum)

    assert env.model_output_path, "MODEL_OUTPUT_PATH must be set"
    ckpt = CK.latest_checkpoint(env.model_output_path)
    assert ckpt, f"no checkpoint under {env.model_output_path}"
    params, _ = CK.load_params(ckpt, model, device=dev)
    print(f"loaded {ckpt.name}")

    # 1) item representations: item tower over all ids
    dtabs = device_tables(tables, dev)
    ids = torch.arange(data.itemnum + 1, dtype=torch.int64, device=dev)
    reprs = []
    bs = 8192
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for s in range(0, data.itemnum + 1, bs):
            i = ids[s:s + bs]
            reprs.append(model.item_embeddings(
                params, i, dtabs["sparse"][i], dtabs["array"][i],
                dtabs["mm"]).float().cpu().numpy())
    item_reprs = np.concatenate(reprs, axis=0)
    timings.update(item_reprs_s=time.perf_counter() - t0)
    print(f"item representations: {item_reprs.shape}")

    # 2) RQ-VAE tokenizer
    rq = train_rqvae(item_reprs, rqcfg, num_steps=args.rq_steps,
                     verbose=True, device=dev, timings=timings)
    np.save(out_dir / "semantic_ids.npy", rq.semantic_ids)
    used = [len(np.unique(rq.semantic_ids[1:, l]))
            for l in range(rqcfg.num_levels)]
    print(f"rqvae: recon={rq.final_losses['recon']:.4f} "
          f"codes-used-per-level={used}")

    # 3) decode head from (query, positive) pairs
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    n_users = min(args.num_query_users, len(sampler))
    rng = np.random.default_rng(0)
    queries, positives = [], []
    bs = 256
    t_predict, n_batches = 0.0, 0
    for s in range(0, n_users, bs):
        samples = [sampler.sample(u, rng)
                   for u in range(s, min(s + bs, n_users))]
        batch = put_batch(collate_train(samples, bs), dev)
        _sync(dev)
        t0 = time.perf_counter()
        q = model.predict(params, batch, dtabs["mm"]).float().cpu().numpy()
        t_predict += time.perf_counter() - t0
        n_batches += 1
        # positive = the last supervised position's target item
        for j, smp in enumerate(samples):
            nz = np.nonzero(smp.pos)[0]
            if len(nz):
                queries.append(q[j])
                positives.append(int(smp.pos[nz[-1]]))
    queries = np.stack(queries)
    positives = np.asarray(positives, np.int64)
    timings.update(predict_s=t_predict, n_query_batches=n_batches)
    print(f"decode-head training pairs: {len(positives)}")

    head = train_genret_head(rq, queries, positives, rqcfg,
                             num_steps=args.head_steps, device=dev,
                             timings=timings)
    print(f"decode head final loss: {head['final_loss']:.4f}")

    # persist the tokenizer + decode head next to the model checkpoint so
    # cli.infer --ann_method semantic can serve them
    art = save_semantic_artifacts(env.model_output_path, rq.params,
                                  head["params"], rqcfg,
                                  input_dim=item_reprs.shape[1],
                                  query_dim=queries.shape[1])
    print(f"semantic serving artifacts: {art}")

    # 4) self-eval: decode-head retrieval HR on the training pairs, against
    # the exact-MIPS baseline over the SAME item embeddings and queries
    k = cfg.retrieval.top_k

    def hr(top):
        return float(np.mean([positives[i] in top[i]
                              for i in range(len(positives))]))

    hits = hr(genret_retrieve(head["params"], rq, queries, rqcfg, k=k,
                              device=dev))
    hits_beam = hr(genret_retrieve(head["params"], rq, queries, rqcfg, k=k,
                                   method="beam", beam_width=32,
                                   device=dev))
    mips_top = retrieve_topk(queries, item_reprs[1:],
                             np.arange(1, data.itemnum + 1), k=k,
                             device=dev)
    hits_mips = hr(mips_top)
    print(f"HR@{k} (train pairs): exact-scored generative {hits:.4f} | "
          f"beam decode {hits_beam:.4f} | exact MIPS {hits_mips:.4f}")
    result = {"rq_recon": rq.final_losses["recon"],
              "codes_used": used,
              "genret_train_hr": float(hits),
              "genret_beam_train_hr": float(hits_beam),
              "mips_train_hr": float(hits_mips),
              "num_pairs": int(len(positives))}
    with open(out_dir / "semantic_eval.json", "w") as f:
        json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
