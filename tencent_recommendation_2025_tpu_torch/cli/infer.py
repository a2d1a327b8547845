"""Inference entry point: the reference ``infer.py`` contract on the H100.

Counterpart of ``tencent_recommendation_2025_tpu/cli/infer.py``, with its
arguments, environment variables (``EVAL_DATA_PATH``, ``EVAL_RESULT_PATH``,
``MODEL_OUTPUT_PATH``) and output files. Pipeline: rebuild the model from the
test split, load the newest checkpoint under ``MODEL_OUTPUT_PATH``, encode
every test user's last position to ``query.fbin``, encode the candidate
corpus from ``predict_set.jsonl`` (cold-start fill, mm attach,
``retrive_id2creative_id.json``) in fixed 1024-row chunks, run the top-k
search of ``--ann_method`` (``exact``, the default; ``approx``; ``int8``,
the quantized corpus; ``hnsw``, the C++ HNSW tool; ``semantic``, beam
decoding through the artifacts of ``cli.semantic``, with ``--beam_width``;
see ``retrieval/ann``) and decode ``id100.u64bin`` to per-user top-10 creative ids.

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; without CUDA and without ``--device cpu`` it raises.

    EVAL_DATA_PATH=... EVAL_RESULT_PATH=... MODEL_OUTPUT_PATH=... \\
    python -m tencent_recommendation_2025_tpu_torch.cli.infer \\
        --preset hstu_flagship --maxlen 1023

Under ``torchrun`` (``WORLD_SIZE`` > 1) the processes join one group (NCCL,
one card each; gloo with ``--device cpu``): rank 0 encodes the queries and
the corpus and writes the files as one process does; after a barrier every
process reads the corpus file's rows of its shard and serves them
(``exact``, ``approx``, ``int8``: the corpus row-sharded over the
processes, ``retrieval/mips.py``), and rank 0 writes the result file and
scores it. ``hnsw`` and ``semantic`` run on rank 0 alone.

    torchrun --nproc_per_node 4 -m tencent_recommendation_2025_tpu_torch.cli\\
        .infer --preset hstu_flagship --maxlen 1023
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--maxlen", default=None, type=int)
    p.add_argument("--hidden_units", default=None, type=int)
    p.add_argument("--num_blocks", default=None, type=int)
    p.add_argument("--num_heads", default=None, type=int)
    p.add_argument("--dropout_rate", default=None, type=float)
    p.add_argument("--device", default="cuda", type=str,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--mm_emb_id", nargs="+", default=["81"], type=str,
                   choices=[str(s) for s in range(81, 87)])
    p.add_argument("--preset", default="baseline")
    p.add_argument("--block_type", default=None, choices=["mha", "hstu"])
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--norm_first", action="store_true")
    p.add_argument("--ann_method", default="exact",
                   choices=["exact", "approx", "int8", "hnsw", "semantic"])
    p.add_argument("--beam_width", default=32, type=int,
                   help="beam width for --ann_method semantic")
    p.add_argument("--num_workers", default=8, type=int)
    return p.parse_args(argv)


def resolve_device(name: str):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu to run "
                           "on the CPU")
    return dev


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serving_mesh(dev):
    """(the process mesh over ``torchrun``'s processes, joined here, and
    the device of this process) where ``WORLD_SIZE`` > 1; (None, ``dev``)
    for one process."""
    import torch

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None, dev
    from ..parallel.mesh import build_mesh, initialize_distributed

    initialize_distributed(dev.type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return build_mesh(), dev


def infer(argv=None, timings: Optional[dict] = None):
    """Returns (per-user top-10 creative ids, user ids); None on a rank
    above 0 of a process mesh, which writes no file. ``timings``, when
    given, receives the host-clock seconds and counts of each phase
    (synchronised with the device)."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    mesh, dev = serving_mesh(dev)
    out = _infer(args, dev, mesh, {} if timings is None else timings)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    return out


def _infer(args, dev, mesh, timings: dict):
    from ..config import EnvPaths, PRESETS
    from ..data import formats
    from ..retrieval.ann import run_ann

    env = EnvPaths.from_env()
    assert env.eval_data_path, "EVAL_DATA_PATH must be set"
    assert env.eval_result_path, "EVAL_RESULT_PATH must be set"
    result_dir = Path(env.eval_result_path)
    result_dir.mkdir(parents=True, exist_ok=True)
    rank0 = mesh is None or mesh.rank == 0

    cfg = PRESETS[args.preset]()
    over = {k: getattr(args, k) for k in
            ("hidden_units", "num_blocks", "num_heads", "maxlen",
             "dropout_rate", "block_type", "dtype")
            if getattr(args, k) is not None}
    if args.norm_first:
        over["norm_first"] = True
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, **over),
        features=dataclasses.replace(cfg.features,
                                     mm_emb_ids=tuple(args.mm_emb_id)))

    if rank0:
        user_list, retrieve_id2creative_id = _encode(
            args, cfg, env, dev, result_dir, timings)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()         # the files written before any rank reads

    rcfg = dataclasses.replace(cfg.retrieval, method=args.ann_method)
    _sync(dev)
    t0 = time.perf_counter()
    out = result_dir / "id100.u64bin"
    if rank0 or args.ann_method in ("exact", "approx", "int8"):
        out = run_ann(result_dir, rcfg, device=dev,
                      model_output_path=env.model_output_path,
                      beam_width=args.beam_width, mesh=mesh)
    _sync(dev)
    timings.update(topk_s=time.perf_counter() - t0)
    if not rank0:
        return None
    top10s_retrieved = formats.read_result_ids(out)
    top10s = [[retrieve_id2creative_id.get(int(r), 0) for r in row]
              for row in top10s_retrieved]
    return top10s, user_list


def _encode(args, cfg, env, dev, result_dir, timings: dict):
    """Encode every test user's query and the candidate corpus and write
    ``query.fbin``, ``embedding.fbin``, ``id.u64bin`` and
    ``retrive_id2creative_id.json``; returns (user ids, retrieval id ->
    creative id)."""
    import torch

    from ..config import MM_EMB_DIMS
    from ..data import formats
    from ..data.dataset import TestSampler
    from ..data.featurizer import (FusedVocab, build_item_tables,
                                   pack_item_feat)
    from ..data.pipeline import TestLoader
    from ..data.readers import TencentGRData
    from ..data.schema import FeatureSchema
    from ..models.baseline import SeqRecModel
    from ..train import checkpoint as CK
    from ..train.trainer import put_batch
    from ..utils import tracing as TRC

    data = TencentGRData(env.eval_data_path,
                         mm_emb_ids=cfg.features.mm_emb_ids, split="test")
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
    assert ckpt is not None, f"no checkpoint under {env.model_output_path}"
    params, meta = CK.load_params(ckpt, model, device=dev)
    print(f"loaded {ckpt} (meta {meta})")
    mm_tables = {k: torch.as_tensor(v, device=dev)
                 for k, v in tables.mm.items()}

    sampler = TestSampler(data, schema, cfg.model.maxlen)
    loader = TestLoader(sampler, args.batch_size,
                        num_workers=args.num_workers)
    queries, user_list = [], []
    t_predict = 0.0
    for j, (batch, uids, n_valid) in enumerate(loader):
        _sync(dev)
        t0 = time.perf_counter()
        with TRC.span("request", {"batch": j}):
            q = model.predict(params, put_batch(batch, dev), mm_tables)
            q = q.float().cpu().numpy()
        t_predict += time.perf_counter() - t0
        queries.append(q[:n_valid])
        user_list += uids[:n_valid]
    query_embs = np.concatenate(queries, axis=0)
    timings.update(predict_s=t_predict, n_queries=len(query_embs),
                   n_query_batches=len(loader))

    # candidate corpus (reference get_candidate_emb)
    cand_path = Path(env.eval_data_path) / "predict_set.jsonl"
    item_ids, retrieval_ids, features, creative_ids = [], [], [], []
    retrieve_id2creative_id = {}
    with open(cand_path) as f:
        for line in f:
            rec = json.loads(line)
            cid, rid = rec["creative_id"], rec["retrieval_id"]
            item_ids.append(data.indexer["i"].get(cid, 0))
            retrieval_ids.append(rid)
            creative_ids.append(cid)
            features.append(rec["features"])
            retrieve_id2creative_id[rid] = cid

    n = len(item_ids)
    ids = np.asarray(item_ids, np.int32)
    packed = [pack_item_feat(f, schema) for f in features]
    sp = np.stack([p[0] for p in packed])
    ar = np.stack([p[1] for p in packed])
    mm_vecs = {}
    for fid in schema.mm_emb_ids:
        m = np.zeros((n, MM_EMB_DIMS[fid]), np.float32)
        store = data.mm_emb_dict.get(fid, {})
        for i, cid in enumerate(creative_ids):
            v = store.get(cid)
            if isinstance(v, np.ndarray):
                m[i] = v
        mm_vecs[fid] = m

    # fixed 1024-row chunks: one set of shapes for every chunk
    bs = 1024
    pad = -n % bs

    def padb(x):
        return np.concatenate(
            [x, np.zeros((pad, *x.shape[1:]), x.dtype)]) if pad else x

    ids_p, sp_p, ar_p = padb(ids), padb(sp), padb(ar)
    mm_p = {k: padb(v) for k, v in mm_vecs.items()}
    chunks = []
    _sync(dev)
    t0 = time.perf_counter()
    for o in range(0, n + pad, bs):
        sl = slice(o, o + bs)

        def put(a):
            return torch.as_tensor(a[sl], device=dev)

        emb = model.encode_items(params, put(ids_p), put(sp_p), put(ar_p),
                                 {k: put(v) for k, v in mm_p.items()})
        chunks.append(emb.float().cpu().numpy())
    timings.update(encode_items_s=time.perf_counter() - t0, n_items=n)
    corpus = np.concatenate(chunks, axis=0)[:n]

    formats.save_emb(corpus, result_dir / "embedding.fbin")
    formats.save_emb(np.asarray(retrieval_ids, np.uint64).reshape(-1, 1),
                     result_dir / "id.u64bin")
    formats.save_emb(query_embs, result_dir / "query.fbin")
    with open(result_dir / "retrive_id2creative_id.json", "w") as f:
        json.dump(retrieve_id2creative_id, f)
    return user_list, retrieve_id2creative_id


def main(argv=None, timings: Optional[dict] = None):
    """Run :func:`infer`, then score HR@10/NDCG@10 when the data carries
    ``ground_truth.json``; returns those metrics (or None; None on a rank
    above 0 of a process mesh)."""
    res = infer(argv, timings)
    if res is None:
        return None
    top10s, users = res
    print(f"retrieved top-10 for {len(users)} users")

    from ..config import EnvPaths
    from ..retrieval.evaluator import hr_ndcg_at_k

    env = EnvPaths.from_env()
    gt_path = Path(env.eval_data_path) / "ground_truth.json"
    if gt_path.exists():
        gt = json.loads(gt_path.read_text())
        m = hr_ndcg_at_k(dict(zip(users, top10s)), gt, k=10)
        print(f"HR@10={m['hr']:.4f} NDCG@10={m['ndcg']:.4f} n={m['n']}")
        return m
    return None


if __name__ == "__main__":
    main()
