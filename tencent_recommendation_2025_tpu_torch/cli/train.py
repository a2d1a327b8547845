"""Training entry point: the reference ``main.py`` contract on the H100.

Counterpart of ``tencent_recommendation_2025_tpu/cli/train.py``, with its
arguments, its environment variables (``TRAIN_DATA_PATH``,
``TRAIN_LOG_PATH``, ``TRAIN_TF_EVENTS_PATH``, ``TRAIN_CKPT_PATH``) and its
outputs (JSONL ``train.log``, TensorBoard events, per-epoch checkpoints
named ``global_step{N}.valid_loss={v}``, which the port's ``cli.infer``
serves).

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; without CUDA and without ``--device cpu`` it raises. Loaders:
``cached`` packs every user's sample once (``data/cached_dataset.py``) and
samples negatives vectorised; ``streaming`` samples in python threads every
epoch; ``auto`` takes the cached loader up to 2M samples and streams above,
as the JAX package's ``auto`` does where its native tool is absent. In
one process, a preset whose mesh wants several devices
(``sampled_softmax_dp``, ``sharded_multihost``, or any ``--mesh_*``) trains
on one, with the JAX CLI's warning. Under ``torchrun`` (``WORLD_SIZE`` > 1)
the processes form the mesh, one card each (``LOCAL_RANK``; NCCL, or gloo
with ``--device cpu``): a ``seq`` axis above 1, any ``data``, dense tables
and the BCE loss train sequence-parallel; any other mesh or option raises
``NotImplementedError`` (ROADMAP Queue 1, item 5). Only rank 0 writes
``train.log``, TensorBoard events and checkpoints; the parameters are
replicated, so the checkpoint is the single-device one.
``--eval_retrieval_users N`` logs HR@10 / NDCG@10 of N validation users at
the end of each epoch (stdout, ``train.log``, TensorBoard). The native
loader and gradient accumulation raise ``NotImplementedError`` naming their
ROADMAP item.

    TRAIN_DATA_PATH=... TRAIN_CKPT_PATH=... python -m \\
        tencent_recommendation_2025_tpu_torch.cli.train \\
        --preset hstu_flagship --maxlen 1023

Long sequences (L = 4096, the chunked variant of the fused block kernels):
``--preset hstu_flagship --maxlen 4095 --batch_size 32 --loader cached``.
Sequence-parallel on S cards (not yet run on a machine with several):
``torchrun --nproc_per_node S -m tencent_recommendation_2025_tpu_torch.cli.
train --preset hstu_flagship --mesh_seq S --maxlen 4095 --batch_size 32``.
Sparse tables and the sampled softmax: ``--preset sharded_multihost
--maxlen 1023`` (sparse ``item_emb``, rowwise Adagrad) or ``--preset
sampled_softmax_dp``. The ReLU-FFN HSTU on long histories (the standalone
HSTU attention kernels, chunked route): ``--preset hstu_mini --maxlen 4095
--batch_size 32 --loader cached``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from pathlib import Path
from typing import Optional

#: above this many samples ``--loader auto`` streams instead of packing
AUTO_CACHE_MAX_SAMPLES = 2_000_000


def get_args(argv=None):
    p = argparse.ArgumentParser()
    # reference train params (main.py:21-44)
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--maxlen", default=None, type=int)
    p.add_argument("--hidden_units", default=None, type=int)
    p.add_argument("--num_blocks", default=None, type=int)
    p.add_argument("--num_epochs", default=None, type=int)
    p.add_argument("--num_heads", default=None, type=int)
    p.add_argument("--dropout_rate", default=None, type=float)
    p.add_argument("--l2_emb", default=None, type=float)
    p.add_argument("--device", default="cuda", type=str,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--inference_only", action="store_true")
    p.add_argument("--state_dict_path", default=None, type=str,
                   help="checkpoint dir (or a dir of them) to resume from")
    p.add_argument("--norm_first", action="store_true")
    p.add_argument("--mm_emb_id", nargs="+", default=["81"], type=str,
                   choices=[str(s) for s in range(81, 87)])
    # framework flags
    p.add_argument("--preset", default="baseline",
                   choices=["baseline", "baseline_o1", "hstu_mini",
                            "hstu_flagship", "sampled_softmax_dp",
                            "sharded_multihost"])
    p.add_argument("--block_type", default=None, choices=["mha", "hstu"])
    p.add_argument("--loss_type", default=None,
                   choices=["bce", "sampled_softmax"])
    p.add_argument("--num_inbatch_negatives", default=None, type=int)
    p.add_argument("--grad_accum_steps", default=None, type=int)
    p.add_argument("--eval_retrieval_users", default=None, type=int)
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--mesh_data", default=None, type=int)
    p.add_argument("--mesh_model", default=None, type=int)
    p.add_argument("--mesh_seq", default=None, type=int)
    p.add_argument("--mesh_pipe", default=None, type=int)
    p.add_argument("--pp_microbatches", default=None, type=int)
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--seed", default=None, type=int)
    p.add_argument("--profile_steps", default=0, type=int,
                   help="trace N train steps with torch.profiler, written "
                        "under TRAIN_LOG_PATH/profile")
    p.add_argument("--profile_start", default=4, type=int,
                   help="1-based step the profile window starts at")
    p.add_argument("--loader", default="auto",
                   choices=["auto", "native", "cached", "streaming"],
                   help="cached: python pack, vectorized negatives; "
                        "streaming: threaded per-epoch sampling; auto: "
                        "cached up to 2M samples, else streaming; native is "
                        "not ported yet")
    return p.parse_args(argv)


def build_config(args):
    from ..config import PRESETS

    cfg = PRESETS[args.preset]()
    model_over = {k: getattr(args, k) for k in
                  ("hidden_units", "num_blocks", "num_heads", "maxlen",
                   "dropout_rate", "block_type", "dtype")
                  if getattr(args, k) is not None}
    if args.norm_first:
        model_over["norm_first"] = True
    train_over = {k: getattr(args, k) for k in
                  ("batch_size", "lr", "num_epochs", "l2_emb", "loss_type",
                   "seed", "num_inbatch_negatives", "grad_accum_steps",
                   "eval_retrieval_users")
                  if getattr(args, k) is not None}
    mesh_over = {}
    for ax in ("data", "model", "seq", "pipe"):
        v = getattr(args, f"mesh_{ax}")
        if v is not None:
            mesh_over[ax] = v
    if args.pp_microbatches is not None:
        mesh_over["pp_microbatches"] = args.pp_microbatches
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model_over),
        train=dataclasses.replace(cfg.train, **train_over),
        mesh=dataclasses.replace(cfg.mesh, **mesh_over),
        features=dataclasses.replace(cfg.features,
                                     mm_emb_ids=tuple(args.mm_emb_id)),
    )


def single_device_warning(want: int, present: int) -> str:
    """What ``main`` prints in one process when the preset's mesh wants
    ``want`` devices: the JAX CLI's warning where fewer are present (it
    trains single-device there); where enough are, the port still trains
    single-device (one process drives one card), and says how a mesh
    runs."""
    if present < want:
        return (f"WARNING: preset wants {want} devices but only {present} "
                "present — training single-device")
    return (f"WARNING: preset wants {want} devices; one process drives one "
            "card: a seq mesh trains under torchrun with one process per "
            "card, other meshes wait for ROADMAP Queue 1, item 5 — training "
            "single-device")


def main(argv=None, timings: Optional[dict] = None,
         packs: Optional[dict] = None):
    """Train; returns the final state. ``timings``, when given, receives the
    loader taken ("cached" or "streaming") and, for the cached one, the
    seconds its pack took and whether it was reused. ``packs``, when given,
    keeps the last packed cache under (data directory, its mtime, mm ids,
    array cap, maxlen): a caller that trains several models on the same
    data and window in one process passes the same dict, and the pack is
    built once."""
    args = get_args(argv)
    timings = {} if timings is None else timings
    cfg = build_config(args)

    import torch

    from ..config import EnvPaths
    from ..data.cached_dataset import CachedTrainLoader, PackedCache
    from ..data.dataset import TrainSampler
    from ..data.featurizer import FusedVocab, build_item_tables
    from ..data.pipeline import TrainLoader, train_val_split
    from ..data.readers import TencentGRData
    from ..data.schema import FeatureSchema
    from ..models.baseline import SeqRecModel
    from ..train import checkpoint as CK
    from ..train.trainer import check_supported, train_loop
    from .infer import resolve_device

    dev = resolve_device(args.device)
    mc = cfg.mesh
    want = mc.pipe * mc.data * mc.model * mc.seq
    # the mesh before the model, as the JAX CLI decides it: several
    # processes form one (or raise); one process trains single-device
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        import torch.distributed as dist

        from ..parallel.mesh import build_mesh, initialize_distributed

        initialize_distributed(dev.type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = build_mesh(mc)
        print(f"mesh: {mesh.shape} over {os.environ['WORLD_SIZE']} processes "
              f"(rank {mesh.rank})")
    elif want > 1:
        print(single_device_warning(
            want, torch.cuda.device_count() if dev.type == "cuda" else 1))
    check_supported(cfg, mesh)
    if args.loader == "native":
        raise NotImplementedError(
            "--loader native (the C++ dataprep pack) is not ported yet: "
            "ROADMAP Queue 1, item 4 (native pack)")

    env = EnvPaths.from_env()
    assert env.train_data_path, "TRAIN_DATA_PATH must be set"
    print(f"System info: torch {torch.__version__}, device {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else ""))

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

    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    tr_idx, va_idx = train_val_split(len(sampler), cfg.train.valid_fraction,
                                     cfg.train.seed)
    cached = args.loader == "cached" or (
        args.loader == "auto" and len(sampler) <= AUTO_CACHE_MAX_SAMPLES)
    if cached:
        t0 = time.perf_counter()
        path = os.path.realpath(env.train_data_path)
        key = (path, os.stat(path).st_mtime_ns,
               tuple(cfg.features.mm_emb_ids), cfg.features.array_cap,
               cfg.model.maxlen)
        cache = (packs or {}).get(key)
        timings.update(loader="cached", cache_reused=cache is not None)
        if cache is None:
            cache = PackedCache(sampler, num_workers=args.num_workers)
            if packs is not None:
                packs.clear()
                packs[key] = cache
        timings["cache_build_s"] = time.perf_counter() - t0
        print(f"loader: cached (--loader {args.loader}); "
              + ("reused the pack of" if timings["cache_reused"]
                 else "packed")
              + f" {len(cache)} samples in {timings['cache_build_s']:.2f} s")
        train_loader = CachedTrainLoader(
            cache, tr_idx, cfg.train.batch_size, seed=cfg.train.seed,
            num_workers=min(args.num_workers, 8))
        valid_loader = CachedTrainLoader(cache, va_idx, cfg.train.batch_size,
                                         seed=cfg.train.seed, shuffle=False)
    else:
        timings.update(loader="streaming")
        print(f"loader: streaming (--loader {args.loader})")
        train_loader = TrainLoader(sampler, tr_idx, cfg.train.batch_size,
                                   seed=cfg.train.seed,
                                   num_workers=args.num_workers)
        valid_loader = TrainLoader(sampler, va_idx, cfg.train.batch_size,
                                   seed=cfg.train.seed, shuffle=False,
                                   num_workers=args.num_workers)

    state = None
    start_epoch = 0
    if args.state_dict_path:
        state, meta = CK.load_checkpoint(args.state_dict_path, model, cfg,
                                         device=dev)
        # the reference parses epoch= from the file name and runs only the
        # remaining epochs; the meta carries it directly
        start_epoch = int(meta.get("epoch", 0))
        print(f"resumed from {args.state_dict_path} "
              f"(step {meta.get('global_step')}, {start_epoch}/"
              f"{cfg.train.num_epochs} epochs done)")

    if args.inference_only:
        print("inference_only: skipping training")
        return None

    profile_dir = None
    if args.profile_steps:
        profile_dir = str(Path(env.train_log_path or ".") / "profile")
    state = train_loop(model, cfg, train_loader, valid_loader, tables,
                       log_dir=env.train_log_path,
                       tb_dir=env.train_tf_events_path,
                       ckpt_dir=env.train_ckpt_path, state=state,
                       start_epoch=start_epoch,
                       profile_steps=args.profile_steps,
                       profile_dir=profile_dir,
                       profile_start=args.profile_start, mesh=mesh,
                       device=dev)
    if mesh is not None:
        dist.barrier()
        dist.destroy_process_group()
    print("Done")
    return state


if __name__ == "__main__":
    main()
