"""Training entry point: the reference ``main.py`` contract on the H100.

Counterpart of ``tencent_recommendation_2025_tpu/cli/train.py``, with its
arguments, its environment variables (``TRAIN_DATA_PATH``,
``TRAIN_LOG_PATH``, ``TRAIN_TF_EVENTS_PATH``, ``TRAIN_CKPT_PATH``) and its
outputs (JSONL ``train.log``, TensorBoard events, per-epoch checkpoints
named ``global_step{N}.valid_loss={v}``, which the port's ``cli.infer``
serves).

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; without CUDA and without ``--device cpu`` it raises. Loaders, as
the JAX CLI's: ``native`` packs every user's sample once with the C++ tool
(``data/native_pack.py``; built on first use into ``build/native/``; the
pack goes to ``TRAIN_CKPT_PATH/packed_cache_maxlen{maxlen}`` and is reused
from there, or without TRAIN_CKPT_PATH to a temporary directory), and
raises where the tool cannot be built; ``auto`` (the
default) takes the native pack at any scale, and only where the tool cannot
be built the python pack up to 2M samples, streaming above; ``cached`` is
the python pack (``data/cached_dataset.py``); ``streaming`` samples in
python threads every epoch. A checkpoint given by ``--state_dict_path``
resumes at its epoch and, for a preemption checkpoint (SIGTERM during a
run: the step in flight ends, a checkpoint is written and the run exits
cleanly), at its step in the epoch. In
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
the end of each epoch (stdout, ``train.log``, TensorBoard).
``--grad_accum_steps G`` trains each batch as G microbatches (dense tables,
no tower dedup).

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
import tempfile
import time
from pathlib import Path
from typing import Optional

#: above this many samples ``--loader auto`` streams instead of taking the
#: python pack, where the native tool cannot be built
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
                   help="native: the C++ pack (raises if the tool cannot "
                        "be built); cached: python pack, vectorized "
                        "negatives; streaming: threaded per-epoch sampling; "
                        "auto: native, else cached up to 2M samples, else "
                        "streaming")
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
    loader taken ("native", "cached" or "streaming") and, for a pack, the
    seconds it took and whether it was reused. ``packs``, when given, keeps
    the last pack under (its kind, data directory, its mtime, mm ids, array
    cap, maxlen): a caller that trains several models on the same data and
    window in one process passes the same dict, and the pack is built
    once."""
    args = get_args(argv)
    timings = {} if timings is None else timings
    cfg = build_config(args)

    import torch

    from ..config import EnvPaths
    from ..data import native_pack as NP
    from ..data.cached_dataset import CachedTrainLoader, PackedCache
    from ..data.dataset import TrainSampler
    from ..data.featurizer import FusedVocab, build_item_tables
    from ..data.pipeline import TrainLoader, train_val_split
    from ..data.readers import TencentGRData
    from ..data.schema import FeatureSchema
    from ..models.baseline import SeqRecModel
    from ..train import checkpoint as CK
    from ..train.trainer import check_supported, train_loop
    from ..utils.sysinfo import print_system_info
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

    env = EnvPaths.from_env()
    assert env.train_data_path, "TRAIN_DATA_PATH must be set"
    print("System info:")
    print_system_info()

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
    path = os.path.realpath(env.train_data_path)
    window = (path, os.stat(path).st_mtime_ns,
              tuple(cfg.features.mm_emb_ids), cfg.features.array_cap,
              cfg.model.maxlen)

    def packed(kind, build):
        """The pack of ``kind`` ("native" or "cached"): the one ``packs``
        holds for this window, else a new one, timed."""
        t0 = time.perf_counter()
        cache = (packs or {}).get((kind,) + window)
        timings.update(loader=kind, cache_reused=cache is not None)
        if cache is None:
            cache = build()
            if packs is not None:
                packs.clear()
                packs[(kind,) + window] = cache
        timings["cache_build_s"] = time.perf_counter() - t0
        print(f"loader: {kind} (--loader {args.loader}); "
              + ("reused the pack of" if timings["cache_reused"]
                 else "packed")
              + f" {len(cache)} samples in {timings['cache_build_s']:.2f} s")
        return cache

    def native_pack():
        name = f"packed_cache_maxlen{cfg.model.maxlen}"
        if env.train_ckpt_path:
            cache_dir = Path(env.train_ckpt_path) / name
            print(f"native dataprep cache at {cache_dir}")
            return NP.build_packed_cache_native(sampler, cache_dir,
                                                threads=args.num_workers)
        # no checkpoint directory to keep it beside: a temporary one, whose
        # files the memmapped pack outlives
        with tempfile.TemporaryDirectory(prefix=name) as tmp:
            return NP.build_packed_cache_native(sampler, Path(tmp),
                                                threads=args.num_workers)

    cache = None
    if args.loader in ("native", "auto"):
        if NP.tool_path() is not None:
            try:
                cache = packed("native", native_pack)
            except Exception as e:
                if args.loader == "native":
                    raise
                print(f"native dataprep unavailable ({e}); falling back to "
                      "the python pack")
        elif args.loader == "native":
            raise RuntimeError(f"--loader native: the dataprep tool could "
                               f"not be built from {NP.SOURCE}")
        else:
            print("native dataprep tool could not be built; falling back to "
                  "the python pack")
    if cache is None and (args.loader == "cached" or (
            args.loader != "streaming"
            and len(sampler) <= AUTO_CACHE_MAX_SAMPLES)):
        cache = packed("cached", lambda: PackedCache(
            sampler, num_workers=args.num_workers))
    if cache is not None:
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
    start_epoch = skip_steps = 0
    if args.state_dict_path:
        state, meta = CK.load_checkpoint(args.state_dict_path, model, cfg,
                                         device=dev)
        # the reference parses epoch= from the file name and runs only the
        # remaining epochs; the meta carries it directly, and a preemption
        # checkpoint the steps taken into the next
        start_epoch = int(meta.get("epoch", 0))
        skip_steps = int(meta.get("epoch_step", 0))
        print(f"resumed from {args.state_dict_path} "
              f"(step {meta.get('global_step')}, {start_epoch}/"
              f"{cfg.train.num_epochs} epochs done"
              + (f", +{skip_steps} steps into the next" if skip_steps
                 else "") + ")")

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
                       start_epoch=start_epoch, skip_steps=skip_steps,
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
