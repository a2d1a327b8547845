#!/usr/bin/env python3
"""Data parallelism across cards: N processes, one card each, joined by
NCCL, against one process on one card.

    python3 scripts/nccl_dp_check.py                  # 4 cards
    python3 scripts/nccl_dp_check.py --device cpu --nproc 2 --small

The second form rehearses the same path on the CPU in gloo processes at
small widths. The script makes a seeded fixture under build/nccl_dp/ (1024
users, 5000 items, 256..1000 events, as ``chip_smoke.py``'s flagship
fixture), then for each case below takes one ``make_train_step`` step from
the same seeded state on the first global batch: in this process on one
device (no mesh), and in N worker processes on a process mesh
(``parallel.mesh.build_mesh``; each worker this file run again with the
torchrun variables set). The learned tables and the static item and mm
tables row-shard over the data processes. Per case it holds the process mesh's loss and gradient (rank
0's: the replicated leaves all-reduced, its rows of the tables) to the
single device's, every rank's replicated parameters after the step bitwise
equal to rank 0's and its rows of the tables (V / data of them) at
cosine >= 0.999 to the single device's rows, and (sampled softmax) every rank's candidates equal
to the single device's; the data-only cases print ``ep_overflow`` (the
item ids past their all-to-all bucket: where it is above 0 the mesh's
function differs from the single device's and the case says so); then it
times 6 synchronised steps after 2 on both sides (host clock; per card on
the mesh).

- ``bce_dp``: hstu_flagship ``--maxlen 1023`` (L=1024, B=128, BCE), data N;
  bf16: loss within 1e-4 relative, every gradient at cosine >= 0.999.
- ``softmax_dp``: sampled_softmax_dp ``--maxlen 255`` (L=256, B=64, 64
  in-batch negatives), data N; bf16, the same limits.
- ``bce_dp_seq2``: the flagship on data N/2 x seq 2 (the fused ring across
  cards); f32 (the ring rounds elsewhere than the single device in bf16):
  loss within 1e-5 relative, cosine >= 0.999.
- ``sparse_100m``: ``chip_smoke.py``'s 100M-row sparse step (itemnum 1e8,
  B=64, L=1024, D=64, 8 blocks, H=1, bf16 table, rowwise Adagrad, BCE) on
  data N, each card holding Vp / N rows of the table (3.2 GB at N = 4)
  and ceil(V / N) rows of the full-size static tables (``sparse`` [V, 14]
  int32 and ``mm["81"]`` [V, 32] f32, V = 1e8 + 1: 18.4 GB whole, drawn
  on each card chunk by chunk from seeded generators, so that a rank draws
  only its rows and they equal the single card's): loss within 1e-4
  relative; each rank's touched rows against the single device's at
  cosine >= 0.999 (the rows' bf16 gradient sums in another order),
  100,000 sampled untouched rows of its block bitwise equal to the single
  device's; its group scatter launched once per chunk; each card's bytes
  of the static tables printed.
- ``topk``: the sharded serving tiers (``retrieval/mips.py``) on a process
  mesh of N corpus shards: a 100M x 64 int8 corpus and a 25M x 64 f32 one
  (exact and approx), Q=1024, k=10, each card drawing and holding its rows
  only (chunk-seeded as above; the int8 rows quantized on the card chunk
  by chunk), against one card holding the whole corpus: ids equal except
  at places whose two scores are within 1e-5 relative (f32) or 2^-8 (int8,
  the bf16 ranking's ties), counted; recall@10 >= 0.999; each card's
  corpus bytes and the times of both sides (host clock, synchronised,
  after a warm-up).
- ``infer``: ``cli.infer --preset hstu_flagship --maxlen 1023`` (exact)
  under ``torchrun --nproc_per_node N`` on a seeded checkpoint of the
  flagship model, against one process on one card: the ``id100.u64bin``
  files byte-equal.
- ``tp`` (tensor parallelism; ``--cases tp`` runs the three):
  ``tp_sparse``, sharded_multihost ``--maxlen 1023`` (B=64, sparse
  ``item_emb``, the sampled softmax) on data N/2 x model 2, and
  ``tp_flagship_seq2``, the flagship on data N/4 x model 2 x seq 2 (the
  unfused ring on each shard's heads), both f32 with the limits of
  ``bce_dp_seq2`` (a model mesh runs its blocks unfused, which round
  elsewhere than the single device's fused kernels in bf16: ``pos_emb``'s
  gradient at cosine 0.9982 on four cards); the tensor-parallel leaves' gradients and
  parameters gathered whole over the model group before they are held;
  ``tp_cli``, ``cli.train --preset sharded_multihost --maxlen 1023`` for
  one epoch under ``torchrun --nproc_per_node N`` without
  ``--mesh_model`` (the preset's model = 2, the rest on data): the mesh
  line, finite losses in ``train.log``, a checkpoint whose table extents
  are one a (data, model) shard.
- ``pp`` (pipeline parallelism; ``--cases pp`` runs the three):
  ``pp4_flagship``, the flagship on pipe N (4 stages of 2 blocks at N = 4)
  and ``pp2_flagship``, the flagship on pipe 2 x data N/2, each with 8
  microbatches a data column, f32 with the limits of ``bce_dp_seq2``; the
  stacked block leaves' gradients and parameters gathered whole over the
  pipe group before they are held; ``pp_cli``, ``cli.train --preset
  hstu_flagship --maxlen 1023 --mesh_pipe 2 --mesh_data N/2
  --pp_microbatches 8`` for one epoch under ``torchrun --nproc_per_node
  N``: the mesh line, finite losses, a checkpoint whose table extents are
  one a (pipe, data) shard while the block leaves are whole. (``--small``
  runs them at 4 blocks and 16 rows, 4 microbatches.)

Dropout 0, tower dedup off (several processes gate it off). Prints the
card line, one line per check ending in ``ok`` or ``FAIL`` (also on
stderr), and a last line ``NCCL_DP {json}``; exits non-zero if a check
failed. ``--cases`` runs some of them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "nccl_dp"
FIXTURE = dict(num_users=1024, num_items=5000, min_seq=256, max_seq=1000,
               seed=21)
#: (preset, maxlen, batch, loss, seq, dtype) of each case
CASES = {"bce_dp": ("hstu_flagship", 1023, 128, "bce", 1, "bfloat16"),
         "softmax_dp": ("sampled_softmax_dp", 255, 64, "sampled_softmax", 1,
                        "bfloat16"),
         "bce_dp_seq2": ("hstu_flagship", 1023, 128, "bce", 2, "float32"),
         "sparse_100m": (None, 1023, 64, "bce", 1, "bfloat16"),
         "topk": (None, None, None, None, 1, "float32"),
         "infer": ("hstu_flagship", 1023, 128, None, 1, "bfloat16"),
         "tp_sparse": ("sharded_multihost", 1023, 64, "sampled_softmax", 1,
                       "float32"),
         "tp_flagship_seq2": ("hstu_flagship", 1023, 128, "bce", 2,
                              "float32"),
         "tp_cli": ("sharded_multihost", 1023, 64, None, 1, "bfloat16"),
         "pp4_flagship": ("hstu_flagship", 1023, 128, "bce", 1, "float32"),
         "pp2_flagship": ("hstu_flagship", 1023, 128, "bce", 1, "float32"),
         "pp_cli": ("hstu_flagship", 1023, 128, None, 1, "bfloat16")}
#: the model axis of the tensor-parallel cases (1 elsewhere)
MODEL_AXIS = {"tp_sparse": 2, "tp_flagship_seq2": 2}
#: the pipe axis of the pipeline-parallel cases (0: every process; 1
#: elsewhere), and their microbatches a data column (--small: 4)
PIPE_AXIS = {"pp4_flagship": 0, "pp2_flagship": 2}
PP_MICROBATCHES = 8
#: --cases names that stand for several cases
CASE_GROUPS = {"tp": ("tp_sparse", "tp_flagship_seq2", "tp_cli"),
               "pp": ("pp4_flagship", "pp2_flagship", "pp_cli")}
#: the cases that run their own processes (not the workers' mesh)
OWN_PROCESSES = ("infer", "tp_cli", "pp_cli")
#: the topk case's corpora (rows, width) and queries; --small's
TOPK = dict(int8=100_000_000, f32=25_000_000, D=64, Q=1024, k=10, seed=91)
TOPK_SMALL = dict(TOPK, int8=200_003, f32=50_001, Q=64)
#: rows of a table drawn on a card at a time, each chunk from its own seed
CHUNK = 1 << 22
SMALL = dict(maxlen=63, batch=8, hidden_units=16, num_blocks=2)
#: the sparse case's rehearsal on the CPU: 50,000 items at packed scale
SMALL_ITEMS = 50_000
#: untouched rows of a block held bitwise
SAMPLE = 100_000
STEPS = 6
TIMEOUT = 600


def log(*a):
    print(*a, flush=True)
    text = " ".join(map(str, a))
    if "FAIL" in text:
        print(text, file=sys.stderr, flush=True)


def _world(case, small):
    """(model, config, item tables, first global batch) of ``case``."""
    sys.path.insert(0, str(ROOT))
    from tencent_recommendation_2025_tpu_torch.cli import train as TRN
    from tencent_recommendation_2025_tpu_torch.data.dataset import \
        TrainSampler
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.pipeline import (
        TrainLoader, train_val_split)
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    preset, maxlen, batch, loss, _, dtype = CASES[case]
    args = ["--preset", preset, "--maxlen", str(maxlen), "--batch_size",
            str(batch), "--dropout_rate", "0", "--dtype", dtype,
            "--loss_type", loss]
    if small:
        args += _small_args(case)
    cfg = TRN.build_config(TRN.get_args(args))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, tower_dedup=False))
    data = TencentGRData(WORK / "data", mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    tr, _ = train_val_split(len(sampler), cfg.train.valid_fraction,
                            cfg.train.seed)
    b = next(iter(TrainLoader(sampler, tr, cfg.train.batch_size,
                              seed=cfg.train.seed).epoch(1)))
    if loss == "sampled_softmax":
        b["sampled_neg_ids"] = TR._sample_negatives(
            cfg, data.itemnum, (cfg.train.seed, 97, 1, 0))
    return model, cfg, tables, b


def _small_args(case):
    """The --small widths of ``case``'s cli.train arguments: a pipe case's
    blocks and rows split over 4 stages and 4 microbatches."""
    pp = case.startswith("pp")
    return ["--maxlen", str(SMALL["maxlen"]), "--batch_size",
            str(16 if pp else SMALL["batch"]), "--hidden_units",
            str(SMALL["hidden_units"]), "--num_blocks",
            str(4 if pp else SMALL["num_blocks"])]


def _pipe_mesh_config(case, nproc, small):
    """The MeshConfig keys of a pipeline-parallel case (none elsewhere)."""
    if case not in PIPE_AXIS:
        return {}
    return dict(pipe=PIPE_AXIS[case] or nproc,
                pp_microbatches=4 if small else PP_MICROBATCHES)


def _sparse_world(small):
    """(model, config, feature tables as ``trainer.device_tables`` gives
    them on the CPU, batch) of the sparse case: chip_smoke's
    100M-row step, or its rehearsal at SMALL_ITEMS items (the packed-scale
    threshold lowered to them) and SMALL widths. Of the tables the step
    takes ``array`` as it is; ``sparse`` and ``mm`` give their widths to
    the full-size ones (:func:`_static_tables`)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    import torch

    from tencent_recommendation_2025_tpu_torch.config import (
        MM_EMB_DIMS, Config, ModelConfig, TrainConfig)
    from tencent_recommendation_2025_tpu_torch.data import schema as S
    from tencent_recommendation_2025_tpu_torch.data.featurizer import \
        FusedVocab
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST

    c = dict(CS.SPARSE_100M)
    if small:
        ST.TABLE_PACK_MIN_ROWS = SMALL_ITEMS
        c.update(itemnum=SMALL_ITEMS, B=SMALL["batch"],
                 L=SMALL["maxlen"] + 1, blocks=SMALL["num_blocks"],
                 feature_rows=1000)
    cfg = Config(
        model=ModelConfig(hidden_units=c["D"], num_blocks=c["blocks"],
                          num_heads=c["heads"], maxlen=c["L"] - 1,
                          block_type="hstu", ffn_type="swiglu",
                          reference_init=False, dtype="bfloat16",
                          table_dtype="bfloat16", dropout_rate=0.0),
        train=TrainConfig(batch_size=c["B"], loss_type="bce", l2_emb=0.0,
                          weight_decay=0.0, sparse_tables=("item_emb",),
                          table_optimizer="rowwise_adagrad",
                          table_moments_dtype="bfloat16"))
    vocab = {fid: 50 for fid in (*S.USER_SPARSE_IDS, *S.ITEM_SPARSE_IDS,
                                 *S.USER_ARRAY_IDS, *S.ITEM_ARRAY_IDS)}
    schema = FeatureSchema(vocab=vocab, mm_emb_ids=("81",), array_cap=8)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=c["usernum"],
                        itemnum=c["itemnum"])
    rng = np.random.default_rng(0)
    batch = CS.synthetic_batch(rng, c["B"], c["L"], schema, c["itemnum"],
                               c["usernum"])
    n = c["feature_rows"] + 1
    sparse_t = rng.integers(0, 50, (n, len(S.ITEM_SPARSE_IDS)))
    sparse_t[0] = 0
    tables = {"sparse": torch.as_tensor(sparse_t.astype(np.int32)),
              "array": torch.zeros((n, len(S.ITEM_ARRAY_IDS), 8),
                                   dtype=torch.int32),
              "mm": {"81": torch.as_tensor(rng.standard_normal(
                  (n, MM_EMB_DIMS["81"])).astype(np.float32))}}
    return model, cfg, tables, batch


def _samples(uids, Vp, S):
    """SAMPLE untouched ids of each of the S row blocks of a Vp-row table
    (row 0 and the pad rows excluded), seeded by the block."""
    out = []
    rps = Vp // S
    for s in range(S):
        rng = np.random.default_rng(1 + s)
        cand = rng.integers(max(s * rps, 1), (s + 1) * rps,
                            SAMPLE + SAMPLE // 4)
        out.append(np.unique(cand[~np.isin(cand, uids)])[:SAMPLE])
    return out


def _drawn_rows(lo, hi, width, seed, device, integer=False):
    """Rows [lo, hi) of a seeded [*, width] table (f32 normal, or int32 in
    [0, 50) with ``integer``) drawn on ``device`` CHUNK rows at a time,
    chunk c from a generator of its own: every process draws the same rows
    for the same range, and only the chunks that hold them."""
    import torch

    out = torch.empty((hi - lo, width), device=device,
                      dtype=torch.int32 if integer else torch.float32)
    for c in range(lo // CHUNK, -(-hi // CHUNK)):
        a = c * CHUNK
        gen = torch.Generator(device=device).manual_seed(seed * 1_000_003
                                                         + c)
        t = torch.randint(0, 50, (CHUNK, width), generator=gen,
                          dtype=torch.int32, device=device) if integer \
            else torch.randn((CHUNK, width), generator=gen, device=device)
        s0, s1 = max(lo, a), min(hi, a + CHUNK)
        out[s0 - lo:s1 - lo] = t[s0 - a:s1 - a]
        del t
    return out


def _drawn_int8(lo, hi, width, seed, device):
    """:func:`_drawn_rows`' f32 rows [lo, hi) as int8 codes and scales,
    quantized on ``device`` a chunk at a time (the f32 rows are never held
    whole)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.retrieval import mips as MIPS

    codes = torch.empty((hi - lo, width), dtype=torch.int8, device=device)
    scales = torch.empty((hi - lo,), dtype=torch.float32, device=device)
    for a in range(lo - lo % CHUNK, hi, CHUNK):
        s0, s1 = max(lo, a), min(hi, a + CHUNK)
        c, sc = MIPS.quantize_corpus_int8(
            _drawn_rows(s0, s1, width, seed, device), device)
        codes[s0 - lo:s1 - lo], scales[s0 - lo:s1 - lo] = c, sc
    return codes, scales


def _shard_extent(n, mesh):
    """(lo, hi, rows a shard) of this process's rows of an n-row table
    sharded over every axis of ``mesh``, (0, n, n) without one."""
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        world_shards

    if mesh is None:
        return 0, n, n
    rows = -(-n // world_shards(mesh))
    lo = min(mesh.rank * rows, n)
    return lo, min(lo + rows, n), rows


def _pad_to(t, rows):
    import torch

    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],)
                                     + tuple(t.shape[1:]))])


def _run_topk(small, device, mesh):
    """The topk case on ``mesh`` (this process's shard of each corpus) or
    on one device (the whole corpora): ({tier: (scores, ids)}, corpus
    bytes this device holds a tier, {tier: ms of a timed call after one
    warm-up})."""
    import torch

    from tencent_recommendation_2025_tpu_torch.retrieval import mips as MIPS

    c = TOPK_SMALL if small else TOPK
    D, k = c["D"], c["k"]
    gen = torch.Generator(device=device).manual_seed(c["seed"])
    q = torch.randn((c["Q"], D), generator=gen, device=device)
    out, held, ms = {}, {}, {}

    def timed(name, fn):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        s, i = fn()
        _sync(device)
        ms[name] = (time.perf_counter() - t0) * 1e3
        out[name] = (s.cpu().numpy(), i.cpu().numpy())

    n = c["int8"]
    lo, hi, rows = _shard_extent(n, mesh)
    codes, scales = _drawn_int8(lo, hi, D, c["seed"] + 1, device)
    held["int8"] = codes.numel() + scales.numel() * 4
    if mesh is None:
        timed("int8", lambda: MIPS.topk_mips_int8(q, codes, scales, k=k))
    else:
        scales = torch.cat([scales, scales.new_ones(rows - scales.shape[0])])
        corpus = MIPS.ShardedCorpus(mesh, [(_pad_to(codes, rows), scales)],
                                    n, rows)
        timed("int8", lambda: MIPS.sharded_topk_mips_int8(mesh, q, corpus,
                                                          k=k))
        del corpus
    del codes, scales
    _free(device)
    n = c["f32"]
    lo, hi, rows = _shard_extent(n, mesh)
    rows_f = _drawn_rows(lo, hi, D, c["seed"] + 2, device)
    held["f32"] = rows_f.numel() * 4
    for name, approx in (("exact", False), ("approx", True)):
        if mesh is None:
            fn = MIPS.topk_mips_approx if approx else MIPS.topk_mips
            timed(name, lambda: fn(q, rows_f, k=k))
        else:
            corpus = MIPS.ShardedCorpus(mesh, [_pad_to(rows_f, rows)], n,
                                        rows)
            timed(name, lambda: MIPS.sharded_topk_mips(mesh, q, corpus, k=k,
                                                       approx=approx))
    del rows_f
    _free(device)
    return out, held, ms


def _sync(device):
    import torch

    if str(device) != "cpu":
        torch.cuda.synchronize()


def _static_tables(tables, V, mesh, device):
    """The sparse case's static item tables at V rows (``sparse`` and
    ``mm["81"]`` at ``tables``' widths; ``array`` as ``tables`` holds it):
    drawn whole without a mesh, else only this process's row block
    (``parallel.mesh.table_index``), zero-padded, as a ``StaticTable``."""
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        table_index, table_shards)
    from tencent_recommendation_2025_tpu_torch.parallel.sharded_embedding \
        import StaticTable

    rows = -(-V // table_shards(mesh))
    lo = min(table_index(mesh) * rows, V)
    hi = min(lo + rows, V)
    sp = _drawn_rows(lo, hi, tables["sparse"].shape[1], 7, device,
                     integer=True)
    mm = _drawn_rows(lo, hi, tables["mm"]["81"].shape[1], 8, device)
    if mesh is not None:
        sp, mm = (StaticTable([_pad_to(t, rows)], mesh, V) for t in (sp, mm))
    return {"sparse": sp, "array": tables["array"].to(device),
            "mm": {"81": mm}}


def _run_sparse(small, device, mesh, shards):
    """The sparse case's step from the seeded state, then STEPS timed
    after 2: (loss, the replicated leaves' gradients, their parameters, the
    rows of the table this process holds {"lo", "uids", "rows", "sample",
    "sampled"} after the first step, group-scatter launches of it, ms a
    step). The untouched sample is :func:`_samples`' of ``shards`` blocks:
    this process's block's, all of them without a mesh."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        table_index, table_shards)
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    model, cfg, tables, batch = _sparse_world(small)
    S = table_shards(mesh)
    b = TR.augment_batch_sparse(batch, cfg, model.itemnum, (0, 1),
                                n_table_shards=S)
    uids = b["touched_uids"]
    state = PT.init_sharded_state(model, cfg, mesh, seed=5, device=device)
    table = state.params["item_emb"]
    rps = table.shape[0]
    lo = table_index(mesh) * rps
    real = uids[(uids >= lo) & (uids < lo + rps) & (uids > 0)]
    samples = _samples(uids, rps * S, shards)
    sample = np.concatenate(samples) if mesh is None \
        else samples[table_index(mesh)]
    tabs = _static_tables(tables, model.itemnum + 1, mesh, device)
    static_bytes = sum(t.numel() * t.element_size() for t in (
        [tabs["sparse"], tabs["mm"]["81"]] if mesh is None else
        [tabs["sparse"].blocks[0], tabs["mm"]["81"].blocks[0]]))
    bd = TR.put_batch(b, device)
    step = TR.make_train_step(model, cfg, mesh)
    n0 = ST.group_scatter.launches
    state, m = step(state, bd, tabs["mm"], tabs)
    launches = ST.group_scatter.launches - n0
    loss = float(m["loss"])
    rows = {"lo": np.int64(lo), "block_rows": np.int64(rps),
            "static_bytes": np.int64(static_bytes),
            "uids": real, "sample": sample,
            "rows": table[torch.from_numpy(real - lo).long().to(
                table.device)].float().cpu().numpy(),
            "sampled": table[torch.from_numpy(sample - lo).long().to(
                table.device)].view(torch.int16).cpu().numpy()}
    dense = dict(TR.dense_leaves(state.params, cfg))
    grads = {p: t.grad.float().cpu().numpy() for p, t in dense.items()
             if p.split("/")[0] not in ("user_emb", "fused_feat")}
    params = {p: t.detach().float().cpu().numpy() for p, t in dense.items()
              if p.split("/")[0] not in ("user_emb", "fused_feat")}

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    for _ in range(2):
        state, m = step(state, bd, tabs["mm"], tabs)
    sync()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, m = step(state, bd, tabs["mm"], tabs)
    sync()
    ms = (time.perf_counter() - t0) / STEPS * 1e3
    del state, table, bd, tabs
    return loss, grads, params, rows, launches, ms


def _run(case, small, device, mesh):
    """One step from the seeded state, then STEPS timed after 2: (loss,
    gradients by leaf, parameters after the first step, candidates the
    sampled softmax took, the step's ep_overflow or -1, ms a step, the
    first step's (grad_max, grad_mean)). On a
    mesh a row-sharded table's gradient and parameter are this process's
    rows, keyed ``<leaf>@<first row>``."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import losses as LS
    from tencent_recommendation_2025_tpu_torch.parallel import \
        partition as PP
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        gather_pipe, pipe_size, table_index, table_shards)
    from tencent_recommendation_2025_tpu_torch.parallel.sharded_embedding \
        import SHARDED_TABLES
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    model, cfg, tables, batch = _world(case, small)
    state = PT.init_sharded_state(model, cfg, mesh, seed=5, device=device)
    tabs = TR.device_tables(tables, device, mesh)   # static tables sharded
    if cfg.train.sparse_tables:
        batch = TR.augment_batch_sparse(
            batch, cfg, model.itemnum, (cfg.train.seed, 97, 1, 0),
            n_table_shards=table_shards(mesh), usernum=model.usernum)
    b = TR.put_batch(batch, device)
    step = PT.make_sharded_train_step(model, cfg, mesh)
    seen, loss_fn = [], LS.sampled_softmax_loss

    def spy(query, pos, negs, neg_ids, *a, **kw):
        seen.append(neg_ids.detach().cpu().clone())
        return loss_fn(query, pos, negs, neg_ids, *a, **kw)

    LS.sampled_softmax_loss = spy
    try:
        state, m = step(state, b, tabs["mm"], tabs)
    finally:
        LS.sampled_softmax_loss = loss_fn
    loss = float(m["loss"])
    overflow = int(m.get("ep_overflow", -1))
    grad_metrics = np.array([float(m["grad_max"]), float(m["grad_mean"])])

    def key(p, t):
        if state.layout is None or p not in SHARDED_TABLES:
            return p
        return f"{p}@{table_index(mesh) * t.shape[0]}"

    split = PP.model_dims(state.params) \
        if mesh is not None and mesh.shape["model"] > 1 else {}

    def whole(p, t):
        """A tensor-parallel leaf's slice gathered whole over the model
        group, a stage's blocks over the pipe group (every rank calls it,
        in the same order)."""
        if pipe_size(mesh) > 1 and p.startswith("blocks/"):
            return gather_pipe(t, mesh)
        if p not in split:
            return t
        return PP.join_model(mesh, t, p, split[p])

    grads = {key(p, t): whole(p, t.grad).float().cpu().numpy()
             for p, t in TR.param_leaves(state.params)
             if t.grad is not None}
    params = {key(p, t): whole(p, t.detach()).float().cpu().numpy()
              for p, t in TR.param_leaves(state.params)}
    cands = torch.cat(seen).numpy() if seen else np.zeros(0)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    for _ in range(2):
        state, m = step(state, b, tabs["mm"], tabs)
    sync()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, m = step(state, b, tabs["mm"], tabs)
    sync()
    ms = (time.perf_counter() - t0) / STEPS * 1e3
    return loss, grads, params, cands, overflow, ms, grad_metrics


def _worker(out_dir, device, small, cases):
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        build_mesh, initialize_distributed)

    initialize_distributed(device)
    res = {}
    for case in cases:
        seq = CASES[case][4]
        mesh = build_mesh(MeshConfig(seq=seq, model=MODEL_AXIS.get(case, 1),
                                     **_pipe_mesh_config(
                                         case, dist.get_world_size(),
                                         small)))
        res[f"{case}:shape"] = np.array([mesh.shape["data"],
                                         mesh.shape["model"],
                                         mesh.shape["seq"]])
        res[f"{case}:pipe"] = np.int64(mesh.shape["pipe"])
        if case == "topk":
            out, held, ms = _run_topk(small, device, mesh)
            for tier, (sc, ids) in out.items():
                res[f"topk:{tier}:scores"], res[f"topk:{tier}:ids"] = sc, ids
                res[f"topk:{tier}:ms"] = np.float64(ms[tier])
            res.update({f"topk:held:{t}": np.int64(v)
                        for t, v in held.items()})
            dist.barrier()
            _free(device)
            continue
        if case == "sparse_100m":
            loss, grads, params, rows, launches, ms = _run_sparse(
                small, device, mesh, mesh.shape["data"])
            res.update({f"{case}:rows:{k}": v for k, v in rows.items()})
            res[f"{case}:launches"] = np.int64(launches)
            cands, overflow = np.zeros(0), -1
        else:
            loss, grads, params, cands, overflow, ms, gm = _run(
                case, small, device, mesh)
            res[f"{case}:grad_metrics"] = gm
        res[f"{case}:loss"] = np.float64(loss)
        res[f"{case}:cands"] = cands
        res[f"{case}:overflow"] = np.int64(overflow)
        res[f"{case}:ms"] = np.float64(ms)
        res.update({f"{case}:param:{p}": v for p, v in params.items()})
        if mesh.rank == 0:
            res.update({f"{case}:grad:{p}": v for p, v in grads.items()})
        dist.barrier()
        _free(device)
    np.savez(Path(out_dir) / f"rank{dist.get_rank()}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def _free(device):
    import gc

    import torch

    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def _rows_of(single, key):
    """The single device's leaf for a rank's key: ``<leaf>@<first row>``
    is that rank's block of a row-sharded table (zeros past the table's
    rows: the shard padding)."""
    if "@" not in key:
        return None, single[key]
    leaf, lo = key.split("@")
    return leaf, single[leaf][int(lo):]


def _held(got, want):
    """``want`` (the single device's rows from a block's first row) cut or
    zero-extended to ``got``'s rows."""
    n = min(len(got), len(want))
    out = np.zeros_like(got)
    out[:n] = want[:n]
    return out


def _cos(a, b):
    a, b = a.reshape(-1).astype(np.float64), b.reshape(-1).astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return 1.0 if na == 0.0 and nb == 0.0 else float(a @ b / (na * nb))


def main() -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--nproc", default=4, type=int)
    p.add_argument("--small", action="store_true",
                   help="CPU rehearsal widths (L=64, D=16, 2 blocks, B=8)")
    p.add_argument("--cases", default=",".join(CASES),
                   help="comma-separated cases to run")
    args = p.parse_args()
    cases = [c for name in args.cases.split(",")
             for c in CASE_GROUPS.get(name, (name,))]
    sys.path.insert(0, str(ROOT))
    import torch

    from tencent_recommendation_2025_tpu_torch.data import synthetic

    card = "cpu"
    if args.device == "cuda":
        if torch.cuda.device_count() < args.nproc:
            log(f"nccl_dp_check: {args.nproc} cards wanted, "
                f"{torch.cuda.device_count()} present FAIL")
            return 2
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        card = "; ".join(out.stdout.strip().splitlines())
        from tencent_recommendation_2025_tpu_torch.ops import kernels

        kernels.build_all()       # once, before the workers load it
    log(card)
    out_dir = WORK / "out"
    out_dir.mkdir(parents=True, exist_ok=True)
    if not (WORK / "data").exists():
        fixture = dict(FIXTURE, num_users=64) if args.small else FIXTURE
        synthetic.generate(WORK / "data", mm_emb_ids=("81",), **fixture)
    # the single device first, alone on its card (its steps are timed)
    dev = "cuda:0" if args.device == "cuda" else "cpu"
    one = {}
    runs = {"sparse_100m": lambda: _run_sparse(args.small, dev, None,
                                               args.nproc),
            "topk": lambda: _run_topk(args.small, dev, None)}
    for case in cases:
        if case not in OWN_PROCESSES:
            one[case] = runs.get(case, lambda: _run(case, args.small, dev,
                                                    None))()
        _free(args.device)
    mesh_cases = [c for c in cases if c not in OWN_PROCESSES]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(args.nproc if mesh_cases else 0):
        env = dict(os.environ, WORLD_SIZE=str(args.nproc), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(out_dir), args.device, "1" if args.small else "0",
             ",".join(mesh_cases)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    ok = True
    for rank, pr in enumerate(procs):
        try:
            text, _ = pr.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log(f"nccl_dp_check: workers exceeded {TIMEOUT} s FAIL")
            return 1
        if pr.returncode != 0:
            log(f"rank {rank} exited {pr.returncode} FAIL:\n{text[-4000:]}")
            ok = False
    if not ok:
        return 1
    ranks = [np.load(out_dir / f"rank{r}.npz") for r in range(args.nproc)] \
        if mesh_cases else []
    summary = {}
    for case in cases:
        if case in OWN_PROCESSES:
            ok_c, summary[case] = {"infer": _check_infer,
                                   "tp_cli": _check_tp_cli,
                                   "pp_cli": _check_pp_cli}[case](args)
            ok &= ok_c
            continue
        dtype = CASES[case][5]
        r0 = ranks[0]
        shape = tuple(int(x) for x in r0[f"{case}:shape"])
        if case == "topk":
            ok_c, summary[case] = _check_topk(
                one[case], ranks, shape, TOPK_SMALL if args.small else TOPK)
            ok &= ok_c
            continue
        mesh_ms = max(float(r[f"{case}:ms"]) for r in ranks)
        if case == "sparse_100m":
            ok_c, summary[case] = _check_sparse(case, one[case], ranks,
                                                shape, mesh_ms)
            ok &= ok_c
            continue
        loss, grads, params1, cands, _, ms, gm = one[case]
        rel_lim = 1e-5 if dtype == "float32" else 1e-4
        rel = abs(float(r0[f"{case}:loss"]) - loss) / abs(loss)
        # grad_max and grad_mean over the whole leaves, on every rank; a
        # row-sharded table's mean counts its pad rows, as on the JAX mesh
        # (about 7e-5 of grad_mean at the fixture's 5,001 rows over 4
        # shards), where a block leaf reduced over the wrong group is 2x
        gm_rel = max(float(np.max(np.abs(r[f"{case}:grad_metrics"] - gm)
                                  / np.abs(gm))) for r in ranks)
        gm_ok = gm_rel <= 1e-3 or dtype != "float32"
        pre = f"{case}:grad:"
        worst = min((_cos(r0[k], _held(r0[k], _rows_of(grads,
                                                       k[len(pre):])[1])),
                     k[len(pre):]) for k in r0.files if k.startswith(pre))
        pre = f"{case}:param:"
        equal = all(np.array_equal(r[k], r0[k]) for r in ranks[1:]
                    for k in r0.files if k.startswith(pre) and "@" not in k)
        rows_ok = all(_cos(r[k], _held(r[k], _rows_of(
            params1, k[len(pre):])[1])) >= 0.999
            for r in ranks for k in r.files
            if k.startswith(pre) and "@" in k)
        same_cands = all(np.array_equal(r[f"{case}:cands"], cands)
                         for r in ranks)
        overflow = int(r0[f"{case}:overflow"])
        ok_c = equal and same_cands and rows_ok and gm_ok
        held = rel <= rel_lim and worst[0] >= 0.999
        if overflow > 0:
            note = (f"the single-device comparison does not apply: "
                    f"{overflow} ids overflowed")
        else:
            ok_c &= held
            note = ""
        ok &= ok_c
        pipe = int(r0[f"{case}:pipe"])
        summary[case] = dict(mesh=shape, pipe=pipe, dtype=dtype,
                             loss_rel=rel,
                             lowest_cos=worst[0], replicas_equal=equal,
                             grad_metrics_rel=gm_rel,
                             table_rows_held=rows_ok, ep_overflow=overflow,
                             candidates_equal=same_cands,
                             mesh_ms=mesh_ms, single_ms=ms)
        log(f"{case}: {args.nproc} processes, mesh (data, model, seq) "
            f"{shape}" + (f" x pipe {pipe}" if pipe > 1 else "") + ", "
            f"{dtype}, ep_overflow {overflow}: loss "
            f"{float(r0[f'{case}:loss']):.6f} against one process's "
            f"{loss:.6f} (relative {rel:.2e}, limit {rel_lim:g}); lowest "
            f"gradient cosine {worst[0]:.6f} ({worst[1]}, limit 0.999) "
            f"{note}; grad_max / grad_mean relative {gm_rel:.2e} (limit "
            f"1e-3 in float32); replicated parameters after the step bitwise equal on "
            f"every rank {equal}; each rank's table rows against one "
            f"process's {rows_ok}; candidates ({len(cands)}) equal on every "
            f"rank and to one process's {same_cands}; step {mesh_ms:.3f} ms "
            f"on the mesh (slowest rank) against {ms:.3f} ms in one process "
            f"(host clock, synchronised, {STEPS} after 2) "
            f"{'ok' if ok_c else 'FAIL'}")
    print("NCCL_DP " + json.dumps({"device": card, "nproc": args.nproc,
                                   "cases": summary}), flush=True)
    return 0 if ok else 1


def _check_topk(single, ranks, shape, sizes):
    """The topk case's checks of every rank against one card (``sizes``:
    TOPK or TOPK_SMALL)."""
    out1, held1, ms1 = single
    ok, summary = True, {}
    for tier, (s1, i1) in out1.items():
        rel = 2.0 ** -8 if tier == "int8" else 1e-5
        r0 = ranks[0]
        s, i = r0[f"topk:{tier}:scores"], r0[f"topk:{tier}:ids"]
        same = all(np.array_equal(r[f"topk:{tier}:ids"], i) for r in ranks)
        diff = i != i1
        close = np.abs(s - s1) <= rel * np.maximum(np.abs(s), np.abs(s1))
        ties = bool((close | ~diff).all())
        recall = float(np.mean([len(set(a) & set(b)) / len(b)
                                for a, b in zip(i.tolist(), i1.tolist())]))
        held = [int(r[f"topk:held:{'int8' if tier == 'int8' else 'f32'}"])
                for r in ranks]
        ms = max(float(r[f"topk:{tier}:ms"]) for r in ranks)
        ok_t = same and ties and recall >= 0.999
        ok &= ok_t
        summary[tier] = dict(places_differ=int(diff.sum()), all_ties=ties,
                             recall=recall, ranks_equal=same,
                             held_bytes=held, mesh_ms=ms,
                             single_ms=ms1[tier])
        corpus = sizes["int8" if tier == "int8" else "f32"]
        log(f"topk {tier}: {len(ranks)} processes, mesh (data, model, seq) {shape}"
            f", {corpus} x {sizes['D']}: ids against one card's: "
            f"{int(diff.sum())} places differ, every one a tie within "
            f"{rel:g} relative {ties}; recall@10 {recall:.6f} (limit 0.999); "
            f"every rank the same ids {same}; corpus bytes a card "
            f"{[round(b / 1e9, 3) for b in held]} GB (one card alone "
            f"{held1['int8' if tier == 'int8' else 'f32'] / 1e9:.3f} GB); "
            f"{ms:.1f} ms on the mesh (slowest rank) against {ms1[tier]:.1f} "
            f"ms on one card ({len(i)} queries; host clock, synchronised, "
            f"after 1) {'ok' if ok_t else 'FAIL'}")
    return ok, summary


def _infer_args(args):
    preset, maxlen, batch, _, _, _ = CASES["infer"]
    out = ["--preset", preset, "--maxlen", str(maxlen), "--batch_size",
           str(batch), "--device", args.device, "--num_workers", "2",
           "--ann_method", "exact"]
    if args.small:
        out += ["--maxlen", str(SMALL["maxlen"]), "--hidden_units",
                str(SMALL["hidden_units"]), "--num_blocks",
                str(SMALL["num_blocks"]), "--dtype", "float32"]
    return out


def _check_infer(args):
    """The infer case: a seeded checkpoint of the model ``cli.infer``
    builds from :func:`_infer_args`, served by one process and under
    ``torchrun`` by N; the result files compared byte for byte."""
    import torch

    from tencent_recommendation_2025_tpu_torch.cli import infer as INF
    from tencent_recommendation_2025_tpu_torch.config import PRESETS
    from tencent_recommendation_2025_tpu_torch.data.featurizer import \
        FusedVocab
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    a = INF.get_args(_infer_args(args))
    cfg = PRESETS[a.preset]()
    over = {k: getattr(a, k) for k in ("hidden_units", "num_blocks",
                                       "maxlen", "dtype")
            if getattr(a, k) is not None}
    mc = dataclasses.replace(cfg.model, **over)
    data = TencentGRData(WORK / "data", mm_emb_ids=("81",), split="test")
    schema = FeatureSchema.from_indexer(data.indexer, ("81",),
                                        cfg.features.array_cap)
    model = SeqRecModel(cfg=mc, schema=schema, fused=FusedVocab.build(schema),
                        usernum=data.usernum, itemnum=data.itemnum)
    ckpt = WORK / "infer_ckpt"
    if not ckpt.exists():
        CK.save_params(ckpt, model.init(torch.Generator().manual_seed(5)),
                       model_config=mc)
    base = dict(os.environ, PYTHONPATH=str(ROOT),
                EVAL_DATA_PATH=str(WORK / "data"),
                MODEL_OUTPUT_PATH=str(ckpt))
    mod = "tencent_recommendation_2025_tpu_torch.cli.infer"
    res, secs = {}, {}
    for side, pre in (("one", []), ("mesh", [
            "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(args.nproc)])):
        out = WORK / f"infer_{side}"
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable] + pre + ["-m", mod]
                             + _infer_args(args),
                             env=dict(base, EVAL_RESULT_PATH=str(out)),
                             capture_output=True, text=True, timeout=TIMEOUT)
        secs[side] = time.perf_counter() - t0
        if run.returncode != 0:
            log(f"infer {side}: exited {run.returncode} FAIL:\n"
                f"{(run.stdout + run.stderr)[-4000:]}")
            return False, {}
        hr = [ln for ln in run.stdout.splitlines() if ln.startswith("HR@10")]
        res[side] = ((out / "id100.u64bin").read_bytes(), hr)
    equal = res["one"][0] == res["mesh"][0] and len(res["one"][0]) > 8
    ok = equal and len(res["mesh"][1]) == 1 and res["mesh"][1] == \
        res["one"][1]
    log(f"infer: cli.infer {' '.join(_infer_args(args))} under torchrun "
        f"--nproc_per_node {args.nproc} ({secs['mesh']:.1f} s) against one "
        f"process ({secs['one']:.1f} s): id100.u64bin byte-equal {equal} "
        f"({len(res['one'][0])} bytes); {res['mesh'][1]} / {res['one'][1]} "
        f"{'ok' if ok else 'FAIL'}")
    return ok, dict(equal=equal, mesh_s=secs["mesh"], one_s=secs["one"])


def _check_tp_cli(args):
    """The tp_cli case: ``cli.train --preset sharded_multihost`` (one epoch
    of the fixture) under ``torchrun --nproc_per_node N`` with no
    ``--mesh_model``: it exits 0 on data N/2 x model 2, its train.log
    losses are finite, and its checkpoint's item table has one extent a
    (data, model) shard while the tensor-parallel leaves are whole."""
    preset, maxlen, batch, _, _, _ = CASES["tp_cli"]
    cli = ["--preset", preset, "--maxlen", str(maxlen), "--batch_size",
           str(batch), "--device", args.device, "--num_workers", "2",
           "--num_epochs", "1"]
    if args.small:
        cli += _small_args("tp_cli") + ["--dtype", "float32"]
    out = WORK / "tp_cli"
    if out.exists():          # a checkpoint of an earlier run is no proof
        shutil.rmtree(out)
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               TRAIN_DATA_PATH=str(WORK / "data"),
               TRAIN_LOG_PATH=str(out / "logs"),
               TRAIN_CKPT_PATH=str(out / "ckpt"))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc_per_node", str(args.nproc),
                          "-m", "tencent_recommendation_2025_tpu_torch.cli."
                          "train"] + cli, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        log(f"tp_cli: exited {run.returncode} FAIL:\n"
            f"{(run.stdout + run.stderr)[-4000:]}")
        return False, {}
    shape = {"pipe": 1, "data": args.nproc // 2, "model": 2, "seq": 1}
    mesh_line = f"mesh: {shape} over {args.nproc} processes" in run.stdout
    lines = [json.loads(ln) for ln in open(out / "logs" / "train.log")]
    losses = [ln["loss"] for ln in lines if "loss" in ln]
    finite = bool(losses) and all(np.isfinite(losses))
    sys.path.insert(0, str(ROOT))
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    ck = CK.latest_checkpoint(out / "ckpt")
    entries = {e["path"]: e for e in json.loads(
        (ck / "manifest.json").read_text())["leaves"]} if ck else {}
    extents = len(entries.get("0/item_emb", {}).get("shards", []))
    whole = "file" in entries.get("0/blocks/hstu/uvqk/w", {})
    ok = mesh_line and finite and extents == args.nproc and whole
    log(f"tp_cli: cli.train {' '.join(cli)} under torchrun --nproc_per_node "
        f"{args.nproc} ({secs:.1f} s): mesh {shape} {mesh_line}; "
        f"{len(losses)} steps, losses finite {finite} (last "
        f"{losses[-1] if losses else float('nan'):.6f}); checkpoint "
        f"{ck.name if ck else None}: item_emb in {extents} extents, uvqk "
        f"whole {whole} {'ok' if ok else 'FAIL'}")
    return ok, dict(mesh=shape, steps=len(losses), seconds=secs,
                    extents=extents)


def _check_pp_cli(args):
    """The pp_cli case: ``cli.train --preset hstu_flagship --maxlen 1023
    --mesh_pipe 2 --mesh_data N/2 --pp_microbatches 8`` (one epoch of the
    fixture) under ``torchrun --nproc_per_node N``: it exits 0 on pipe 2 x
    data N/2, its train.log losses are finite, and its checkpoint's item
    table has one extent a (pipe, data) shard while the stacked block
    leaves are whole."""
    preset, maxlen, batch, _, _, _ = CASES["pp_cli"]
    M = 4 if args.small else PP_MICROBATCHES
    cli = ["--preset", preset, "--maxlen", str(maxlen), "--batch_size",
           str(batch), "--device", args.device, "--num_workers", "2",
           "--num_epochs", "1", "--mesh_pipe", "2", "--mesh_data",
           str(args.nproc // 2), "--pp_microbatches", str(M)]
    if args.small:
        cli += _small_args("pp_cli") + ["--dtype", "float32"]
    out = WORK / "pp_cli"
    if out.exists():          # a checkpoint of an earlier run is no proof
        shutil.rmtree(out)
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               TRAIN_DATA_PATH=str(WORK / "data"),
               TRAIN_LOG_PATH=str(out / "logs"),
               TRAIN_CKPT_PATH=str(out / "ckpt"))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc_per_node", str(args.nproc),
                          "-m", "tencent_recommendation_2025_tpu_torch.cli."
                          "train"] + cli, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        log(f"pp_cli: exited {run.returncode} FAIL:\n"
            f"{(run.stdout + run.stderr)[-4000:]}")
        return False, {}
    shape = {"pipe": 2, "data": args.nproc // 2, "model": 1, "seq": 1}
    mesh_line = f"mesh: {shape} over {args.nproc} processes" in run.stdout
    lines = [json.loads(ln) for ln in open(out / "logs" / "train.log")]
    losses = [ln["loss"] for ln in lines if "loss" in ln]
    finite = bool(losses) and all(np.isfinite(losses))
    sys.path.insert(0, str(ROOT))
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    ck = CK.latest_checkpoint(out / "ckpt")
    entries = {e["path"]: e for e in json.loads(
        (ck / "manifest.json").read_text())["leaves"]} if ck else {}
    extents = len(entries.get("0/item_emb", {}).get("shards", []))
    uvqk = entries.get("0/blocks/hstu/uvqk/w", {})
    blocks = 4 if args.small else 8
    whole = "file" in uvqk and uvqk.get("shape", [0])[0] == blocks
    ok = mesh_line and finite and extents == args.nproc and whole
    log(f"pp_cli: cli.train {' '.join(cli)} under torchrun --nproc_per_node "
        f"{args.nproc} ({secs:.1f} s): mesh {shape} {mesh_line}; "
        f"{len(losses)} steps, losses finite {finite} (last "
        f"{losses[-1] if losses else float('nan'):.6f}); checkpoint "
        f"{ck.name if ck else None}: item_emb in {extents} extents, uvqk "
        f"whole ({blocks} blocks) {whole} {'ok' if ok else 'FAIL'}")
    return ok, dict(mesh=shape, steps=len(losses), seconds=secs,
                    extents=extents)


def _check_sparse(case, single, ranks, shape, mesh_ms):
    """The sparse case's checks of every rank against one process."""
    loss, grads, _, rows1, launches1, ms = single
    r0 = ranks[0]
    rel = abs(float(r0[f"{case}:loss"]) - loss) / abs(loss)
    worst = min((_cos(r0[f"{case}:grad:{p}"], g), p)
                for p, g in grads.items())
    pos = {int(u): i for i, u in enumerate(rows1["uids"])}
    lowest, bitwise, blocks, static = 1.0, True, [], []
    for r in ranks:
        blocks.append(int(r[f"{case}:rows:block_rows"]))
        static.append(int(r[f"{case}:rows:static_bytes"]))
        got = r[f"{case}:rows:rows"]
        want = rows1["rows"][[pos[int(u)] for u in r[f"{case}:rows:uids"]]]
        live = np.linalg.norm(want, axis=1) > 0
        num = (got * want).sum(1)[live]
        den = (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))[
            live]
        if live.any():
            lowest = min(lowest, float((num / den).min()))
        # the rank's untouched sample, at the same ids in one process
        at = np.searchsorted(rows1["sample"], r[f"{case}:rows:sample"])
        bitwise &= bool(np.array_equal(rows1["sample"][at],
                                       r[f"{case}:rows:sample"])) \
            and np.array_equal(rows1["sampled"][at],
                               r[f"{case}:rows:sampled"])
    launches = [int(r[f"{case}:launches"]) for r in ranks]
    ok = rel <= 1e-4 and worst[0] >= 0.999 and lowest >= 0.999 and bitwise
    log(f"{case}: {len(ranks)} processes, mesh (data, model, seq) {shape}: table "
        f"rows a rank {blocks}; static tables' bytes a card "
        f"{[round(b / 1e9, 3) for b in static]} GB (one card alone "
        f"{int(rows1['static_bytes']) / 1e9:.3f} GB); loss {float(r0[f'{case}:loss']):.6f} against "
        f"one process's {loss:.6f} (relative {rel:.2e}, limit 1e-4); lowest "
        f"replicated-gradient cosine {worst[0]:.6f} ({worst[1]}); touched "
        f"rows' lowest cosine to one process's {lowest:.6f} (limit 0.999); "
        f"sampled untouched rows bitwise equal {bitwise}; group-scatter "
        f"launches a rank {launches} (one process {launches1}); step "
        f"{mesh_ms:.3f} ms on the mesh (slowest rank) against {ms:.3f} ms "
        f"in one process {'ok' if ok else 'FAIL'}")
    return ok, dict(mesh=shape, loss_rel=rel, lowest_cos=worst[0],
                    rows_lowest_cos=lowest, untouched_equal=bitwise,
                    block_rows=blocks, static_bytes=static,
                    mesh_ms=mesh_ms, single_ms=ms)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[2], sys.argv[3], sys.argv[4] == "1",
                sys.argv[5].split(","))
    else:
        sys.exit(main())
