#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device   — require CUDA; print the card's name and power limit
               (nvidia-smi --query-gpu=name,power.limit);
2. build    — compile every kernel under tencent_recommendation_2025_tpu_torch/
               csrc/ from the checkout (nvcc, sm_90a, one process per
               source, all at once), print the seconds;
3. kernels  — each kernel against its plain PyTorch version on the card, on
               seeded inputs with left padding and one fully padded row, at
               the stated tolerances: the fused block forward in inference
               and in training (with dropout, and its av output) and its
               backward, in the whole-sequence variant (L=1024 and 256; and
               at B=128, L=1024 with H=4 heads of 16, sharded_multihost's
               shape, in f32 and bf16) and in the chunked one (L >
               wholeseq_max_l(D): 2048, 4096 and 16384 in f32 and bf16;
               D=128 and D=256 in f32), and whether the chunked variant's
               bf16 output follows its rounding point;
               then their times at both main paths' shapes (B=128, L=1024
               and B=32, L=4096; CUDA events) beside the plain versions' and
               their bounds; then the fused block's attention backward
               (csrc/hstu_attn_bwd_sm90.cuh, which the single device and
               the ring launch) against the plain pair version in bf16 at
               hd 8, 16, 32, 64 and 128 and in f32, at off 0 and +L, with
               the wgmma kernels' spills from the build (none at W <= 64),
               and its dq and dk/dv timed at the flagship, long and sparse
               shapes beside the plain versions and their bounds (TFLOP/s
               over the 7 products run); then the post half and the
               gate/FFN backward on wgmma (attn_ffn_wgmma_kernel, inference
               and training, its device time alone;
               gate_ffn_bwd_wgmma_kernel with wgrad_wgmma_kernel, alone)
               held to their plain versions, the backward bitwise equal
               across two calls, timed at the flagship, long and sparse
               shapes beside the plain versions and their own bounds, with
               their registers and spills from the build (none at D <=
               64); then the pre half on wgmma (proj_wgmma_kernel,
               proj_bwd_wgmma_kernel with wgrad_wgmma_kernel) held to its
               plain versions in bf16 at D = 32, 64, 128 and H = 1, 4
               (whole sequence, chunked at L=4096, ring stage; the
               backward bitwise equal across two calls), each kernel
               timed alone at the flagship, long, sparse and ring-stage
               shapes beside its bound and the first design's kernel
               (proj_kernel, proj_bwd_kernel: copies of the two sources
               with the wgmma selectors off, built beside the checkout's),
               with their registers and spills (none at D <= 64); then the
               attention cores, flash
               MHA (L=256, H=4; L=1024, H=1) and the standalone HSTU
               attention (L=256 and 1024, H=4 and 1, 128 and 300
               buckets; its chunked route
               at L = 2048, 4096 and 16384 and with 1000 buckets), both at
               hd 8 and hd 128, forward and backward in f32 and bf16, each
               call on its route's launch counters, fully masked rows and
               padded keys exactly 0 (flash MHA also at hd 16 with L=1024,
               hd 24, hd 256, L=384 and hd 9, its row stats held to the
               plain version's; the HSTU attention also at hd 32, at 32,
               898 and 1794 buckets, and in bf16 a second call bitwise
               equal to the first), and their times at the runs' shapes
               (hstu_mini at B=32, L=4096 for the chunked route; CUDA
               events, and the kernels' device time by the profiler)
               beside the plain versions', their bounds and, for flash MHA,
               scaled_dot_product_attention's, for the HSTU attention
               (hstu_fwd_wgmma_kernel and the shared backward's standalone
               instance in bf16) its first design's (a copy of the source
               with the wgmma route off, built beside the checkout's),
               with the wgmma kernels' registers and spills (none at W <=
               64); then the digests of the fused block's and the ring's
               outputs (bitwise_digests), held to those recorded for the
               tree before the standalone attention shared their kernels;
               then the HSTU attention's silu_qkv instances (pre-activation
               q, k, v; phase_silu): each against its plain version in f32
               and bf16 (W = 16, 64, 128 whole-sequence, the chunked route,
               hd 256 and the sliced hd 1024 on the first design), their
               own counters, a second call bitwise equal; one HSTU block
               with a fused_silu core as a path (its launches counted, its
               output and gradients held to the plain core's); at
               hstu_mini's and mini_long's shapes the fused SiLU timed
               beside silu_qkv=False with a separate SiLU pass over [B, L,
               3D], with the bounds;
               then the group scatter and
               group gather of a sparse-trained table (a 16M x 64 table, 1M
               groups, in f32 and bf16; 196,608 slots, 190,000 real groups
               and a sentinel tail, the gather also on the slots shuffled):
               bitwise equal to their plain versions, the scatter in place
               with untouched groups unchanged, timed beside the plain
               versions, index_copy_ / index_select and their bytes bound,
               the gather (timed after the library calls) and index_select
               also by device time and the gather beside its first design
               (streaming hints);
4. training — a seeded synthetic fixture (1024 users, 5000 items, sequences
               of 256..1000 events) and the port's cli.train main with
               ``--preset hstu_flagship --maxlen 1023 --loader streaming
               --num_epochs 1`` on the card; holds every kernel's launch
               count to its expected value (the other kernels' to 0), checks
               finite losses and the checkpoint; then one step at full width
               and depth on 16 rows (8 at L=4096 and for sparse) against the
               plain versions on the CPU in bf16 and in f32 (loss and
               per-leaf gradient cosine); prints
               train examples/s, the profiled step's host time (CPU self
               time summed, its 10 largest ops); for the flagship and
               mini_long the step's fused-feature lookups replayed
               (phase_lookup_bwd: the one-hot backward's table gradient
               bitwise equal over two calls on one device and on a local
               data mesh of 2, held to f64 sums, and timed beside the
               one-hot products in chunks, the index_add_ it replaced and
               a one-level segment sum); and its device profile (a
               fused run's
               must name the attention backward's, the pre half's, the post
               half's and the gate/FFN backward's wgmma kernels and none of
               the kernels they replaced);
5. serving  — the port's cli.infer main with the same arguments on the
               checkpoint just trained; checks every launch count,
               recomputes the first query batch with the plain versions on
               the CPU in bf16 and in f32 and holds the card's bf16 queries
               to both (per-query cosine); profiles one predict batch (a
               fused run's must name proj_wgmma_kernel and
               attn_ffn_wgmma_kernel and no bf16 proj_kernel or
               attn_ffn_kernel); prints serving throughput and
               HR@10/NDCG@10 (one epoch on synthetic data: printed, not
               judged);
5b. semantic — the generative tier on the flagship's checkpoint and
               fixture: cli.semantic at RQVAEConfig's defaults (3 levels x
               256 codes x 32 dims) with ``--rq_steps 400 --head_steps 1000
               --num_query_users 1024`` (its query encode held to 32 fused
               forward launches; semantic_ids.npy, semantic_eval.json; RQ-VAE
               and head steps/s, tokenize items/s), then ``cli.infer
               --ann_method semantic --beam_width 32`` (launches held), its
               first 128 queries served again on the CPU from the same
               files (mean top-10 overlap >= 0.98), semantic HR@10 / NDCG@10
               beside the exact serve's (printed, not judged); then the
               serving functions on a seeded 1M x 64 corpus and 1024
               queries: tokenize items/s, beam-decode queries/s,
               beam_retrieve's host seconds, the exact scorer's fill
               seconds, peak memory (shapes, ranges, finite scores held);
5c. options — the training options on the flagship's fixture: one step at
               full width and depth (B=128, L=1024, bf16, tower dedup off,
               dropout 0) from its checkpoint at 4 microbatches against 1
               (loss within 1e-3 relative, every gradient at cosine >=
               0.999, the fused training forward and backward launched 4x,
               peak memory above the state lower; both steps' ms), the
               accumulated step profiled and held to the fused route's
               wgmma kernels; ``cli.train --preset baseline_o1 --maxlen
               1023 --grad_accum_steps 4`` (flash launches 4x a step's,
               the native pack taken by --loader auto); preemption on the
               fixture's first 512 users, 2 epochs through train_loop: two
               uninterrupted runs, one that sends itself SIGTERM at epoch
               2 step 1, its resume with skip_steps (the same state.step;
               the preemption meta; parameters bitwise equal where the
               uninterrupted runs are, else within 10x their own
               difference at cosine >= 0.9999, and the ops that vary
               named); an async checkpoint written while the next step
               runs, bitwise equal to a synchronous save;
5d. dp      — data parallelism on a local mesh (every data shard in one
               process, at the launch shapes of one card of a process
               mesh): ``flagship_dp``, the flagship's checkpoint and batch
               (B=128, L=1024) on 4 data shards of 32 rows, and
               ``softmax_dp_mesh``, ``sampled_softmax_dp --maxlen 255``
               (B=64, 4 heads of 16, 64 in-batch negatives) on 8 of 8 from
               the preset's seed, each with the stacked tower-dedup plan
               ([S, cap] ids held), the learned tables row-sharded over the
               shards and the item-id lookups through the all-to-all: 6
               steps after 2 on the mesh and on the single device
               (launches held; the mesh's ep_overflow of each step
               printed), a profile of each (the fused route's wgmma
               kernels; the fused kernels' device ms at B/S rows a launch
               beside B's); the mesh's step against the single device's on
               the card where no id overflowed (loss within 1e-4 relative,
               every gradient at cosine >= 0.999, dropout 0) and, on 2 rows
               a shard, against the CPU's plain bf16 version of the same
               mesh step (the same ep_overflow, loss 1e-3, cosine 0.999);
               flagship_dp also at
               2 microbatches against 1 on the mesh (tower dedup off;
               loss 1e-3, cosine 0.999); ``train_loop`` on the mesh for 2
               steps, its Performance/mfu scalar in (0, 1);
5f. tp      — tensor parallelism on a local data x model mesh
               (``phase_tp_case``);
5g. pp      — pipeline parallelism on a local pipe 2 x data 2 mesh
               (``phase_pp_case``): the flagship (B=128, 8 microbatches a
               data column: 8 rows a fused launch, 4 blocks a stage) and
               ``sharded_multihost --maxlen 1023`` (B=64, 4 microbatches,
               sparse item_emb at packed scale over 4 table shards), bf16,
               dropout 0, against the single device's fused step from the
               same state (loss within 1e-4 relative, every gradient at
               cosine >= 0.9999, every table shard's touched groups
               bitwise); the fused launches counted and held to the wgmma
               route, both sides' step ms, idle shares and the fused
               kernels' device ms a launch; the fused kernels alone at 8,
               16 and 128 rows; dropout on pipe 2: two microbatches of
               identical rows draw different masks, the kept share within
               a binomial bound;
6. long    — phases 4 and 5 on long sequences, through the chunked
               variant: a fixture of 384 users, 5000 items and sequences of
               2048..4000 events, ``cli.train --maxlen 4095 --batch_size 32
               --loader cached --num_epochs 1`` (launch counts, losses,
               checkpoint, the cache build's seconds, examples/s and
               tokens/s of the step, a profile of one step), then
               ``cli.infer --maxlen 4095`` on that checkpoint with the first
               4 queries recomputed on the CPU; then ``--preset hstu_mini``
               on the same fixture and pack, with ``--eval_retrieval_users
               256`` (the chunked HSTU attention route: its launches, the
               epoch-end HR@10 record, the one-step check, the step's
               speed and profile, which must name the HSTU attention's
               wgmma kernels and none of its first design's, as must a
               predict batch's), served with 8 queries held to the CPU
               and its result directory served again with the approx, int8
               and hnsw methods; then the native C++ pack of the long
               fixture, every field and the seen sets bitwise equal to the
               python pack of the long run, both set-up times printed (the
               runs below with --loader auto take the native pack);
6b. retrieval — the tiers on a seeded 10M x 64 corpus, Q=1024: the exact
               tier's kernel (csrc/mips_topk.cu) against its plain version
               (ids equal, scores within 1e-5 of the score scale), timed
               (CUDA events) beside its bound, the plain version and the
               library path it replaced (torch.topk over blocked scores),
               with its registers, shared memory and spills and the
               mips_topk.launches count; exact, approx (ids equal
               exact's) and int8 (recall@10 against exact), each one's
               time, queries/s and peak memory; the HNSW tool on its first
               20,000 rows (build and search seconds, recall);
6c. ring    — the sequence-parallel ring (after the long run): rows
               10-12 (the pair kernels of csrc/ring_pair.cu; the forward
               pair_fwd_wgmma_kernel in bf16, pair_fwd_kernel in f32)
               against their plain versions at shards of 1024 and 2048,
               offsets 0, +Lc, -Lc (wholly in the future: no launch,
               exactly 0), +3 Lc, Lc / 2 + 16 and -Lc / 2 - 16 (rows that
               see no key exactly 0), H = 1, 4 and 8 (hd 8), f32 and bf16,
               with the wgmma forward's registers and spills (none at W <=
               64); the pre and post stages and their backwards, each a
               launch of its own; every ring kernel timed at the S = 2
               shard of the long run (B=32, Lc = 2048) beside its plain
               version and bound, the pair forward also by device time and
               beside its first design; one full-depth
               step of ``hstu_flagship`` at L=4096 on a local mesh of S = 2
               and 4 shards from the long run's checkpoint, against the
               single-device chunked step on the card and the CPU's plain
               ring, in bf16 and f32, on 8 rows, each step's
               launches held; the S = 2 step's ms and tokens/s (6 after 2,
               launches held), its host time as phase 4's and its profile
               (the attention backward's, the post half's and the gate/FFN
               backward's wgmma kernels named, as in the fused runs, and
               pair_fwd_wgmma_kernel launched 24 times, pair_fwd_kernel
               never);
7. parity   — phases 4 and 5 for the reference's own models and the
               ReLU-FFN HSTU: cli.train's default (no --preset: baseline at
               L=102, dense, no kernel launched), ``--preset baseline
               --maxlen 255`` (flash MHA), ``--preset hstu_mini --maxlen
               255`` (standalone HSTU attention; its profiles held to its
               wgmma route as mini_long's), both on a fixture of 1024
               users, 5000 items and 20..250 events, and ``--preset
               baseline_o1 --maxlen 1023`` (flash MHA, one head) on the
               flagship's fixture; the one-step check for baseline and
               hstu_mini; one training epoch each of ``baseline
               --hidden_units 32`` (hd 8) and ``baseline_o1 --hidden_units
               128 --maxlen 511`` (hd 128) on the parity fixture (launch
               counts);
8. sparse   — phases 4 and 5 for ``--preset sharded_multihost --maxlen
               1023`` on the flagship's fixture (B=64; its mesh wants 8
               devices: the warning is printed and it trains single-device;
               sparse item_emb, rowwise Adagrad, sampled softmax, tower
               dedup, 8 blocks of 4 heads): fused launches as the flagship's,
               no group scatter (5,001 rows are below packed scale); the
               one-step check also holds the touched rows' update; then
               ``--preset sampled_softmax_dp`` (mesh data=8 on one card,
               64 in-batch negatives, tower dedup) at its own window (L=102,
               no kernel) on the parity fixture;
9. 100m     — the JAX package's 100M-row sparse step
               (benchmarks/sparse_table_bench.py --100m: itemnum 1e8, B=64,
               L=1024, D=64, 8 blocks, H=1, bf16 table, rowwise Adagrad, BCE)
               through the port's init_state, augment_batch_sparse and
               make_train_step on a seeded synthetic batch: 3 group-scatter
               launches a step (196,608 slots in chunks of 65,536 groups),
               every touched row equal to compute_row_update's from the
               same row gradients, 100,000 untouched rows bitwise unchanged;
               step ms, examples/s, lookup GB/s, peak memory, and the group
               scatter's device time in a profiled step, which must name
               the fused block's wgmma kernels as the fused runs' do;
5e. sharded — inside phase 9, on its table: the same step on a local mesh
               of 4 data shards (16 rows a fused launch), the item table's
               4 row blocks the shards, from the state of phase 9's checked
               step (its touched groups and accumulators restored) with
               dropout off, against the single device's step from that
               state (loss within 1e-4 relative, touched rows at cosine >=
               0.999); each shard's touched groups and accumulators bitwise
               equal to a plain row write of compute_row_update's rows
               through its host plan; the 100,000 untouched rows unchanged;
               the group scatter once per shard and chunk, the fused
               kernels once per block and shard; host_shard_plan's ms, the
               step's ms, a profiled step (the scatter's device ms a shard
               launch beside the single device's, the fused kernels' at 16
               rows, the idle share) and the peak memory above the table;
10. report  — the script's seconds, the card line, one JSON line listing
               every kernel, then the last line ``{"ok": true, "device":
               {...}}``.

The f32 side of the one-step and query checks is held to min(0.999, c -
max(5e-4, 0.5 * (1 - c))), c the CPU bf16 version's own cosine to f32: a
slack that grows with bf16's own drift. The bf16-against-bf16 side, which
holds the kernels, stays at 0.999.

Scratch data goes to build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
START = time.perf_counter()

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
FLAGSHIP = dict(B=128, L=1024, D=64, H=1, F=256, NB=128)
FLAGSHIP_DROPOUT = 0.01       # hstu_flagship's dropout_rate
# the training and serving runs: synthetic fixture and window (maxlen 1023
# gives L=1024, the kernels' shape); the model is hstu_flagship as it stands
FIXTURE = dict(num_users=1024, num_items=5000, min_seq=256, max_seq=1000,
               seed=21)
MAXLEN = 1023
# long sequences: L=4096 at the JAX package's long-sequence batch of 32
# (the flagship's 131,072 tokens per step), the chunked variant's path
LONG = dict(B=32, L=4096, D=64, H=1, F=256, NB=128)
LONG_FIXTURE = dict(num_users=384, num_items=5000, min_seq=2048,
                    max_seq=4000, seed=21)


# the parity presets and hstu_mini: short sequences with left padding
PARITY_FIXTURE = dict(num_users=1024, num_items=5000, min_seq=20,
                      max_seq=250, seed=21)

#: the HSTU attention backward (csrc/hstu_attn_bwd_sm90.cuh), shared by the
#: single device's fused backward and the ring's pairs: the wgmma kernels
#: (bf16, hd <= 128), then the generic ones (f32, wider heads)
ATTN_BWD_WGMMA = ("attn_bwd_dq_wgmma_kernel", "attn_bwd_dkdv_wgmma_kernel")
ATTN_BWD_NAMES = ATTN_BWD_WGMMA + ("attn_bwd_dq_kernel",
                                   "attn_bwd_dkdv_kernel")
#: the attention backward kernels these replaced, which no step may launch
ATTN_BWD_DELETED = ("attn_dq_kernel", "attn_dkdv_kernel", "pair_dq_kernel",
                    "pair_dkdv_kernel")
#: the fused block's post half and gate/FFN backward on wgmma (bf16, D <=
#: 128): the forward, the backward with its weight-gradient kernel
POST_WGMMA = ("attn_ffn_wgmma_kernel", "gate_ffn_bwd_wgmma_kernel",
              "wgrad_wgmma_kernel")
#: the kernels they replace in bf16 (kept for f32 and D > 128), which no
#: bf16 step or predict batch may launch
POST_REPLACED = ("attn_ffn_kernel", "gate_ffn_bwd_kernel")
#: the fused block's pre half on wgmma (bf16, D <= 128): LN1 and the
#: projection, and its backward (dWuvqk by wgrad_wgmma_kernel)
PRE_WGMMA = ("proj_wgmma_kernel", "proj_bwd_wgmma_kernel")
#: the kernels they replace in bf16 (kept for f32 and D > 128)
PRE_REPLACED = ("proj_kernel", "proj_bwd_kernel")
#: the ring's pair forward on wgmma (bf16 where the attention loop takes the
#: heads: every ring preset), then its first design (f32, other heads),
#: which no bf16 ring step may launch
PAIR_FWD = ("pair_fwd_wgmma_kernel", "pair_fwd_kernel")
#: the standalone HSTU attention on wgmma (bf16, hd % 8 == 0, hd <= 128:
#: every HSTU preset): the forward, the backward pair in its standalone
#: instance and the rel-pos sum; then the first design (f32, hd 129-256),
#: which no bf16 hstu_mini step or predict batch may launch
HSTU_WGMMA = ("hstu_fwd_wgmma_kernel",) + ATTN_BWD_WGMMA \
    + ("reduce_rows_split_kernel",)
HSTU_FIRST = ("hstu_fwd_kernel", "hstu_bwd_dq_kernel", "hstu_bwd_dkdv_kernel",
              "reduce_rows_kernel")
#: CUDA kernel names of each kernel family, as a profile lists them
#: (forward, backward)
KERNEL_NAMES = {
    "fused": (PRE_WGMMA[:1] + ("proj_kernel", "attn_ffn_wgmma_kernel",
                               "attn_ffn_kernel"),
              PRE_WGMMA[1:] + POST_WGMMA[1:] + ("gate_ffn_bwd_kernel",)
              + ATTN_BWD_NAMES
              + ("proj_bwd_kernel", "reduce_rows_kernel",
                 "reduce_rows_split_kernel")),
    "flash": (("flash_fwd_wgmma_kernel", "flash_fwd_kernel"),
              ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel",
               "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")),
    "hstu": (HSTU_WGMMA[:1] + HSTU_FIRST[:1],
             HSTU_WGMMA[1:] + HSTU_FIRST[1:]),
    "ring": (PRE_WGMMA[:1] + ("proj_kernel", "attn_ffn_wgmma_kernel",
                              "attn_ffn_kernel") + PAIR_FWD[:1],
             PRE_WGMMA[1:] + POST_WGMMA[1:] + ("gate_ffn_bwd_kernel",)
             + ATTN_BWD_NAMES
             + ("proj_bwd_kernel", "reduce_rows_kernel",
                "reduce_rows_split_kernel")),
    "none": ((), ())}
# the chunked HSTU attention route launches the same CUDA functions
KERNEL_NAMES["hstu_chunk"] = KERNEL_NAMES["hstu"]


@dataclasses.dataclass(frozen=True)
class Run:
    """One end-to-end path: its preset (None: cli.train's default, no
    ``--preset``), window (None: the preset's), fixture and data directory,
    batch, further cli.train arguments, the kernel family it takes
    ("fused", "flash", "hstu", "hstu_chunk" or "none"), the first queries
    recomputed on the CPU, whether one full-depth step is held to the CPU
    and on how many rows."""
    name: str
    preset: Optional[str]
    maxlen: Optional[int]
    fixture: dict
    data_dir: Path
    batch_size: int
    train_args: tuple
    work: Path
    kernels: str
    n_check: int
    one_step: bool
    check_rows: int = 16

    def args(self):
        return (["--preset", self.preset] if self.preset else []) + \
            (["--maxlen", str(self.maxlen)] if self.maxlen else [])

    def config(self):
        """The run's config as cli.train builds it."""
        from tencent_recommendation_2025_tpu_torch.cli import train as TRN

        return TRN.build_config(TRN.get_args(
            self.args() + list(self.train_args)
            + ["--batch_size", str(self.batch_size)]))

    @property
    def cpu_route(self):
        """The encoder route whose plain versions the CPU checks take."""
        return {"fused": "fused", "flash": "core", "hstu": "core",
                "hstu_chunk": "core", "none": None}[self.kernels]


# the L=1024 path keeps the streaming loader it has run with since its first
# slice (its one-step check reads that run's checkpoint); the long path
# takes the python pack (--loader cached), which the native pack is held
# to; the parity presets, hstu_mini and sparse take --loader auto (the
# native pack)
FLAGSHIP_RUN = Run("flagship", "hstu_flagship", MAXLEN, FIXTURE,
                   WORK / "data", 128, ("--loader", "streaming"), WORK,
                   "fused", 32, True)
LONG_RUN = Run("long", "hstu_flagship", 4095, LONG_FIXTURE,
               WORK / "long" / "data", 32,
               ("--batch_size", "32", "--loader", "cached"), WORK / "long",
               "fused", 4, False)
# hstu_mini (ReLU FFN: the fused gate refuses it) on the long fixture: the
# chunked HSTU attention kernels, with the epoch-end retrieval eval; it
# reuses the long run's pack (same data, same window)
MINI_LONG_RUN = Run("mini_long", "hstu_mini", 4095, LONG_FIXTURE,
                    WORK / "long" / "data", 32,
                    ("--batch_size", "32", "--loader", "cached",
                     "--eval_retrieval_users", "256"), WORK / "mini_long",
                    "hstu_chunk", 4, True, check_rows=4)
PARITY_DATA = WORK / "parity_data"
PARITY_RUNS = (
    # cli.train's default: baseline at its own window (L=102), dense
    Run("default", None, None, PARITY_FIXTURE, PARITY_DATA, 64, (),
        WORK / "default", "none", 128, False),
    Run("baseline", "baseline", 255, PARITY_FIXTURE, PARITY_DATA, 64, (),
        WORK / "baseline", "flash", 128, True),
    Run("hstu_mini", "hstu_mini", 255, PARITY_FIXTURE, PARITY_DATA, 64, (),
        WORK / "hstu_mini", "hstu", 128, True),
    # reuses the flagship's fixture (sequences of 256 to 1000 events)
    Run("baseline_o1", "baseline_o1", 1023, FIXTURE, WORK / "data", 128, (),
        WORK / "baseline_o1", "flash", 32, False))
# head dims the flash kernels take since their FMA and cut-tile paths:
# hd 8 (4 heads of 8) and hd 128 (one head), trained one epoch (launch
# counts; the kernel checks hold the numbers)
HEAD_DIM_RUNS = (
    Run("baseline_hd8", "baseline", 255, PARITY_FIXTURE, PARITY_DATA, 64,
        ("--hidden_units", "32"), WORK / "baseline_hd8", "flash", 0, False),
    Run("baseline_o1_hd128", "baseline_o1", 511, PARITY_FIXTURE, PARITY_DATA,
        128, ("--hidden_units", "128"), WORK / "baseline_o1_hd128", "flash",
        0, False))
# sparse item_emb, rowwise Adagrad, sampled softmax, tower dedup: the
# preset's B=64 on the flagship's fixture
SPARSE_RUN = Run("sparse", "sharded_multihost", MAXLEN, FIXTURE,
                 WORK / "data", 64, (), WORK / "sparse", "fused", 16, True,
                 check_rows=8)
# sampled softmax with 64 in-batch negatives and tower dedup, at the
# preset's own window (L=102: plain PyTorch, no kernel)
SOFTMAX_DP_RUN = Run("softmax_dp", "sampled_softmax_dp", None, PARITY_FIXTURE,
                     PARITY_DATA, 64, (), WORK / "softmax_dp", "none", 128,
                     False)
#: cli.train's last packed cache, kept across the runs: the runs that
#: follow one of the same data and window reuse it
PACKS: dict = {}
#: each served run's HR@10 / NDCG@10 (cli.infer's exact top-k)
SERVED: dict = {}
SRC = "tencent_recommendation_2025_tpu_torch/csrc/"
TPU = "tencent_recommendation_2025_tpu/ops/fused_block.py"


def launch_counters():
    """Every kernel wrapper's launch counter, by name."""
    from tencent_recommendation_2025_tpu_torch.ops import flash_attention as FA
    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST
    from tencent_recommendation_2025_tpu_torch.retrieval import mips as MIPS

    return {"fused_fwd": FB.fused_hstu_block,
            "fused_train": FB.fused_hstu_block_train,
            "fused_bwd": FB.fused_hstu_block_bwd,
            "flash_fwd": FA.flash_mha_fwd, "flash_bwd": FA.flash_mha_bwd,
            "hstu_fwd": HA.hstu_attention_fwd,
            "hstu_bwd": HA.hstu_attention_bwd,
            "hstu_chunk_fwd": HA.hstu_attention_chunk_fwd,
            "hstu_chunk_bwd": HA.hstu_attention_chunk_bwd,
            # the silu_qkv instances, counted apart (no route sets them)
            "hstu_silu_fwd": _SiluCounter(HA.hstu_attention_fwd),
            "hstu_silu_bwd": _SiluCounter(HA.hstu_attention_bwd),
            "hstu_chunk_silu_fwd": _SiluCounter(HA.hstu_attention_chunk_fwd),
            "hstu_chunk_silu_bwd": _SiluCounter(HA.hstu_attention_chunk_bwd),
            "group_scatter": ST.group_scatter,
            "group_gather": ST.group_gather,
            **{n: getattr(FB, n) for n in (
                "ring_pre_fwd", "ring_post_fwd", "ring_pair_fwd",
                "ring_pair_dq", "ring_pair_dkdv", "ring_post_bwd",
                "ring_pre_bwd")},
            # the exact tier's scan (retrieval.mips.mips_topk)
            "mips_topk": MIPS.mips_topk}


def reset_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in launch_counters().items()}


def set_launches(counts):
    """Every counter back to ``counts`` (a run read apart, in the middle of
    another, leaves the outer run's counts as they were)."""
    for k, fn in launch_counters().items():
        fn.launches = counts[k]


def expected_launches(kernels, blocks, steps, n_eval, scans=0):
    """Every counter's launches over ``steps`` training steps and
    ``n_eval`` forward-only batches (validation, probes, serving), and
    ``scans`` calls of the exact tier's scan (:func:`scan_calls`), as the
    JAX package's remat runs them: the fused block once forward (training
    instance) and once backward per block and step; flash MHA twice forward
    (the checkpointed block's recompute re-runs it) and once backward; the
    standalone HSTU attention once each way (its output is kept), under
    the chunked counters past ``_use_long``; one forward per block and
    batch without autograd. Every other counter 0."""
    want = dict.fromkeys(launch_counters(), 0)
    want["mips_topk"] = scans
    if kernels == "fused":
        want.update(fused_fwd=blocks * n_eval, fused_train=blocks * steps,
                    fused_bwd=blocks * steps)
    elif kernels == "flash":
        want.update(flash_fwd=blocks * (2 * steps + n_eval),
                    flash_bwd=blocks * steps)
    elif kernels in ("hstu", "hstu_chunk"):
        prefix = "hstu_chunk" if kernels == "hstu_chunk" else "hstu"
        want.update({f"{prefix}_fwd": blocks * (steps + n_eval),
                     f"{prefix}_bwd": blocks * steps})
    return want


def scan_calls(n_queries):
    """The exact tier's scans of one ``retrieve_topk`` over ``n_queries``
    queries: one per query batch."""
    import inspect

    from tencent_recommendation_2025_tpu_torch.retrieval import mips as MIPS

    batch = inspect.signature(MIPS.retrieve_topk).parameters[
        "query_batch"].default
    return -(-n_queries // batch)


def drift_limit(c):
    """Limit of a card-vs-CPU-f32 cosine, where ``c`` is the CPU's plain
    bf16 version's own cosine to f32: 0.999, or where bf16 arithmetic
    alone drifts below that, ``c`` minus the larger of 5e-4 and half that
    drift (1 - c)."""
    import numpy as np

    return np.minimum(0.999, c - np.maximum(5e-4, 0.5 * (1.0 - c)))


DRIFT_RULE = ("min(0.999, c - max(5e-4, 0.5 * (1 - c))), c the CPU bf16 "
              "version's own cosine to f32")


def log(*a):
    """Prints to stdout; a line that reports a failed check also goes to
    stderr, so that the end of stderr names what failed."""
    print(*a, flush=True)
    text = " ".join(map(str, a))
    if "FAIL" in text:
        print(text, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------

def block_inputs(B, L, D, H, F, NB, dtype, seed, device="cuda"):
    """Seeded kernel operands of one block (LN, biases and the rel-pos bias
    off their init) and inputs on ``device``: row 0 left-padded, the last
    row (B > 1) fully padded."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.config import ModelConfig
    from tencent_recommendation_2025_tpu_torch.models import encoder as ENC
    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    cfg = ModelConfig(hidden_units=D, num_heads=H, block_type="hstu",
                      ffn_type="swiglu", hstu_rel_pos_buckets=NB,
                      reference_init=False)
    assert ENC.swiglu_hidden_dim(D, cfg.ffn_hidden_mult,
                                 cfg.ffn_multiple_of) == F
    rng = np.random.default_rng(seed)
    bp = ENC.init_block_params(torch.Generator().manual_seed(seed), cfg)

    def perturb(t, key):
        if isinstance(t, dict):
            return {k: perturb(v, k) for k, v in t.items()}
        if key in ("b", "bias", "scale", "rab"):
            t = t + torch.from_numpy(
                rng.standard_normal(tuple(t.shape)).astype(np.float32) * 0.1)
        return t.to(device)

    ops = FB.block_operands(perturb(bp, ""), dtype)
    x = torch.from_numpy(
        (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32))
    tt = np.ones((B, L), np.int32)
    tt[0, :L // 3 + 5] = 0
    if B > 1:
        tt[-1] = 0
    return x.to(dtype).to(device), ops, torch.from_numpy(tt).to(device)


def compare(out, ref, dtype):
    """(ok, max_abs_err, limit text) under the stated tolerance."""
    import torch

    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if dtype == torch.float32:
        ok = bool((err <= 1e-4 + 1e-4 * r.abs()).all())
        return ok, err.max().item(), "rtol=1e-4 atol=1e-4"
    lim = 3e-2 * max(1.0, r.abs().max().item())
    cos = torch.nn.functional.cosine_similarity(
        o.reshape(-1, o.shape[-1]), r.reshape(-1, r.shape[-1]), dim=1)
    ok = err.max().item() <= lim and cos.min().item() >= 0.9995
    return ok, err.max().item(), (f"max_abs<={lim:.4g}, min token cosine "
                                  f"{cos.min().item():.6f} >= 0.9995")


def compare_grad(got, ref, dtype):
    """(ok, max_abs_err, limit text) for one gradient: f32 rtol 2e-4 and
    atol 2e-5 * max(1, max|ref|); bf16 cosine >= 0.999 and max abs <=
    3e-2 * max(1, max|ref|)."""
    import torch

    g, r = got.float().flatten(), ref.float().flatten()
    err = (g - r).abs()
    scale = max(1.0, r.abs().max().item())
    if dtype == torch.float32:
        ok = bool((err <= 2e-5 * scale + 2e-4 * r.abs()).all())
        return ok, err.max().item(), f"rtol=2e-4 atol={2e-5 * scale:.3g}"
    cos = torch.nn.functional.cosine_similarity(g, r, dim=0).item()
    ok = err.max().item() <= 3e-2 * scale and cos >= 0.999
    return ok, err.max().item(), (f"max_abs<={3e-2 * scale:.4g}, cosine "
                                  f"{cos:.6f} >= 0.999")


def time_ms(fn, warmup, iters):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def _param_bytes(D, H, F, NB, elem_bytes):
    weights = (D * 4 * D + D * D + D * 2 * F + F * D) * elem_bytes
    return weights + (6 * D + 4 * D + D + H * NB) * 4


def fused_block_bound(B, L, D, H, F, elem_bytes, train=False, NB=128):
    """Least time (ms) of one fused block forward: the larger of its matmul
    operations over the peak rate and its bytes (inputs once, outputs once;
    training also writes av) over the memory rate. Causal: q.k^T and a.v
    each cost L(L+1)/2 key pairs per query row."""
    flops = (2 * B * L * D * 4 * D           # projection
             + 2 * B * D * L * (L + 1)        # q.k^T and a.v, causal
             + 2 * B * L * D * D              # Wo
             + 2 * B * L * D * 2 * F          # W13
             + 2 * B * L * F * D)             # W2
    acts = (3 if train else 2) * B * L * D * elem_bytes
    nbytes = acts + B * L * 4 + _param_bytes(D, H, F, NB, elem_bytes)
    return _bound(flops, nbytes)


def fused_block_bwd_bound(B, L, D, H, F, elem_bytes, NB=128):
    """Least time (ms) of one fused block backward (the TPU kernel's work,
    l.354-430): the recompute (projection, s, Wo, W13), the four attention
    products (dv, da, dq, dk, causal) and each weight product twice (dW and
    dX); bytes: x, av and dout in, dx out, the mask, the weights in and
    their f32 gradients out."""
    M = B * L
    causal = B * D * L * (L + 1)             # one causal [L, L] x D product
    flops = (2 * M * D * 4 * D + causal + 2 * M * D * D + 2 * M * D * 2 * F
             + 4 * causal
             + 2 * (2 * M * D * 4 * D + 2 * M * D * D + 2 * M * D * 2 * F
                    + 2 * M * F * D))
    grads = (D * 4 * D + D * D + D * 2 * F + F * D + 6 * D + 5 * D
             + H * NB) * 4
    nbytes = 4 * M * D * elem_bytes + M * 4 + \
        _param_bytes(D, H, F, NB, elem_bytes) + grads
    return _bound(flops, nbytes)


def attn_ffn_bound(B, L, D, H, F, elem_bytes, train=False, NB=128):
    """(flops, bytes) of attn_ffn alone (the forward's second kernel) on
    the scratch the projection wrote: q.k^T and a.v causal, Wo, W13 and W2;
    q, k, v, x (the compute dtype) and u (f32) in with the mask and the
    weights, out written (training: av too)."""
    M, act = B * L, B * L * D * elem_bytes
    flops = 2 * B * D * L * (L + 1) + 2 * M * (D * D + 2 * D * F + F * D)
    w = (D * D + D * 2 * F + F * D) * elem_bytes + (6 * D + D + H * NB) * 4
    return flops, (4 + 1 + (1 if train else 0)) * act + M * D * 4 + M * 4 + w


def gate_ffn_bwd_bound(B, L, D, H, F, elem_bytes, NB=128):
    """(flops, bytes) of the gate/FFN backward (the single device's and the
    ring's stage 0): the recompute (projection, Wo, W13), df, dh2 and dg,
    and dW2, dW13 and dWo over the tokens; x, av and dout in with the
    weights, q, k, v and dav (the compute dtype) and du, dy (f32) out, the
    weight, LN and bias gradients out. The wgmma design's scratch between
    its two kernels is not the function's work: see gate_scratch_bytes."""
    M, act = B * L, B * L * D * elem_bytes
    flops = 2 * M * (7 * D * D + 8 * D * F)
    w = (D * 4 * D + D * D + D * 2 * F + F * D) * elem_bytes + \
        (6 * D + 4 * D + D) * 4
    grads = (D * D + D * 2 * F + F * D + 5 * D) * 4
    return flops, 3 * act + w + 4 * act + 2 * M * D * 4 + grads


def gate_scratch_bytes(B, L, D, F, elem_bytes):
    """Bytes the wgmma gate/FFN design adds: the bf16 operands of its
    weight products (T(f), T(dx13), T(h2), T(g), T(dy)) written by
    gate_ffn_bwd_wgmma_kernel and read by wgrad_wgmma_kernel."""
    return 2 * B * L * (3 * F + 3 * D) * elem_bytes


def pre_bounds(B, L, D, elem, ring=False):
    """{"fwd", "bwd": (flops, bytes)} of the pre half over B x L tokens, its
    own reads, writes and products. Forward: LN1 and the projection, x,
    Wuvqk, its bias and LN1's gamma and beta in, q, k, v (the compute
    dtype) and u (f32) out. Backward: the projection again, dh1 and dWuvqk
    (three products of its size); x and the weights in with the cotangents
    as each caller passes them (the single device: du, dv, dq, dk and the
    residual dy in f32; the ring's stage 1: dq, dk, dv in the compute dtype
    and du in f32, no residual), dx out, and dWuvqk, dbuvqk and LN1's
    gradients (f32) out. The wgmma design's scratch is not the function's
    work: see pre_scratch_bytes."""
    act, f32 = B * L * D * elem, B * L * D * 4
    w = D * 4 * D * elem + (2 * D + 4 * D) * 4
    prod = 2 * B * L * D * 4 * D
    cots = 3 * act + f32 if ring else 5 * f32
    grads = (D * 4 * D + 4 * D + 2 * D) * 4
    return {"fwd": (prod, act + w + 3 * act + f32),
            "bwd": (3 * prod, act + w + cots + act + grads)}


def pre_scratch_bytes(B, L, D, elem):
    """Bytes the wgmma projection backward adds: T(h1) and T(duvqk), written
    by proj_bwd_wgmma_kernel and read again by wgrad_wgmma_kernel."""
    return 2 * B * L * (D + 4 * D) * elem


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def check_kernels(shp, dt, rate, seed):
    """One shape: the inference forward, the training forward (dropout at
    ``rate`` and its av output) and the backward against their plain
    versions on the same inputs; with dropout, the plain version with
    another seed must fail the limit the kernel passes."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    t0 = time.perf_counter()
    H = shp["H"]
    x, ops, tt = block_inputs(**shp, dtype=dt, seed=seed)
    out = FB.fused_hstu_block(x, ops, tt, H)
    torch.cuda.synchronize()
    ok0, e0, lim0 = compare(out, FB.fused_hstu_block_plain(x, ops, tt, H), dt)
    ok0 &= bool(torch.isfinite(out.float()).all())
    del out
    _free()
    out, av = FB.fused_hstu_block_train(x, ops, tt, H, 1234, rate)
    torch.cuda.synchronize()
    ref, ref_av = FB.fused_hstu_block_train_plain(x, ops, tt, H, 1234, rate)
    ok1, e1, _ = compare(out, ref, dt)
    # av is 0 on the fully padded row: held as a whole, not per token
    ok2, e2, _ = compare_grad(av, ref_av, dt)
    differs = True
    if rate > 0:
        other, _ = FB.fused_hstu_block_train_plain(x, ops, tt, H, 1235, rate)
        differs = not compare(out, other, dt)[0]
        del other
    del out, av, ref
    _free()
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        tuple(x.shape)).astype(np.float32)).to(dt).cuda()
    got = FB.fused_hstu_block_bwd(x, ref_av, dout, ops, tt, H, 1234, rate)
    torch.cuda.synchronize()
    want = FB.fused_hstu_block_bwd_plain(x, ref_av, dout, ops, tt, H, 1234,
                                         rate)
    ok3, worst, parts = True, (None, 0.0), []
    for name in want:
        okg, eg, limg = compare_grad(got[name], want[name], dt)
        okg &= bool(torch.isfinite(got[name].float()).all())
        ok3 &= okg
        if eg >= worst[1]:
            worst = (name, eg)
        if not okg:
            parts.append(f"{name} {eg:.4g} ({limg})")
    ok = ok0 and ok1 and ok2 and ok3 and differs
    variant = "chunked" if FB.chunked(shp["L"], shp["D"]) else "whole-seq"
    log(f"{variant} {shp} {str(dt)[6:]} p={rate}: inference "
        f"max_abs_err={e0:.6g} ({lim0}); training out {e1:.6g}, av {e2:.6g}"
        + (f", another seed fails the limit: {differs}" if rate > 0 else "")
        + f"; backward largest error {worst[1]:.6g} ({worst[0]})"
        + (f", failing: {'; '.join(parts)}" if parts else "")
        + f"; {time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    del got, want, ref_av, dout, x, ops, tt
    _free()
    return ok


def phase_kernels():
    """Every kernel against its plain version, on seeded inputs with left
    padding and one fully padded row: the whole-sequence variant at L=1024
    (D=64), at L=256 (D=32, H=2) and at sharded_multihost's B=128, L=1024,
    H=4 (hd=16) in f32 and bf16; the chunked variant at L = 2048, 4096 and
    16384 (D=64) in f32 and bf16 and at D=128 and D=256 in f32; then the
    chunked variant's bf16 rounding point."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    f32, bf16 = torch.float32, torch.bfloat16

    def shape(B, L, D=64, H=1, F=256):
        return dict(B=B, L=L, D=D, H=H, F=F, NB=128)

    a, b = shape(8, 1024), shape(4, 256, D=32, H=2)
    h4 = shape(128, 1024, H=4)
    cases = [(a, f32, 0.0), (a, f32, 0.5), (b, f32, 0.0), (b, f32, 0.5),
             (a, bf16, 0.0), (a, bf16, 0.5),
             (shape(4, 2048), f32, 0.5), (shape(4, 2048), bf16, 0.01),
             (shape(4, 4096), f32, 0.5), (shape(4, 4096), bf16, 0.01),
             (shape(2, 16384), f32, 0.5), (shape(2, 16384), bf16, 0.01),
             (shape(2, 1024, D=128, F=512), f32, 0.5),
             (shape(2, 512, D=256, F=768), f32, 0.5),
             (h4, f32, 0.5), (h4, bf16, 0.01)]
    ok_all = True
    for i, (shp, dt, rate) in enumerate(cases):
        ok_all &= check_kernels(shp, dt, rate, seed=11 + 2 * i)

    # the rounding point: in bf16 the kernel's output agrees with the plain
    # chunked version in more elements than with the plain whole-sequence
    # version (LN2 on the f32 sum), which differs only there
    shp = shape(4, 2048)
    x, ops, tt = block_inputs(**shp, dtype=bf16, seed=30)
    out = FB.fused_hstu_block(x, ops, tt, 1)
    ref = FB.fused_hstu_block_plain(x, ops, tt, 1)
    saved = FB.FB_WHOLESEQ_MAX
    FB.FB_WHOLESEQ_MAX = shp["L"]
    try:
        whole = FB.fused_hstu_block_plain(x, ops, tt, 1)
    finally:
        FB.FB_WHOLESEQ_MAX = saved
    share = (out != ref).float().mean().item()
    share_w = (out != whole).float().mean().item()
    ok = share < share_w
    log(f"chunked rounding point {shp} bf16: output elements differing from "
        f"the plain chunked version {share:.4%}, from the plain "
        f"whole-sequence version {share_w:.4%} {'ok' if ok else 'FAIL'}")
    del x, ops, tt, out, ref, whole
    _free()
    return ok_all and ok


#: (variant suffix of the JSON names, TPU kernel lines of fwd, of bwd)
_REPLACES = {False: ("", "274", "325"),
             True: ("_chunked", "452,468,502", "612,533,573,710")}


def phase_times(s):
    """At a main path's shape, in bf16: each kernel against its plain
    version, then timed (CUDA events) beside it and its bound; returns
    (ok, the kernels' JSON entries without launches)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    bf16, H, p = torch.bfloat16, s["H"], FLAGSHIP_DROPOUT
    suffix, fwd_rows, bwd_rows = _REPLACES[FB.chunked(s["L"], s["D"])]
    x, ops, tt = block_inputs(**s, dtype=bf16, seed=12)
    seed = torch.tensor([99], dtype=torch.int32, device="cuda")
    err = {}
    okx, err["fwd"], _ = compare(FB.fused_hstu_block(x, ops, tt, H),
                                 FB.fused_hstu_block_plain(x, ops, tt, H),
                                 bf16)
    out, _ = FB.fused_hstu_block_train(x, ops, tt, H, seed, p)
    ref, ref_av = FB.fused_hstu_block_train_plain(x, ops, tt, H, seed, p)
    okt, err["fwd_train"], _ = compare(out, ref, bf16)
    del out, ref
    _free()
    dout = torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(16), device="cuda").to(bf16)
    got = FB.fused_hstu_block_bwd(x, ref_av, dout, ops, tt, H, seed, p)
    want = FB.fused_hstu_block_bwd_plain(x, ref_av, dout, ops, tt, H, seed, p)
    okb, err["bwd"] = True, 0.0
    for name in want:
        okg, eg, _ = compare_grad(got[name], want[name], bf16)
        okb &= okg
        err["bwd"] = max(err["bwd"], eg)
    del got, want
    _free()
    ok = okx and okt and okb
    log(f"{s} bf16 p={p}: inference max_abs_err {err['fwd']:.6g}, training "
        f"{err['fwd_train']:.6g}, backward largest {err['bwd']:.6g} "
        f"{'ok' if ok else 'FAIL'}")

    t = {"fwd": time_ms(lambda: FB.fused_hstu_block(x, ops, tt, H), 3, 20),
         "fwd_train": time_ms(lambda: FB.fused_hstu_block_train(
             x, ops, tt, H, seed, p), 3, 20),
         "bwd": time_ms(lambda: FB.fused_hstu_block_bwd(
             x, ref_av, dout, ops, tt, H, seed, p), 2, 10)}
    plain = {"fwd": time_ms(lambda: FB.fused_hstu_block_plain(
                 x, ops, tt, H), 1, 5),
             "fwd_train": time_ms(lambda: FB.fused_hstu_block_train_plain(
                 x, ops, tt, H, seed, p), 1, 3),
             "bwd": time_ms(lambda: FB.fused_hstu_block_bwd_plain(
                 x, ref_av, dout, ops, tt, H, seed, p), 1, 3)}
    args = (s["B"], s["L"], s["D"], H, s["F"], 2)
    bounds = {"fwd": fused_block_bound(*args),
              "fwd_train": fused_block_bound(*args, train=True),
              "bwd": fused_block_bwd_bound(*args)}
    entries = []
    for key, src, rows in (("fwd", "fused_block.cu", fwd_rows),
                           ("fwd_train", "fused_block.cu", fwd_rows),
                           ("bwd", "fused_block_bwd.cu", bwd_rows)):
        bound, by, flops, nbytes = bounds[key]
        log(f"{key}{suffix} time at {s}: kernel {t[key]:.4f} ms, plain "
            f"{plain[key]:.4f} ms, bound {bound:.4f} ms ({by}: "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); kernel at "
            f"{flops / t[key] / 1e9:.1f} TFLOP/s")
        entries.append({"name": f"fused_hstu_block_{key}{suffix}",
                        "route": "cuda", "source": SRC + src,
                        "replaces": f"{TPU}:{rows}", "launches": None,
                        "max_abs_err": err[key], "ms": t[key],
                        "plain_ms": plain[key], "bound_ms": bound,
                        "bound_by": by, "library_ms": None})
    del x, ops, tt, ref_av, dout
    _free()
    return ok, entries


# ---------------------------------------------------------------------------
# phase 3a: the HSTU attention backward (csrc/hstu_attn_bwd_sm90.cuh)
# ---------------------------------------------------------------------------

#: the attention backward's shapes on the main paths (B, L, D, H), by the
#: run whose fused backward launches them
ATTN_BWD_SHAPES = {"flagship": (128, 1024, 64, 1), "long": (32, 4096, 64, 1),
                   "sparse": (64, 1024, 64, 4)}
#: TPU kernel lines of each shape's (dq, dk/dv): the whole-sequence
#: backward (row 2) or the chunked variant's two kernels (rows 7 and 8)
_ATTN_BWD_REPLACES = {"flagship": ("325", "325"), "long": ("533", "573"),
                      "sparse": ("325", "325")}
#: (hd, H) of the checks, D = hd * H a multiple of 16
ATTN_BWD_HEADS = ((8, 2), (16, 4), (32, 2), (64, 1), (128, 1))


def attn_bwd_bound(B, L, D, H, which, elem=2, NB=128):
    """(flops, bytes) of the attention backward over L tokens at off 0:
    ``which`` "dq" (3 causal products, s, da and dq; q, k, v and dav in,
    dq and drab out), "dkdv" (4: s, da, dv and dk; dk and dv out) or
    "pair" (the least work of both: 5 products; dq, dk, dv and drab out).
    Each input read once, each output written once."""
    prod = B * D * L * (L + 1)          # one causal [L, L] x D product
    act, f32 = B * L * D * elem, B * L * D * 4
    ins = 4 * act + B * L * 4 + H * NB * 4
    return {"dq": (3 * prod, ins + f32 + H * NB * 4),
            "dkdv": (4 * prod, ins + 2 * f32),
            "pair": (5 * prod, ins + 3 * f32 + H * NB * 4)}[which]


def check_attn_bwd(B, L, hd, H, off, dt, seed):
    """The attention backward's two kernels through ring_pair_dq and
    ring_pair_dkdv (one launch each) against ring_pair_bwd_plain on the
    card: row 0 left-padded, the last row fully padded, 128 buckets."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    q, k, v, dav, valid, rab = _pair_inputs(B, L, hd * H, H, dt, seed)
    before = read_launches()
    dq, drab = FB.ring_pair_dq(q, k, v, dav, valid, rab, off, H)
    dk, dv = FB.ring_pair_dkdv(q, k, v, dav, valid, rab, off, H)
    torch.cuda.synchronize()
    after = read_launches()
    ok = {n: after[n] - before[n] for n in after} == dict(
        dict.fromkeys(after, 0), ring_pair_dq=1, ring_pair_dkdv=1)
    want = FB.ring_pair_bwd_plain(q, k, v, dav, valid, rab, off, H)
    worst, fails = (None, 0.0), []
    for name, g, w in zip(("dq", "drab", "dk", "dv"), (dq, drab, dk, dv),
                          want):
        okg, eg, lim = compare_grad(g, w, dt)
        okg &= bool(torch.isfinite(g).all())
        ok &= okg
        if eg >= worst[1]:
            worst = (name, eg)
        if not okg:
            fails.append(f"{name} {eg:.4g} ({lim})")
    ok &= not dk[-1].any() and not dv[-1].any()
    log(f"attention backward B={B} L={L} hd={hd} H={H} off={off} "
        f"{str(dt)[6:]}: largest error {worst[1]:.6g} ({worst[0]})"
        + (f", failing: {'; '.join(fails)}" if fails else "")
        + f" {'ok' if ok else 'FAIL'}")
    del q, k, v, dav, dq, dk, dv, want
    _free()
    return ok


def attn_bwd_times(name, B, L, D, H):
    """At a main path's shape, in bf16 at off 0 (the single device's
    call): both kernels held to the plain version, then timed (CUDA
    events; the kernels' device time by the profiler) beside the plain
    versions and their bounds. Returns (ok, the two JSON entries without
    launches)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    bf16 = torch.bfloat16
    q, k, v, dav, valid, rab = _pair_inputs(B, L, D, H, bf16, 41)
    got = (*FB.ring_pair_dq(q, k, v, dav, valid, rab, 0, H),
           *FB.ring_pair_dkdv(q, k, v, dav, valid, rab, 0, H))
    want = FB.ring_pair_bwd_plain(q, k, v, dav, valid, rab, 0, H)
    res = [compare_grad(g, w, bf16) for g, w in zip(got, want)]
    ok = all(r[0] for r in res) and all(
        bool(torch.isfinite(g).all()) for g in got)
    err = {"dq": max(res[0][1], res[1][1]), "dkdv": max(res[2][1], res[3][1])}
    del got, want
    _free()
    kern = {"dq": lambda: FB.ring_pair_dq(q, k, v, dav, valid, rab, 0, H),
            "dkdv": lambda: FB.ring_pair_dkdv(q, k, v, dav, valid, rab, 0,
                                              H)}
    plain = {"dq": lambda: FB.ring_pair_dq_plain(q, k, v, dav, valid, rab, 0,
                                                 H),
             "dkdv": lambda: FB.ring_pair_dkdv_plain(q, k, v, dav, valid,
                                                     rab, 0, H)}
    t = {w: time_ms(kern[w], 3, 20) for w in kern}
    dev = {w: kernel_device_ms(kern[w], (f"attn_bwd_{w}_wgmma_kernel",))
           for w in kern}
    tp = {w: time_ms(plain[w], 1, 3) for w in plain}
    _free()
    prod = B * D * L * (L + 1)
    entries = []
    for w, rows in zip(("dq", "dkdv"), _ATTN_BWD_REPLACES[name]):
        flops, nbytes = attn_bwd_bound(B, L, D, H, w)
        bound, by, _, _ = _bound(flops, nbytes)
        log(f"attention backward {w} at {name} (B={B}, L={L}, D={D}, H={H}, "
            f"bf16, off 0): kernel {t[w]:.4f} ms (device {dev[w]:.4f} ms), "
            f"plain {tp[w]:.4f} ms, bound {bound:.4f} ms ({by}: "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); kernel at "
            f"{flops / t[w] / 1e9:.1f} TFLOP/s; max abs err {err[w]:.4g}")
        entries.append({"name": f"hstu_attn_bwd_{w}_{name}", "route": "cuda",
                        "source": SRC + "hstu_attn_bwd_sm90.cuh",
                        "replaces": f"{TPU}:{rows}", "launches": None,
                        "max_abs_err": err[w], "ms": t[w], "plain_ms": tp[w],
                        "bound_ms": bound, "bound_by": by,
                        "library_ms": None})
    flops, nbytes = attn_bwd_bound(B, L, D, H, "pair")
    bound, by, _, _ = _bound(flops, nbytes)
    total = t["dq"] + t["dkdv"]
    log(f"attention backward at {name}: dq + dk/dv {total:.4f} ms (device "
        f"{dev['dq'] + dev['dkdv']:.4f} ms), plain {tp['dq'] + tp['dkdv']:.4f}"
        f" ms, bound {bound:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB), {total / bound:.1f}x the bound; "
        f"{7 * prod / total / 1e9:.1f} TFLOP/s over the 7 products run "
        f"({7 * prod / 1e9:.2f} GFLOP) {'ok' if ok else 'FAIL'}")
    del q, k, v, dav
    _free()
    return ok, entries


def phase_attn_bwd():
    """The HSTU attention backward of csrc/hstu_attn_bwd_sm90.cuh (the
    single device's fused backward and the ring's pairs launch it): held to
    the plain pair version at B=2, L=1024, in bf16 at hd 8, 16, 32, 64 and
    128 (the wgmma kernels) and in f32 at hd 16 and 64 (the generic ones),
    at off 0 (the causal diagonal) and +L (every pair visible); then timed
    at the flagship, long and sparse shapes. Returns (ok, {run name: the
    JSON entries of dq and dk/dv})."""
    import torch

    t0 = time.perf_counter()
    ok, i = True, 0
    cases = [(hd, H, torch.bfloat16) for hd, H in ATTN_BWD_HEADS] + [
        (16, 4, torch.float32), (64, 1, torch.float32)]
    for hd, H, dt in cases:
        for off in (0, 1024):
            ok &= check_attn_bwd(2, 1024, hd, H, off, dt, 200 + i)
            i += 1
    entries = {}
    for name, (B, L, D, H) in ATTN_BWD_SHAPES.items():
        ok_t, entries[name] = attn_bwd_times(name, B, L, D, H)
        ok &= ok_t
    log(f"attention backward phase: {time.perf_counter() - t0:.1f} s")
    return ok, entries


def attn_bwd_spills(report):
    """Whether the attention backward's wgmma kernels at W <= 64 spill
    nothing in this run's build (-Xptxas -v): 8 instances each in
    fused_block_bwd and ring_pair (attn_bwd_*_wgmma_kernel<W, 0, 0>) and 16
    in hstu_attention (the standalone instance, <W, 1, 0>, and its
    silu_qkv instance, <W, 1, 1>); logs each instance."""
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    ok = True
    for lib, flags in (("fused_block_bwd", ("0, 0",)),
                       ("ring_pair", ("0, 0",)),
                       ("hstu_attention", ("1, 0", "1, 1"))):
        if lib not in report:
            log(f"{lib}: not built in this run; spills not read")
            continue
        found = []
        for k in kernels.ptxas_report(report[lib]["log"]):
            m = re.match(r"attn_bwd_(dq|dkdv)_wgmma_kernel<(\d+), "
                         r"([01], [01])>$", k["kernel"])
            if not m or m.group(3) not in flags:
                continue
            spill = k["spill_stores"] + k["spill_loads"]
            found.append(f"{k['kernel']} {k['registers']} registers, spills "
                         f"{k['spill_stores']}/{k['spill_loads']} B")
            ok &= int(m.group(2)) > 64 or spill == 0
        ok &= len(found) == 8 * len(flags)
        log(f"{lib}: attention backward wgmma kernels: {'; '.join(found)} "
            f"{'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 3c: the post half and the gate/FFN backward on wgmma
# ---------------------------------------------------------------------------

#: the main paths' shapes of the two kernels (B, L, D, H, F)
POST_SHAPES = {"flagship": (128, 1024, 64, 1, 256),
               "long": (32, 4096, 64, 1, 256),
               "sparse": (64, 1024, 64, 4, 256)}
#: TPU kernel lines of each shape's (forward, backward): the whole-sequence
#: kernels (rows 1, 2) or the chunked variant's stages (rows 4-5, 6)
_POST_REPLACES = {"flagship": ("274", "325"), "long": ("468,502", "612"),
                  "sparse": ("274", "325")}


def post_times(name, B, L, D, H, F):
    """At a main path's shape, in bf16 with the flagship's dropout: the
    forward's second kernel (attn_ffn_wgmma_kernel; inference and training)
    in the whole forward's wrapper, held to the plain attention and post
    half on the q, k, v and u that proj_kernel writes (ring_pre_fwd: the
    same kernel), its time alone the profiler's device ms; and
    gate_ffn_bwd_wgmma_kernel with wgrad_wgmma_kernel (the ring's stage-0
    launch at the whole sequence), held to its plain version and timed
    (CUDA events; device ms by the profiler). Each beside its plain version
    and its own bound. Returns (ok, the three JSON entries without
    launches)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    bf16, p = torch.bfloat16, FLAGSHIP_DROPOUT
    x, ops, tt = block_inputs(B, L, D, H, F, 128, bf16, seed=51)
    seed = torch.tensor([7], dtype=torch.int32, device="cuda")
    q, k, v, u = FB.ring_pre_fwd(x, ops, L, H)
    chunked = FB.chunked(L, D)

    def plain(train):
        """attention from q, k, v (the f32 sum; the chunked variant's T(av))
        and the post half on it"""
        av = FB.ring_pair_fwd_plain(q, k, v, tt, ops["rab"], 0, H)
        if chunked:
            av = av.to(bf16).float()
        return FB.ring_post_fwd_plain(x, av, u, ops, seed if train else 0,
                                      p if train else 0.0), av.to(bf16)

    kern = {"fwd": lambda: FB.fused_hstu_block(x, ops, tt, H),
            "fwd_train": lambda: FB.fused_hstu_block_train(x, ops, tt, H,
                                                           seed, p)}
    err, ok = {}, True
    ok_f, err["fwd"], _ = compare(kern["fwd"](), plain(False)[0], bf16)
    got, want = kern["fwd_train"](), plain(True)
    ok_t, e1, _ = compare(got[0], want[0], bf16)
    ok_a, e2, _ = compare_grad(got[1], want[1], bf16)
    err["fwd_train"] = max(e1, e2)
    av = want[1]
    del got, want
    _free()
    dout = torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(52), device="cuda").to(bf16)
    kern["bwd"] = lambda: FB.ring_post_bwd(x, av, dout, ops, seed, p, L, H)
    got = kern["bwd"]()
    want = FB.ring_post_bwd_plain(x, av, dout, ops, seed, p, L, H)
    res = [compare_grad(got[n], want[n], bf16) for n in want]
    ok_b = all(r[0] for r in res) and all(
        bool(torch.isfinite(got[n].float()).all()) for n in want)
    again = kern["bwd"]()
    same = all(torch.equal(got[n], again[n]) for n in got)
    err["bwd"] = max(r[1] for r in res)
    del got, want, again
    _free()
    ok = ok_f and ok_t and ok_a and ok_b and same
    plains = {"fwd": lambda: plain(False), "fwd_train": lambda: plain(True),
              "bwd": lambda: FB.ring_post_bwd_plain(x, av, dout, ops, seed,
                                                    p, L, H)}
    # the forward's wrapper also runs proj_kernel: the second kernel's
    # time alone is its device time; the backward's stage wrapper runs the
    # two kernels and the fixed-order sum alone (CUDA events)
    wrapper = {w: time_ms(kern[w], 3, 20) for w in kern}
    dev = {"fwd": kernel_device_ms(kern["fwd"], POST_WGMMA[:1]),
           "fwd_train": kernel_device_ms(kern["fwd_train"], POST_WGMMA[:1]),
           "gate": kernel_device_ms(kern["bwd"], POST_WGMMA[1:2]),
           "wgrad": kernel_device_ms(kern["bwd"], POST_WGMMA[2:])}
    t = {"fwd": dev["fwd"], "fwd_train": dev["fwd_train"],
         "bwd": wrapper["bwd"]}
    tp = {w: time_ms(plains[w], 1, 3) for w in plains}
    _free()
    bounds = {"fwd": attn_ffn_bound(B, L, D, H, F, 2),
              "fwd_train": attn_ffn_bound(B, L, D, H, F, 2, train=True),
              "bwd": gate_ffn_bwd_bound(B, L, D, H, F, 2)}
    rows = _POST_REPLACES[name]
    entries = []
    for w, src, row, kname in (
            ("fwd", "fused_block.cu", rows[0], "attn_ffn"),
            ("fwd_train", "fused_block.cu", rows[0], "attn_ffn_train"),
            ("bwd", "fused_block_bwd.cu", rows[1], "gate_ffn_bwd")):
        flops, nbytes = bounds[w]
        bound, by, _, _ = _bound(flops, nbytes)
        timing = (f"kernel {t[w]:.4f} ms (device; the whole forward's "
                  f"wrapper {wrapper[w]:.4f} ms)" if w != "bwd" else
                  f"kernels {t[w]:.4f} ms (CUDA events; device "
                  f"{dev['gate']:.4f} + wgrad {dev['wgrad']:.4f} ms)")
        log(f"{kname} alone at {name} (B={B}, L={L}, D={D}, H={H}, F={F}, "
            f"bf16, p={p}): {timing}, plain {tp[w]:.4f} ms, bound "
            f"{bound:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), {t[w] / bound:.1f}x the bound, "
            f"{flops / t[w] / 1e9:.1f} TFLOP/s; max abs err {err[w]:.4g}")
        entries.append({"name": f"{kname}_{name}", "route": "cuda",
                        "source": SRC + src, "replaces": f"{TPU}:{row}",
                        "launches": None, "max_abs_err": err[w], "ms": t[w],
                        "plain_ms": tp[w], "bound_ms": bound,
                        "bound_by": by, "library_ms": None})
    scratch = gate_scratch_bytes(B, L, D, F, 2)
    log(f"gate_ffn_bwd's design cost at {name}: its bf16 scratch, "
        f"{scratch / 1e6:.2f} MB written and read again, "
        f"{scratch / PEAK_BYTES * 1e3:.4f} ms at the memory rate (not in "
        f"its bound)")
    log(f"post half and gate/FFN backward at {name}: held to the plain "
        f"versions: forward {ok_f}, training {ok_t and ok_a}, backward "
        f"{ok_b}; two backward calls bitwise equal: {same} "
        f"{'ok' if ok else 'FAIL'}")
    del x, ops, tt, av, dout, q, k, v, u
    _free()
    return ok, entries


def phase_post():
    """attn_ffn_wgmma_kernel and gate_ffn_bwd_wgmma_kernel (with
    wgrad_wgmma_kernel) alone at the flagship, long and sparse shapes.
    Every other case of these kernels is in phase_kernels (bf16 at D = 32,
    64 and 128, H = 1-4, L = 256-16384, dropout, the chunked rounding
    point) and the ring's stage checks. Returns (ok, {run name: the JSON
    entries})."""
    t0 = time.perf_counter()
    ok, entries = True, {}
    for name, shp in POST_SHAPES.items():
        ok_t, entries[name] = post_times(name, *shp)
        ok &= ok_t
    log(f"post-half phase: {time.perf_counter() - t0:.1f} s")
    return ok, entries


def post_spills(report):
    """Registers and spills of the wgmma post-half and gate/FFN kernels in
    this run's build (-Xptxas -v of fused_block and fused_block_bwd):
    attn_ffn_wgmma_kernel<W, DW> (9 instances), gate_ffn_bwd_wgmma_kernel
    <DW> (3) and wgrad_wgmma_kernel; a spill at DW <= 64 (D <= 64) fails.
    Logs each instance."""
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    ok = True
    want = {"fused_block": 9, "fused_block_bwd": 4}
    for lib, n in want.items():
        if lib not in report:
            log(f"{lib}: not built in this run; spills not read")
            continue
        found = []
        for k in kernels.ptxas_report(report[lib]["log"]):
            m = re.match(r"(?:attn_ffn_wgmma_kernel<\d+, |"
                         r"gate_ffn_bwd_wgmma_kernel<)(\d+)>$|"
                         r"wgrad_wgmma_kernel$", k["kernel"])
            if not m:
                continue
            spill = k["spill_stores"] + k["spill_loads"]
            found.append(f"{k['kernel']} {k['registers']} registers, spills "
                         f"{k['spill_stores']}/{k['spill_loads']} B")
            ok &= (m.group(1) is not None and int(m.group(1)) > 64) or \
                spill == 0
        ok &= len(found) == n
        log(f"{lib}: post-half and gate/FFN wgmma kernels: "
            f"{'; '.join(found)} {'ok' if ok else 'FAIL'}")
    return ok


def wgmma_route(name, by_name, train=True):
    """Whether a profiled bf16 step (train) or predict batch ran the fused
    block's wgmma kernels, each with device time: the projection and the
    post half and, training, the gate/FFN backward with its weight-gradient
    kernel and the projection backward; and no bf16 instance of the kernels
    they replace. Logs the names found."""
    want, forbid = route_names("fused", train)
    found = {n: sum(v for k, v in by_name.items() if n in k)
             for n in PRE_WGMMA + POST_WGMMA + forbid}
    ok = all(found[n] > 0 for n in want) and not any(
        found[n] for n in forbid)
    log(f"{name}: the fused block's wgmma route in the profiled "
        f"{'step' if train else 'predict batch'} (device ms): "
        + ", ".join(f"{n} {v:.3f}" for n, v in found.items())
        + f" {'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 3d: the pre half (LN1 and the projection) on wgmma
# ---------------------------------------------------------------------------

#: the main paths' shapes of the pre half (B, L, D, H), and the shard of the
#: S = 2 ring step (L the shard's tokens; the whole sequence twice that)
PRE_SHAPES = {"flagship": (128, 1024, 64, 1), "long": (32, 4096, 64, 1),
              "sparse": (64, 1024, 64, 4), "ring": (32, 2048, 64, 1)}
#: TPU kernel lines of each shape's (forward, backward): the whole-sequence
#: kernels' first and last stages (rows 1, 2), the chunked variant's (rows
#: 3, 9), the ring's pre stage (rows 3, 9 through ring_pre_proj)
_PRE_REPLACES = {"flagship": ("274", "325"), "long": ("452", "710"),
                 "sparse": ("274", "325"), "ring": ("452", "710")}
#: the redesigned kernels' selectors, and what a copy of each source built
#: beside the checkout's puts in their place so that the first design runs
#: in bf16 too (proj_kernel, proj_bwd_kernel; the ring's pair_fwd_kernel;
#: the standalone HSTU attention's hstu_fwd_kernel and hstu_bwd_dq/dkdv;
#: the group gather with streaming hints): its times beside the new
#: kernels'
_FIRST_DESIGN = {
    "fused_block": ("  return is_bf16 && fb90::post_width(p.D) != 0;\n",
                    "  return false;\n"),
    "fused_block_bwd": ("inline bool proj_wgmma_on(const BwdArgs& p) { "
                        "return p.h1s != nullptr; }",
                        "inline bool proj_wgmma_on(const BwdArgs&) { "
                        "return false; }"),
    "ring_pair": ("  return is_bf16 && fb90::attn_heads(p.D, p.H);\n",
                  "  return false;\n"),
    "hstu_attention": ("  return is_bf16 && wgmma_heads(D, H);\n",
                       "  return false;\n"),
    "sparse_table": ("constexpr bool kGatherStream = false;",
                     "constexpr bool kGatherStream = true;")}


def start_first_design_builds():
    """One nvcc per edited copy of _FIRST_DESIGN, started now (beside the
    checkout's build); first_design_libs collects them."""
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    procs = {}
    for lib, (old, new) in _FIRST_DESIGN.items():
        text = (kernels.CSRC / kernels.SOURCES[lib]).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"first design: the selector of {lib} is not "
                               f"where chip_smoke looks for it")
        d = WORK / "first_design" / lib
        d.mkdir(parents=True, exist_ok=True)
        (d / kernels.SOURCES[lib]).write_text(text.replace(old, new))
        for h in kernels.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        out = d / f"lib{lib}.so"
        procs[lib] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(out),
             str(d / kernels.SOURCES[lib])], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    return procs


def first_design_libs(procs):
    """{library name: the loaded copy} of start_first_design_builds'."""
    import ctypes

    libs = {}
    for lib, (proc, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the first design's {lib}:"
                               f"\n{text}")
        libs[lib] = ctypes.CDLL(str(out))
    return libs


@contextlib.contextmanager
def first_design(libs):
    """The wrappers launch the first design's copies inside the block."""
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    saved = {n: kernels.load(n) for n in libs}
    kernels._LIBS.update(libs)
    try:
        yield
    finally:
        kernels._LIBS.update(saved)


def ffn_width(D):
    """F of a block of width D, as the model config sizes SwiGLU."""
    from tencent_recommendation_2025_tpu_torch.config import ModelConfig
    from tencent_recommendation_2025_tpu_torch.models import encoder as ENC

    cfg = ModelConfig()
    return ENC.swiglu_hidden_dim(D, cfg.ffn_hidden_mult, cfg.ffn_multiple_of)


def pre_bwd_plain(x, ops, cots, dy, L, H):
    """Plain version of the single device's projection backward step: f32
    du, dv, dq (times hd^-1/2 already), dk and the residual dy."""
    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    xf = x.float()
    pre, h1c, xhat1, rstd1, _ = FB._recompute_projection(
        xf, ops, L, x.shape[-1] // H, x.dtype)
    du, dv, dq, dk = cots
    return FB._pre_bwd(ops, pre, h1c, xhat1, rstd1, du, dv, dq, dk, dy, L,
                       x.dtype)


def check_pre(D, H, variant, seed):
    """The pre half in bf16 against its plain versions on the card at B=2:
    variant "whole" (L = wholeseq_max_l(D)) and "chunked" (L=4096), the
    block's training forward (out, av) and backward, which launch the pre
    half's kernels; "ring", the pre stage (a shard of 2048 of 4096 tokens)
    and its backward (bf16 dq, dk, dv, f32 du), twice, bitwise equal."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    bf16 = torch.bfloat16
    L = {"whole": FB.wholeseq_max_l(D), "chunked": 4096, "ring": 2048}[
        variant]
    x, ops, tt = block_inputs(2, L, D, H, ffn_width(D), 128, bf16, seed)
    got, want, same = {}, {}, True
    if variant == "ring":
        for n, g, w in zip("qkvu", FB.ring_pre_fwd(x, ops, 2 * L, H),
                           FB.ring_pre_fwd_plain(x, ops, 2 * L, H)):
            got[n], want[n] = g, w
        g = torch.Generator(device="cuda").manual_seed(seed)
        cots = [torch.randn(x.shape, generator=g, device="cuda")
                for _ in range(4)]
        cots = [c.to(bf16) for c in cots[:3]] + cots[3:]
        bwd = FB.ring_pre_bwd(x, ops, *cots, 2 * L, H)
        again = FB.ring_pre_bwd(x, ops, *cots, 2 * L, H)
        ref = FB.ring_pre_bwd_plain(x, ops, *cots, 2 * L, H)
    else:
        got["out"], got["av"] = FB.fused_hstu_block_train(x, ops, tt, H, 3,
                                                          0.01)
        want["out"], want["av"] = FB.fused_hstu_block_train_plain(
            x, ops, tt, H, 3, 0.01)
        dout = torch.randn(x.shape, generator=torch.Generator(
            device="cuda").manual_seed(seed), device="cuda").to(bf16)
        bwd = FB.fused_hstu_block_bwd(x, want["av"], dout, ops, tt, H, 3,
                                      0.01)
        again = FB.fused_hstu_block_bwd(x, want["av"], dout, ops, tt, H, 3,
                                        0.01)
        ref = FB.fused_hstu_block_bwd_plain(x, want["av"], dout, ops, tt, H,
                                            3, 0.01)
    torch.cuda.synchronize()
    for n in ref:
        got[f"bwd {n}"], want[f"bwd {n}"] = bwd[n], ref[n]
        same &= torch.equal(bwd[n], again[n])
    ok, worst, fails = same, (None, 0.0), []
    for n in want:
        cmp = compare if n == "out" else compare_grad
        okg, eg, lim = cmp(got[n], want[n], bf16)
        okg &= bool(torch.isfinite(got[n].float()).all())
        ok &= okg
        if eg >= worst[1]:
            worst = (n, eg)
        if not okg:
            fails.append(f"{n} {eg:.4g} ({lim})")
    log(f"pre half {variant} B=2 L={L} D={D} H={H} bf16: largest error "
        f"{worst[1]:.6g} ({worst[0]}); backward bitwise equal across two "
        f"calls: {same}" + (f", failing: {'; '.join(fails)}" if fails else "")
        + f" {'ok' if ok else 'FAIL'}")
    del x, ops, tt, got, want, bwd, again, ref
    _free()
    return ok


def pre_times(name, B, L, D, H, libs):
    """At a main path's shape, in bf16: the projection alone (the ring's
    stage-0 entry; at the single device's shapes with the whole sequence's
    1/L, the same launch as the whole forward's first) and its backward
    alone (stage 1's entry; at the single device's shapes with f32
    cotangents and the f32 residual, as the whole backward launches it; in
    the ring with bf16 dq, dk, dv, f32 du and no residual), each held to its
    plain version, then timed (CUDA events over the entry: the kernel, and
    in the backward wgrad_wgmma_kernel and the fixed-order sum; the
    kernel's device ms by the profiler) beside its bound, its plain
    version and the first design's kernel (proj_kernel, proj_bwd_kernel) in
    the same call. Returns (ok, the two JSON entries without launches)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    bf16, ring = torch.bfloat16, name == "ring"
    seq = 2 * L if ring else L
    x, ops, _ = block_inputs(B, L, D, H, ffn_width(D), 128, bf16, seed=71)
    g = torch.Generator(device="cuda").manual_seed(72)
    cots = [torch.randn(x.shape, generator=g, device="cuda")
            for _ in range(4)]
    dy = None if ring else torch.randn(x.shape, generator=g, device="cuda")
    if ring:   # dq, dk, dv as the pairs' backward returns them
        cots = [c.to(bf16) for c in cots[:3]] + cots[3:]
    dq, dk, dv, du = cots

    def fwd():
        return FB.ring_pre_fwd(x, ops, seq, H)

    def bwd():
        if ring:
            return FB.ring_pre_bwd(x, ops, dq, dk, dv, du, seq, H)
        dx = torch.empty_like(x)
        out = FB._launch_bwd_stage(1, x, ops, H, seq, 0, 0.0,
                                   ("ln", "wuvqk", "buvqk"), dx=dx, dy=dy,
                                   du=du, dq=dq, dk=dk, dv=dv)
        return dict(out, dx=dx)

    def bwd_plain():
        if ring:
            return FB.ring_pre_bwd_plain(x, ops, dq, dk, dv, du, seq, H)
        return pre_bwd_plain(x, ops, (du, dv, dq, dk), dy, seq, H)

    want_f = FB.ring_pre_fwd_plain(x, ops, seq, H)
    res = [compare_grad(a, b, bf16) for a, b in zip(fwd(), want_f)]
    want_b = bwd_plain()
    got_b = bwd()
    res_b = [compare_grad(got_b[n], want_b[n], bf16) for n in want_b]
    same = all(torch.equal(got_b[n], v) for n, v in bwd().items())
    ok = all(r[0] for r in res + res_b) and same
    err = {"fwd": max(r[1] for r in res), "bwd": max(r[1] for r in res_b)}
    del want_f, want_b, got_b
    _free()
    t = {"fwd": time_ms(fwd, 3, 20), "bwd": time_ms(bwd, 3, 20)}
    dev = {"fwd": kernel_device_ms(fwd, PRE_WGMMA[:1]),
           "bwd": kernel_device_ms(bwd, PRE_WGMMA[1:]),
           "wgrad": kernel_device_ms(bwd, ("wgrad_wgmma_kernel",))}
    tp = {"fwd": time_ms(lambda: FB.ring_pre_fwd_plain(x, ops, seq, H), 1,
                         3),
          "bwd": time_ms(bwd_plain, 1, 3)}
    with first_design(libs):
        old = {"fwd": time_ms(fwd, 3, 20), "bwd": time_ms(bwd, 3, 20),
               "fwd_dev": kernel_device_ms(fwd, ("proj_kernel",)),
               "bwd_dev": kernel_device_ms(bwd, ("proj_bwd_kernel",))}
    _free()
    bounds = pre_bounds(B, L, D, 2, ring=ring)
    entries = []
    for w, src, row, kname in (
            ("fwd", "fused_block.cu", _PRE_REPLACES[name][0], "proj"),
            ("bwd", "fused_block_bwd.cu", _PRE_REPLACES[name][1],
             "proj_bwd")):
        flops, nbytes = bounds[w]
        bound, by, _, _ = _bound(flops, nbytes)
        extra = f" + wgrad {dev['wgrad']:.4f}" if w == "bwd" else ""
        log(f"{kname} alone at {name} (B={B}, L={L}, D={D}, H={H}, bf16"
            + (", ring stage" if ring else "") + f"): kernel {t[w]:.4f} ms "
            f"(CUDA events; device {dev[w]:.4f}{extra} ms), first design "
            f"{old[w]:.4f} ms (device {old[w + '_dev']:.4f} ms), plain "
            f"{tp[w]:.4f} ms, bound {bound:.4f} ms ({by}: "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
            f"{t[w] / bound:.1f}x the bound, {nbytes / t[w] / 1e6:.1f} GB/s "
            f"of its own bytes; max abs err {err[w]:.4g}")
        entries.append({"name": f"{kname}_{name}", "route": "cuda",
                        "source": SRC + src, "replaces": f"{TPU}:{row}",
                        "launches": None, "max_abs_err": err[w], "ms": t[w],
                        "plain_ms": tp[w], "bound_ms": bound, "bound_by": by,
                        "library_ms": None})
    scratch = pre_scratch_bytes(B, L, D, 2)
    log(f"proj_bwd's design cost at {name}: its bf16 scratch T(h1), "
        f"T(duvqk), {scratch / 2e6:.2f} MB written and read again, "
        f"{scratch / PEAK_BYTES * 1e3:.4f} ms at the memory rate (not in its "
        f"bound); held to the plain versions {ok} (two backward calls "
        f"bitwise equal: {same}) {'ok' if ok else 'FAIL'}")
    del x, ops, cots, dq, dk, dv, du, dy
    _free()
    return ok, entries


def phase_pre(libs):
    """proj_wgmma_kernel and proj_bwd_wgmma_kernel (with
    wgrad_wgmma_kernel): held to their plain versions in bf16 at D = 32, 64
    and 128 and H = 1 and 4, whole sequence, chunked (L=4096) and ring
    stage; the first design in bf16 at D=256 (the ring stage, its bf16
    cotangents); then each kernel alone at the flagship, long, sparse and
    ring-stage shapes beside its bound and the first design's kernel.
    Returns (ok, {run name: the JSON entries}; the ring stage's are
    phase_ring_times')."""
    t0 = time.perf_counter()
    ok, i = True, 0
    for D in (32, 64, 128):
        for H in (1, 4):
            for variant in ("whole", "chunked", "ring"):
                ok &= check_pre(D, H, variant, 300 + i)
                i += 1
    ok &= check_pre(256, 4, "ring", 330)
    entries = {}
    for name, shp in PRE_SHAPES.items():
        ok_t, entries[name] = pre_times(name, *shp, libs)
        ok &= ok_t
    entries.pop("ring")
    log(f"pre-half phase: {time.perf_counter() - t0:.1f} s")
    return ok, entries


def pre_smem(DW, bwd):
    """Dynamic shared memory of proj_wgmma_kernel<DW> (bwd False) or
    proj_bwd_wgmma_kernel<DW>, as ProjCarve and ProjBwdCarve carve it:
    Wuvqk's four DW x DW slices held (DW <= 64) or two in the ring; the
    backward's T(h1) fragments and column sums; 1024 bytes of alignment
    slack."""
    w = (4 if DW <= 64 else 2) * DW * DW * 2
    keep = DW // 4 * 128 * 4 if bwd else 0
    red = -(-48 * DW * 4 // 1024) * 1024 if bwd else 0
    return 1024 + w + keep + red


def fwd_spills(report, lib, kernel, variants=1):
    """Registers and spills of the wgmma forward ``kernel``<W> (W = 16, 32,
    64, 128) in this run's build of ``lib`` (ring_pair's
    pair_fwd_wgmma_kernel; hstu_attention's hstu_fwd_wgmma_kernel<W, 0>
    and its silu_qkv instance <W, 1>: ``variants`` 2); a spill at W <= 64
    fails, and so do more than 128 registers there (4 blocks an SM). Logs
    each instance."""
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    if lib not in report:
        log(f"{lib}: not built in this run; spills not read")
        return True
    ok, found = True, []
    for k in kernels.ptxas_report(report[lib]["log"]):
        m = re.match(kernel + r"<(\d+)(?:, [01])?>$", k["kernel"])
        if not m:
            continue
        W = int(m.group(1))
        found.append(f"{k['kernel']} {k['registers']} registers, spills "
                     f"{k['spill_stores']}/{k['spill_loads']} B")
        ok &= W > 64 or (k["spill_stores"] + k["spill_loads"] == 0
                         and k["registers"] <= 128)
    ok &= len(found) == 4 * variants
    log(f"{lib}: {'; '.join(found)} {'ok' if ok else 'FAIL'}")
    return ok


def pre_spills(report):
    """Registers, shared memory and spills of the wgmma pre-half kernels in
    this run's build (-Xptxas -v of fused_block and fused_block_bwd):
    proj_wgmma_kernel<DW> and proj_bwd_wgmma_kernel<DW>, 3 instances each;
    a spill at DW <= 64 (D <= 64) fails. Logs each instance."""
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    ok = True
    for lib, pat in (("fused_block", r"proj_wgmma_kernel<(\d+)>$"),
                     ("fused_block_bwd", r"proj_bwd_wgmma_kernel<(\d+)>$")):
        if lib not in report:
            log(f"{lib}: not built in this run; spills not read")
            continue
        found = []
        for k in kernels.ptxas_report(report[lib]["log"]):
            m = re.match(pat, k["kernel"])
            if not m:
                continue
            spill = k["spill_stores"] + k["spill_loads"]
            DW = int(m.group(1))
            found.append(f"{k['kernel']} {k['registers']} registers, "
                         f"{pre_smem(DW, lib != 'fused_block')} B of shared "
                         f"memory, spills {k['spill_stores']}/"
                         f"{k['spill_loads']} B")
            ok &= DW > 64 or spill == 0
        ok &= len(found) == 3
        log(f"{lib}: pre-half wgmma kernels: {'; '.join(found)} "
            f"{'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 3b: the attention cores (flash MHA, standalone HSTU attention)
# ---------------------------------------------------------------------------

def attention_inputs(B, L, D, H, dtype, seed, NB=128):
    """Seeded q, k, v, dout [B, L, D] and rab [H, NB] on the card, and the
    key-valid mask: row 0 left-padded, the last row (B > 1) fully
    padded."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32)).cuda()

    q, k, v, dout = (t((B, L, D)).to(dtype) for _ in range(4))
    valid = np.ones((B, L), bool)
    valid[0, :L // 3 + 5] = False
    if B > 1:
        valid[-1] = False
    return q, k, v, dout, torch.from_numpy(valid).cuda(), t((H, NB), 0.1)


def _attn_fns(kind, valid, rab, L, H):
    """(kernel forward, kernel backward, plain forward, plain backward) of
    one attention core: each forward on (q, k, v) gives (out, aux), each
    backward on (q, k, v, dout, aux) the gradients. aux is flash MHA's row
    stats (the forward's softmax max and sum, which its backward takes),
    None for the HSTU attention."""
    from tencent_recommendation_2025_tpu_torch.ops import flash_attention as FA
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    if kind == "flash":
        return (lambda q, k, v: FA.flash_mha_fwd(q, k, v, valid, H,
                                                 return_stats=True),
                lambda q, k, v, d, st: FA.flash_mha_bwd(q, k, v, d, valid, H,
                                                        st),
                lambda q, k, v: FA.flash_mha_fwd_plain(q, k, v, valid, H,
                                                       return_stats=True),
                lambda q, k, v, d, st: FA.flash_mha_bwd_plain(
                    q, k, v, d, valid, H, st))
    if kind == "hstu_chunk":
        fwd, bwd = HA.hstu_attention_chunk_fwd, HA.hstu_attention_chunk_bwd
    else:
        fwd, bwd = HA.hstu_attention_fwd, HA.hstu_attention_bwd
    return (lambda q, k, v: (fwd(q, k, v, valid, rab, L, H), None),
            lambda q, k, v, d, _: bwd(q, k, v, d, valid, rab, L, H),
            lambda q, k, v: (HA.hstu_attention_fwd_plain(q, k, v, valid, rab,
                                                         L, H), None),
            lambda q, k, v, d, _: HA.hstu_attention_bwd_plain(
                q, k, v, d, valid, rab, L, H))


def compare_stats(st, ref):
    """(ok, text) of flash MHA's row stats against the plain version's: on
    rows with no visible key the max is exactly finfo(f32).min and the sum
    exactly 0 in both; elsewhere the max within 1e-4 * max(1, |max|) and
    the sum within 1e-4 * sum (f32 sums of the same scores in another
    order)."""
    import torch

    m, z, rm, rz = st[0], st[1], ref[0], ref[1]
    dead = rz == 0
    exact = bool((z[dead] == 0).all() and (m[dead] == rm[dead]).all()
                 and (rm[dead] == torch.finfo(torch.float32).min).all())
    live = ~dead
    em = ((m - rm).abs() / rm.abs().clamp(min=1.0))[live].max().item()
    ez = ((z - rz).abs() / rz)[live].max().item()
    ok = exact and em <= 1e-4 and ez <= 1e-4
    return ok, (f"stats: max rel err {em:.3g}, sum rel err {ez:.3g} (limit "
                f"1e-4), {int(dead.sum())} rows with no visible key exact "
                f"{exact}")


def compare_attn(out, ref, dtype):
    """(ok, max_abs_err, limit text) of an attention output: tokens the
    mask zeroes in ``ref`` (no visible key) must be exactly zero; f32
    elementwise at rtol 1e-4, atol 1e-4; bf16 max abs <= 3e-2 * max(1,
    max|ref|) and the lowest cosine over the other tokens >= 0.9995."""
    import torch

    o, r = out.float(), ref.float()
    live = r.abs().amax(-1) > 0
    zeros_ok = bool((o.abs().amax(-1)[~live] == 0).all())
    if dtype == torch.float32:
        ok, err, lim = compare(out, ref, dtype)
        return ok and zeros_ok, err, lim + ", masked tokens exactly 0"
    err = (o - r).abs().max().item()
    lim = 3e-2 * max(1.0, r.abs().max().item())
    cos = torch.nn.functional.cosine_similarity(o[live], r[live], dim=-1)
    ok = err <= lim and cos.min().item() >= 0.9995 and zeros_ok
    return ok, err, (f"max_abs<={lim:.4g}, min token cosine "
                     f"{cos.min().item():.6f} >= 0.9995, masked tokens "
                     f"exactly 0")


def check_attention(kind, B, L, D, H, dt, seed, NB=128):
    """One attention core at one shape: forward and backward kernels against
    their plain versions; on the fully padded row and the padded keys and
    queries, outputs and gradients exactly 0."""
    import torch

    t0 = time.perf_counter()
    q, k, v, dout, valid, rab = attention_inputs(B, L, D, H, dt, seed, NB)
    fwd, bwd, fwd_p, bwd_p = _attn_fns(kind, valid, rab, L, H)
    before = read_launches()
    out, aux = fwd(q, k, v)
    torch.cuda.synchronize()
    got = bwd(q, k, v, dout, aux)
    torch.cuda.synchronize()
    after = read_launches()
    # the wrappers' counters: one launch each way, on the route's own
    if kind == "flash":
        route = "flash"
    else:
        from tencent_recommendation_2025_tpu_torch.ops import \
            hstu_attention as HA

        route = "hstu_chunk" if HA._use_long(L, D) else "hstu"
    ok_route = {k_: after[k_] - before[k_] for k_ in after} == dict(
        dict.fromkeys(after, 0), **{f"{route}_fwd": 1, f"{route}_bwd": 1})
    # the HSTU attention's second call: the same bits (drab summed in a
    # fixed order, no atomics)
    same = kind == "flash" or (torch.equal(fwd(q, k, v)[0], out) and all(
        torch.equal(a, b) for a, b in zip(bwd(q, k, v, dout, aux), got)))
    ref, ref_aux = fwd_p(q, k, v)
    ok_f, e_f, lim_f = compare_attn(out, ref, dt)
    ok_f &= ok_route
    if aux is not None:   # flash MHA's row stats
        ok_s, lim_s = compare_stats(aux, ref_aux)
        ok_f &= ok_s
        lim_f += "; " + lim_s
    want = bwd_p(q, k, v, dout, ref_aux)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "drab")
    ok_b, worst, parts = True, (None, 0.0), []
    pad = L // 3 + 5
    for name, g, w in zip(names, got, want):
        okg, eg, limg = compare_grad(g, w, dt)
        okg &= bool(torch.isfinite(g.float()).all())
        if name != "drab":   # padded keys / queries and the padded row
            okg &= bool((g[0, :pad] == 0).all())
            if B > 1:
                okg &= bool((g[-1] == 0).all())
        ok_b &= okg
        if eg >= worst[1]:
            worst = (name, eg)
        if not okg:
            parts.append(f"{name} {eg:.4g} ({limg})")
    ok = ok_f and ok_b and same
    log(f"{kind} B={B} L={L} D={D} H={H} hd={D // H}"
        + (f" NB={NB}" if kind == "hstu" else "")
        + f" {str(dt)[6:]} ({route} counters {ok_route}"
        + ("" if kind == "flash" else f", two calls bitwise equal {same}")
        + "): forward "
        f"max_abs_err={e_f:.6g} ({lim_f}); "
        f"backward largest error {worst[1]:.6g} ({worst[0]})"
        + (f", failing: {'; '.join(parts)}" if parts else "")
        + f"; {time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    del q, k, v, dout, out, got, want, aux, ref_aux
    _free()
    return ok


#: HSTU heads past 256, which the first design takes (B, L, D, H): hd 512
#: and 320 at L=256, the chunked route at L=2048, and hd 1024, whose
#: backward (bf16 and f32) and forward (f32) stream the head through
#: shared memory in column slices
WIDE_HEADS = [("hstu", 2, 256, 512, 1, 128), ("hstu", 2, 256, 640, 2, 128),
              ("hstu", 1, 2048, 512, 1, 128),
              ("hstu", 2, 256, 1024, 1, 128)]


def phase_attention_kernels():
    """The attention cores against their plain versions on seeded inputs
    with left padding and one fully padded row (B > 1): flash MHA at L=256
    (H=4) and L=1024 (H=1); HSTU attention at L=256 and 1024 with H=4 and
    H=1 and buckets 128 and 300; the chunked HSTU route (past _use_long) at
    L = 2048, 4096 and 16384 (hstu_mini's D=64, H=4) and with 1000 buckets
    (H=1: the JAX package's 256 tile); the HSTU attention also at the
    bucket edges the JAX package takes (32; 898 on the whole-sequence
    route at L=1024; 1794 on the chunked one at L=2048) and at hd 32 (D=64,
    H=2), a second call bitwise equal to the first in bf16; both cores at
    hd 8 (D=32, H=4) and
    hd 128 (D=128, H=1); flash MHA also at hd 16 with L=1024 (D=64, H=4),
    hd 24 (D=96, H=4, L=512: a head padded to 32 columns), hd 256 (D=256,
    H=1, L=256: the first kernels' bf16 path), L=384 (D=64, H=1: six
    tiles) and hd 9 (D=36, H=4: an odd head, copied through registers),
    its kernel's row stats held to the plain version's; the HSTU heads
    past 256 (``WIDE_HEADS``: the first design, its column slices at hd
    1024); f32 (tight) and bf16. Each call is held to its own route's
    counters."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("flash", 8, 256, 64, 4, 128), ("flash", 4, 1024, 64, 1, 128),
             ("hstu", 8, 256, 64, 4, 128), ("hstu", 8, 256, 64, 1, 300),
             ("hstu", 4, 1024, 64, 1, 128), ("hstu", 4, 1024, 64, 4, 300),
             ("hstu", 2, 2048, 64, 4, 128), ("hstu", 2, 4096, 64, 4, 128),
             ("hstu", 1, 16384, 64, 4, 128), ("hstu", 2, 2048, 64, 1, 1000),
             ("flash", 4, 256, 32, 4, 128), ("flash", 2, 512, 128, 1, 128),
             ("hstu", 4, 256, 32, 4, 128), ("hstu", 2, 512, 128, 1, 128),
             ("flash", 4, 1024, 64, 4, 128), ("flash", 4, 512, 96, 4, 128),
             ("flash", 4, 256, 256, 1, 128), ("flash", 4, 384, 64, 1, 128),
             ("flash", 4, 256, 36, 4, 128), ("hstu", 4, 512, 64, 4, 32),
             ("hstu", 2, 1024, 64, 4, 898), ("hstu", 2, 2048, 64, 1, 1794),
             ("hstu", 4, 512, 64, 2, 128)] + WIDE_HEADS
    ok = True
    for i, (kind, B, L, D, H, NB) in enumerate(cases):
        for dt in (f32, bf16):
            ok &= check_attention(kind, B, L, D, H, dt, 40 + i, NB)
    return ok


#: the attention cores' main-path shapes: (kind, run, B, L, D, H); the run
#: whose launches the JSON entry reports (None: timed and logged only, no
#: run takes that shape)
ATTN_SHAPES = (("flash", "baseline", 64, 256, 64, 4),
               ("flash", "baseline_o1", 128, 1024, 64, 1),
               ("hstu", "hstu_mini", 64, 256, 64, 4),
               ("hstu_chunk", "mini_long", 32, 4096, 64, 4),
               ("flash", "baseline_hd8", 64, 256, 32, 4),
               ("flash", "baseline_o1_hd128", 128, 512, 128, 1),
               ("hstu", None, 64, 256, 32, 4),
               ("hstu", None, 64, 512, 128, 1)) + tuple(
    ("hstu_chunk", None, B, L, D, H) for _, B, L, D, H, _ in WIDE_HEADS)
_ATTN_REPLACES = {
    "flash": ("flash_attention.cu",
              "tencent_recommendation_2025_tpu/ops/flash_attention.py:",
              "50", "81"),
    "hstu": ("hstu_attention.cu",
             "tencent_recommendation_2025_tpu/ops/hstu_attention.py:",
             "164", "193"),
    "hstu_chunk": ("hstu_attention.cu",
                   "tencent_recommendation_2025_tpu/ops/hstu_attention.py:",
                   "297", "331,380")}
#: JSON names of each kind's kernels
_ATTN_NAMES = {"flash": "flash_mha", "hstu": "hstu_attention",
               "hstu_chunk": "hstu_attention_chunk"}


def attention_bound(kind, B, L, D, H, elem_bytes, bwd, NB=128):
    """Least time (ms) of one attention core call: its causal products (each
    B * D * L * (L + 1) operations: q.k^T and p.v forward; s, dp or da, dv,
    dq and dk backward) over the bf16 peak, against its bytes (q, k, v
    [and dout] read once, out [or dq, dk, dv] written once, the mask, and
    for HSTU rab [and drab]) over the memory rate."""
    act = B * L * D * elem_bytes
    flops = (5 if bwd else 2) * B * D * L * (L + 1)
    nbytes = (7 if bwd else 4) * act + B * L * 4
    if kind != "flash":
        nbytes += (2 if bwd else 1) * H * NB * 4
    return _bound(flops, nbytes)


def sdpa_ms(q, k, v, dout, valid, H):
    """The library yardstick of rows 18-19: one
    ``torch.nn.functional.scaled_dot_product_attention`` call with the same
    boolean causal and key-valid mask on [B, H, L, hd] copies of the
    inputs, and one ``torch.autograd.grad`` of its output (its backward).
    Timed only: the port never calls it, and it differs on fully masked
    rows."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops.hstu_attention import \
        causal_valid

    B, L, D = q.shape

    def heads(t):
        return t.reshape(B, L, H, D // H).transpose(1, 2).contiguous()

    qh, kh, vh, dh = (heads(t) for t in (q, k, v, dout))
    mask = causal_valid(valid, L)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask), 3, 20)
    qh, kh, vh = (t.requires_grad_(True) for t in (qh, kh, vh))
    out = sdpa(qh, kh, vh, attn_mask=mask)
    bwd = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), dh,
                                              retain_graph=True), 3, 20)
    return fwd, bwd


def kernel_device_ms(fn, names, iters=10, tries=4):
    """Device ms per call of the kernels whose names contain one of
    ``names``, from a torch.profiler trace of ``iters`` calls of ``fn``
    after one: the kernels alone, without the wrapper's host time that a
    short call's CUDA-event reading includes. The profiler on the card's
    machine loses kernel events as a long run goes on (the last one or two
    of a trace, or late in a chip_smoke.py run whole traces), which a sum
    over the calls would read as a faster kernel. So the trace holds two
    calls more, each kernel name counts its mean duration times its
    launches per call (its events over the calls, rounded, at least 1), and
    a trace with fewer matching events than half the calls is taken again,
    ``tries`` times in all; NaN (not measured) if none has them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = iters + 2
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per = collections.defaultdict(list)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and any(n in e.name
                                                        for n in names):
                per[e.name].append(e.device_time_total)
        if 2 * sum(len(v) for v in per.values()) >= calls:
            return sum(sum(v) / len(v) * max(1, round(len(v) / calls))
                       for v in per.values()) / 1e3
        time.sleep(0.5)
    return float("nan")


def queued_ms(fn, iters=10):
    """ms per call of ``fn``'s kernels by CUDA events with the card's queue
    held full: a spin kernel (about 25 ms) keeps the card busy while the
    host enqueues the calls, so the reading leaves out the host's launch
    time without the profiler. For calls that launch only the kernels being
    timed."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_attention_times(libs):
    """At each main-path shape, in bf16: forward and backward kernels against
    their plain versions, then timed (CUDA events, and the kernels' device
    time by the profiler) beside them, their bounds and, for flash MHA,
    SDPA; the HSTU attention also beside its first design (the copy in
    ``libs``, by CUDA events and device time); returns (ok, JSON entries
    without launches, keyed by run)."""
    import torch

    bf16 = torch.bfloat16
    ok_all, entries = True, []
    for kind, run, B, L, D, H in ATTN_SHAPES:
        # the chunked backward's plain version holds several [B, H, L, L]
        # f32 tensors: ~40 GB at B=32, L=4096, H=4
        _free()
        q, k, v, dout, valid, rab = attention_inputs(B, L, D, H, bf16, 50)
        fwd, bwd, fwd_p, bwd_p = _attn_fns(kind, valid, rab, L, H)
        # flash MHA's backward takes the stats of a forward made once, here,
        # outside its timed window (as SDPA's timed backward its graph)
        out, aux = fwd(q, k, v)
        ref, ref_aux = fwd_p(q, k, v)
        ok, err_f, _ = compare_attn(out, ref, bf16)
        del out, ref
        err_b = 0.0
        for g, w in zip(bwd(q, k, v, dout, aux),
                        bwd_p(q, k, v, dout, ref_aux)):
            okg, eg, _ = compare_grad(g, w, bf16)
            ok &= okg
            err_b = max(err_b, eg)
        _free()
        long_ = L * D > 1024 * 64
        t = {"fwd": time_ms(lambda: fwd(q, k, v), 2 if long_ else 3,
                            5 if long_ else 20),
             "bwd": time_ms(lambda: bwd(q, k, v, dout, aux),
                            2 if long_ else 3, 5 if long_ else 20)}
        names = KERNEL_NAMES[kind]
        dev = {"fwd": kernel_device_ms(lambda: fwd(q, k, v), names[0]),
               "bwd": kernel_device_ms(lambda: bwd(q, k, v, dout, aux),
                                       names[1])}
        _free()
        first = {}
        # the first design's kernels, same wrappers (past hd 128 they are
        # the kernels timed above)
        if kind != "flash" and D // H <= 128:
            with first_design(libs):
                for key, call, names in (
                        ("fwd", lambda: fwd(q, k, v), HSTU_FIRST[:1]),
                        ("bwd", lambda: bwd(q, k, v, dout, aux),
                         HSTU_FIRST[1:])):
                    first[key] = (time_ms(call, 2 if long_ else 3,
                                          5 if long_ else 20),
                                  kernel_device_ms(call, names))
        _free()
        plain = {"fwd": time_ms(lambda: fwd_p(q, k, v), 1, 1 if long_ else 3)}
        _free()
        plain["bwd"] = time_ms(lambda: bwd_p(q, k, v, dout, ref_aux), 1,
                               1 if long_ else 3)
        _free()
        lib = sdpa_ms(q, k, v, dout, valid, H) if kind == "flash" \
            else (None, None)
        src, tpu, fwd_row, bwd_row = _ATTN_REPLACES[kind]
        name = _ATTN_NAMES[kind]
        for key, err, row, lib_ms in (("fwd", err_f, fwd_row, lib[0]),
                                      ("bwd", err_b, bwd_row, lib[1])):
            bound, by, flops, nbytes = attention_bound(
                kind, B, L, D, H, 2, key == "bwd")
            fd = (f"first design {first[key][0]:.4f} ms (device "
                  f"{first[key][1]:.4f}), " if key in first else "")
            log(f"{name}_{key} ({run or 'no run'}: B={B} L={L} D={D} H={H} "
                f"hd={D // H}): kernel "
                f"{t[key]:.4f} ms (device {dev[key]:.4f} ms by the "
                f"profiler, {flops / dev[key] / 1e9:.1f} TFLOP/s), {fd}"
                f"plain {plain[key]:.4f} ms, bound "
                f"{bound:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB), library "
                + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none")
                + f"; kernel at {flops / t[key] / 1e9:.1f} TFLOP/s; max abs "
                f"err {err:.4g} {'ok' if ok else 'FAIL'}")
            if run is None:
                continue
            hd = "" if D // H in (16, 64) else f"_hd{D // H}"
            if kind != "flash" and key == "bwd":   # the shared backward
                src = "hstu_attn_bwd_sm90.cuh"
            entries.append((run, {
                "name": f"{name}_{key}_L{L}_H{H}{hd}", "route": "cuda",
                "source": SRC + src, "replaces": tpu + row, "launches": None,
                "max_abs_err": err, "ms": t[key], "plain_ms": plain[key],
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}))
        ok_all &= ok
        del q, k, v, dout, valid, rab, aux, ref_aux
        _free()
    return ok_all, entries


# ---------------------------------------------------------------------------
# phase 3b'': the HSTU attention's in-kernel SiLU (silu_qkv)
# ---------------------------------------------------------------------------

#: silu_qkv checks (kind, B, L, D, H): W = 16 (hd 16), 64 and 128 on the
#: whole-sequence route, hd 16 on the chunked one, hd 256 (the first design
#: in both dtypes) and hd 1024 (its column slices: bf16 backward, f32
#: forward); each in f32 (the first design) and bf16
SILU_CASES = (("hstu", 4, 256, 64, 4), ("hstu", 2, 512, 64, 1),
              ("hstu", 2, 512, 128, 1), ("hstu_chunk", 2, 2048, 64, 4),
              ("hstu_chunk", 2, 256, 256, 1),
              ("hstu_chunk", 2, 256, 1024, 1))
#: the main paths' shapes of the silu_qkv instances: hstu_mini's (B=64,
#: L=256) and mini_long's (B=32, L=4096), D=64, H=4
SILU_SHAPES = (("hstu", "hstu_mini", 64, 256, 64, 4),
               ("hstu_chunk", "mini_long", 32, 4096, 64, 4))


class _SiluCounter:
    """A wrapper's ``silu_launches`` as a launch counter (``.launches``)."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.silu_launches

    @launches.setter
    def launches(self, n):
        self.fn.silu_launches = n


def _silu_fns(kind, valid, rab, L, H):
    """(kernel forward, kernel backward, plain forward, plain backward) of
    the silu_qkv instances on pre-activation q, k, v."""
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    if kind == "hstu_chunk":
        fwd, bwd = HA.hstu_attention_chunk_fwd, HA.hstu_attention_chunk_bwd
    else:
        fwd, bwd = HA.hstu_attention_fwd, HA.hstu_attention_bwd
    return (lambda q, k, v: fwd(q, k, v, valid, rab, L, H, True),
            lambda q, k, v, d: bwd(q, k, v, d, valid, rab, L, H, True),
            lambda q, k, v: HA.hstu_attention_fwd_plain(
                q, k, v, valid, rab, L, H, True),
            lambda q, k, v, d: HA.hstu_attention_bwd_plain(
                q, k, v, d, valid, rab, L, H, True))


def check_silu(kind, B, L, D, H, dt, seed):
    """One silu_qkv instance against its plain version: forward and the
    pre-activations' gradients (compare_attn, compare_grad), the fully
    masked row and the padded queries exactly 0, one launch each way on
    the route's silu counters (``silu_launches``) and none elsewhere, a
    second call bitwise equal."""
    import torch

    t0 = time.perf_counter()
    q, k, v, dout, valid, rab = attention_inputs(B, L, D, H, dt, seed)
    fwd, bwd, fwd_p, bwd_p = _silu_fns(kind, valid, rab, L, H)
    before = read_launches()
    out = fwd(q, k, v)
    got = bwd(q, k, v, dout)
    torch.cuda.synchronize()
    after = read_launches()
    ok_route = {n: after[n] - before[n] for n in after} == dict(
        dict.fromkeys(after, 0), **{f"{kind}_silu_fwd": 1,
                                    f"{kind}_silu_bwd": 1})
    same = torch.equal(fwd(q, k, v), out) and all(
        torch.equal(a, b) for a, b in zip(bwd(q, k, v, dout), got))
    ok, e_f, lim_f = compare_attn(out, fwd_p(q, k, v), dt)
    ok &= ok_route and same
    worst, pad = (None, 0.0), L // 3 + 5
    for name, g, w in zip(("dq", "dk", "dv", "drab"), got,
                          bwd_p(q, k, v, dout)):
        okg, eg, _ = compare_grad(g, w, dt)
        okg &= bool(torch.isfinite(g.float()).all())
        if name != "drab":
            okg &= bool((g[0, :pad] == 0).all()) and bool((g[-1] == 0).all())
        ok &= okg
        if eg >= worst[1]:
            worst = (name, eg)
    log(f"silu_qkv {kind} B={B} L={L} D={D} H={H} hd={D // H} "
        f"{str(dt)[6:]} (counters {ok_route}, two calls bitwise equal "
        f"{same}): forward max_abs_err={e_f:.6g} ({lim_f}); backward "
        f"largest error {worst[1]:.6g} ({worst[0]}); "
        f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    del q, k, v, dout, out, got
    _free()
    return ok


def silu_block_launches():
    """The fused_silu hook as a path: one HSTU block (models/hstu.
    hstu_block, bf16) whose core is the standalone attention with
    silu_qkv, forward and backward, at hstu_mini's shape (B=64, L=256,
    D=64, H=4; output and gradients held to the same block on the core's
    plain versions: cosine >= 0.999) and at mini_long's (B=32, L=4096: its
    chunked kernels), the launch counters set to 0 before and read after.
    Returns (ok, the silu counters' launches)."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.models import hstu as TH
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    bf16 = torch.bfloat16
    ok = True
    saved = read_launches()
    reset_launches()
    for B, L in ((64, 256), (32, 4096)):
        D, H = 64, 4
        gen = torch.Generator().manual_seed(B + L)
        params = TH.init_hstu_params(gen, D, H)
        params = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in params.items()}
        rng = np.random.default_rng(L)
        x = torch.from_numpy(rng.standard_normal((B, L, D)).astype(
            np.float32)).to(bf16).cuda()
        cot = torch.from_numpy(rng.standard_normal((B, L, D)).astype(
            np.float32)).to(bf16).cuda()
        valid = torch.ones((B, L), dtype=torch.bool, device="cuda")
        valid[0, :L // 3] = False

        def core(q, k, v, rab):
            return HA.hstu_attention_packed(q, k, v, valid, rab, L, H,
                                            silu_qkv=True)

        def plain(q, k, v, rab):
            return HA.hstu_attention_fwd_plain(q, k, v, valid, rab.float(),
                                               L, H, True)

        core.fused_silu = plain.fused_silu = True
        runs = (core,) if L > 1024 else (core, plain)
        res = []
        for c in runs:
            leaves = [params["uvqk"]["w"], params["rab"]]
            for t in leaves:
                t.requires_grad_(True)
                t.grad = None
            xr = x.clone().requires_grad_(True)
            out = TH.hstu_block(params, xr, None, H, core=c)
            out.backward(cot)
            res.append([out.detach().float(), xr.grad.float()]
                       + [t.grad.float() for t in leaves])
            torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t).all()) for t in res[0])
        cos = [float(torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0)) for a, b in zip(*res)] \
            if len(res) == 2 else []
        ok_b = finite and all(c_ >= 0.999 for c_ in cos)
        ok &= ok_b
        log(f"fused_silu block B={B} L={L} D={D} H={H} bf16: finite {finite}"
            + (f", cosines to the plain core (out, dx, dWuvqk, drab) "
               + ", ".join(f"{c_:.6f}" for c_ in cos) + " (limit 0.999)"
               if cos else "") + f" {'ok' if ok_b else 'FAIL'}")
        del params, x, cot, res
        _free()
    got = read_launches()
    set_launches(saved)
    want = dict(dict.fromkeys(got, 0), hstu_silu_fwd=1, hstu_silu_bwd=1,
                hstu_chunk_silu_fwd=1, hstu_chunk_silu_bwd=1)
    ok_l = got == want
    nonzero = {k: v for k, v in got.items() if v}
    log(f"fused_silu block launches {json.dumps(nonzero)} (want one each "
        f"way on each route, every other counter 0) "
        f"{'ok' if ok_l else 'FAIL'}")
    return ok and ok_l, got


def phase_silu():
    """silu_qkv: every instance against its plain version (SILU_CASES, f32
    and bf16), the fused_silu block as a path (silu_block_launches), then
    at hstu_mini's and mini_long's shapes in bf16 the fused SiLU's forward
    and backward beside silu_qkv=False with a separate SiLU pass over [B,
    L, 3D] (Fn.silu forward; its backward, silu_backward, after the
    attention's backward): CUDA events and the kernels' device ms by the
    profiler, the bounds, the plain versions. Returns (ok, JSON entries of
    the silu instances: no main path launches them, their
    ``check_launches`` the block run's)."""
    import torch
    import torch.nn.functional as Fn

    t0 = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    ok = True
    for i, case in enumerate(SILU_CASES):
        for dt in (f32, bf16):
            ok &= check_silu(*case, dt, 80 + i)
    ok_b, launches = silu_block_launches()
    ok &= ok_b
    entries = []
    for kind, run, B, L, D, H in SILU_SHAPES:
        _free()
        q, k, v, dout, valid, rab = attention_inputs(B, L, D, H, bf16, 90)
        fwd, bwd, fwd_p, bwd_p = _silu_fns(kind, valid, rab, L, H)
        f0, b0 = _attn_fns(kind, valid, rab, L, H)[:2]
        uvqk = torch.cat([q, k, v], dim=-1)   # the [B, L, 3D] SiLU pass
        g3 = torch.cat([dout] * 3, dim=-1)
        out = fwd(q, k, v)
        ok_f, err_f, _ = compare_attn(out, fwd_p(q, k, v), bf16)
        err_b = 0.0
        for g, w in zip(bwd(q, k, v, dout), bwd_p(q, k, v, dout)):
            okg, eg, _ = compare_grad(g, w, bf16)
            ok_f &= okg
            err_b = max(err_b, eg)
        ok &= ok_f
        del out
        _free()
        long_ = L > 1024
        w, n = (2, 5) if long_ else (3, 20)
        names = KERNEL_NAMES[kind]
        calls = {
            "fwd": (lambda: fwd(q, k, v),
                    lambda: (Fn.silu(uvqk), f0(q, k, v))),
            "bwd": (lambda: bwd(q, k, v, dout),
                    lambda: (b0(q, k, v, dout, None),
                             torch.ops.aten.silu_backward(g3, uvqk)))}
        plain = {"fwd": time_ms(lambda: fwd_p(q, k, v), 1, 1 if long_ else 3)}
        _free()
        plain["bwd"] = time_ms(lambda: bwd_p(q, k, v, dout), 1,
                               1 if long_ else 3)
        _free()
        name = _ATTN_NAMES[kind]
        src, tpu, fwd_row, bwd_row = _ATTN_REPLACES[kind]
        for key, err, row in (("fwd", err_f, fwd_row),
                              ("bwd", err_b, bwd_row)):
            fused, apart = calls[key]
            way = 0 if key == "fwd" else 1
            t_fused = time_ms(fused, w, n)
            t_apart = time_ms(apart, w, n)
            d_fused = kernel_device_ms(fused, names[way])
            d_apart = kernel_device_ms(apart, names[way] + ("silu",))
            bound, by, flops, nbytes = attention_bound(kind, B, L, D, H, 2,
                                                       key == "bwd")
            log(f"{name}_silu_{key} ({run}: B={B} L={L} D={D} H={H}): "
                f"silu_qkv {t_fused:.4f} ms (device {d_fused:.4f}); "
                f"silu_qkv=False with a separate SiLU pass over [B, L, 3D] "
                f"{t_apart:.4f} ms (device {d_apart:.4f}); plain "
                f"{plain[key]:.4f} ms; bound {bound:.4f} ms ({by}: "
                f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB); max abs "
                f"err {err:.4g} {'ok' if ok_f else 'FAIL'}")
            entries.append({
                "name": f"{name}_silu_{key}_L{L}_H{H}", "route": "cuda",
                "source": SRC + ("hstu_attention.cu" if key == "fwd"
                                 else "hstu_attn_bwd_sm90.cuh"),
                "replaces": tpu + row,
                # no main path sets fused_silu: the block run's count is
                # this phase's own check, apart from the path's launches
                "launches": 0,
                "check_launches": launches[f"{kind}_silu_{key}"],
                "max_abs_err": err, "ms": t_fused, "plain_ms": plain[key],
                "bound_ms": bound, "bound_by": by, "library_ms": None})
        del q, k, v, dout, valid, rab, uvqk, g3
        _free()
    log(f"silu_qkv phase: {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    return ok, entries


# ---------------------------------------------------------------------------
# phase 3b': the shared kernels' numbers, bitwise
# ---------------------------------------------------------------------------

#: bitwise_digests() of the tree before the standalone HSTU attention moved
#: onto the shared wgmma loops (commit 9255dd3), as scripts/fused_bwd_ab.py
#: printed them for that tree on an NVIDIA H100 80GB HBM3 with nvcc
#: DIGESTS_NVCC: the fused block's and the ring's kernels must still give
#: these bits. Another nvcc may contract products differently, so under
#: another release the digests are printed and not compared.
DIGESTS_NVCC = "12.9"
DIGESTS_BEFORE = {
    "flagship_fwd": "fece16080d03e90b",
    "flagship_train": "99037bbacd114b41",
    "flagship_bwd": "797bad9d78c1a93f",
    "long_fwd": "dd1f77a5e15beb07",
    "long_train": "a1b085e3c2e99513",
    "long_bwd": "b823b345762ef7e3",
    "sparse_fwd": "b010e15b193a084a",
    "sparse_train": "1c5d0d618cb3bc5f",
    "sparse_bwd": "24df652634ce0360",
    "ring_fwd_0": "d9759a6dc2b14523",
    "ring_dq_0": "cc1da4b156f9e496",
    "ring_dkdv_0": "748d388cf9d9ab09",
    "ring_fwd_2048": "96af60d42d3c3435",
    "ring_dq_2048": "ba9d56a9234f0c59",
    "ring_dkdv_2048": "6d4a1caa05baf27f",
    "ring_h4_fwd_0": "05d1e2ad221aa14b",
    "ring_h4_dq_0": "48332edfa1f2c622",
    "ring_h4_dkdv_0": "55a8a758dc6d1cac",
    "ring_h4_fwd_1024": "a9299f67db46427e",
    "ring_h4_dq_1024": "568a93c2597065c9",
    "ring_h4_dkdv_1024": "b34e1f0057ef489c"}


def bitwise_digests():
    """sha256 prefixes of the fused block's and the ring's outputs in bf16
    on seeded inputs, which two trees that compute the same numbers share
    bitwise: the fused forward (inference; training: out and av) and
    backward (every gradient) at the flagship, long and sparse shapes
    (dropout 0.01), and the ring's pair forward, dq (with drab) and dk/dv
    at offsets 0 and +Lc at the S = 2 shard of the long step (B=32, Lc =
    2048, H=1) and at 4 heads of 16 (B=8, Lc = 1024)."""
    import hashlib

    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    bf16 = torch.bfloat16

    def digest(*ts):
        h = hashlib.sha256()
        for x in ts:   # bf16 widens to f32 exactly
            h.update(x.float().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {}
    for name, shp in (("flagship", FLAGSHIP), ("long", LONG),
                      ("sparse", dict(FLAGSHIP, B=64, H=4))):
        H = shp["H"]
        x, ops, tt = block_inputs(**shp, dtype=bf16, seed=12)
        y, av = FB.fused_hstu_block_train(x, ops, tt, H, 5, FLAGSHIP_DROPOUT)
        dout = torch.from_numpy(np.random.default_rng(3).standard_normal(
            tuple(x.shape)).astype(np.float32)).to(bf16).cuda()
        g = FB.fused_hstu_block_bwd(x, av, dout, ops, tt, H, 5,
                                    FLAGSHIP_DROPOUT)
        out[f"{name}_fwd"] = digest(FB.fused_hstu_block(x, ops, tt, H))
        out[f"{name}_train"] = digest(y, av)
        out[f"{name}_bwd"] = digest(*(g[n] for n in sorted(g)))
        del x, ops, tt, y, av, dout, g
        _free()
    for tag, (B, Lc, H) in (("ring", (32, 2048, 1)),
                            ("ring_h4", (8, 1024, 4))):
        q, k, v, dav, valid, rab = _pair_inputs(B, Lc, 64, H, bf16, 61)
        for off in (0, Lc):
            out[f"{tag}_fwd_{off}"] = digest(
                FB.ring_pair_fwd(q, k, v, valid, rab, off, H))
            out[f"{tag}_dq_{off}"] = digest(
                *FB.ring_pair_dq(q, k, v, dav, valid, rab, off, H))
            out[f"{tag}_dkdv_{off}"] = digest(
                *FB.ring_pair_dkdv(q, k, v, dav, valid, rab, off, H))
        del q, k, v, dav, valid, rab
        _free()
    return out


def nvcc_release():
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    text = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60).stdout
    m = re.search(r"release (\d+\.\d+)", text)
    return m.group(1) if m else "unknown"


def phase_digests():
    """Prints bitwise_digests() and holds them to DIGESTS_BEFORE under the
    nvcc release they were recorded with: a differing digest there means
    this tree changed the fused block's or the ring's numbers."""
    t0 = time.perf_counter()
    got = bitwise_digests()
    release = nvcc_release()
    compared = bool(DIGESTS_BEFORE) and release == DIGESTS_NVCC
    differ = sorted(k for k in got
                    if compared and got[k] != DIGESTS_BEFORE.get(k))
    log(f"digests of the fused block and the ring (bf16, nvcc {release}): "
        + json.dumps(got))
    if not compared:
        verdict = f"not compared (recorded with nvcc {DIGESTS_NVCC})"
    elif differ:
        verdict = "differ at " + ", ".join(differ)
    else:
        verdict = "equal"
    log(f"digests against the recorded ones of 9255dd3: {verdict}; "
        f"{time.perf_counter() - t0:.1f} s {'FAIL' if differ else 'ok'}")
    return not differ


# ---------------------------------------------------------------------------
# phase 3c: the group kernels of a sparse-trained table
# ---------------------------------------------------------------------------

#: the check's table: 16M rows of 64 as 1M write groups of 1024 elements;
#: 196,608 slots (the 100M-row step's K) of which 190,000 real groups
GROUPS = dict(nG=1 << 20, W=1024, K=196_608, n_real=190_000)
GATHER_KERNEL = "group_gather_kernel"
_GROUP_REPLACES = "tencent_recommendation_2025_tpu/ops/sparse_table.py:"


def phase_group_kernels(libs):
    """The group scatter and group gather against their plain versions on
    the card, in f32 and bf16: the scatter in place (same buffer), equal to
    its plain version bitwise, untouched groups bitwise unchanged; the
    gather's real rows equal to the plain gather's, with the slots sorted
    (a sentinel tail) and again shuffled (sentinels between real slots).
    Then each timed (CUDA events) beside its plain version, its one-call
    yardstick on the [nG, W] view (``index_copy_`` / ``index_select`` of the
    real groups) and its bytes bound: the real groups' rows read once and
    written once, and the slots' ids; the gather and ``index_select`` also
    by their kernels' device time (the profiler), and the gather beside its
    first design (group_gather_kernel: the copy of sparse_table.cu in
    ``libs``), by both clocks. Returns (ok, the kernels' JSON entries
    without launches, from the bf16 run: the 100M-row step's dtype)."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST

    nG, W, K, n_real = (GROUPS[k] for k in ("nG", "W", "K", "n_real"))
    groups = np.full((K,), nG, np.int32)
    groups[:n_real] = np.sort(np.random.default_rng(60).choice(
        nG, size=n_real, replace=False))
    g = torch.from_numpy(groups).cuda()
    real = g[:n_real].long()
    # the same slots shuffled: sentinels between the real ones
    g_mix = g[torch.from_numpy(np.random.default_rng(62).permutation(K))
              .cuda()]
    mix_real = g_mix < nG
    untouched = torch.ones(nG, dtype=torch.bool, device="cuda")
    untouched[real] = False
    ok_all, entries = True, []
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(61)
        table = torch.randn((nG, W), generator=gen, device="cuda").to(dt)
        arranged = torch.randn((K, W), generator=gen, device="cuda").to(dt)
        before = table.clone()
        ptr = table.data_ptr()
        out = ST.group_scatter(table, g, arranged)
        torch.cuda.synchronize()
        ref = ST.group_scatter_plain(before.clone(), g, arranged)
        err_s = (table.float() - ref.float()).abs().max().item()
        ok_s = out.data_ptr() == ptr and torch.equal(table, ref) and \
            torch.equal(table[untouched], before[untouched])
        del ref, before
        got = ST.group_gather(table, g)
        torch.cuda.synchronize()
        want = ST.group_gather_plain(table, g)
        err_g = (got[:n_real].float() - want[:n_real].float()).abs().max() \
            .item()
        ok_g = torch.equal(got[:n_real], want[:n_real])
        got = ST.group_gather(table, g_mix)
        torch.cuda.synchronize()
        want = ST.group_gather_plain(table, g_mix)
        ok_g &= torch.equal(got[mix_real], want[mix_real])
        del got, want
        _free()
        src = arranged[:n_real]

        def scatter():
            return ST.group_scatter(table, g, arranged)

        def gather():
            return ST.group_gather(table, g)

        # CUDA events; the gather after the library calls: timed right
        # after the scatter it read up to 17% high on some machines while
        # its device time did not move
        t = {"scatter": time_ms(scatter, 3, 20)}
        lib = {"scatter": time_ms(lambda: table.index_copy_(0, real, src),
                                  3, 20),
               "gather": time_ms(lambda: table.index_select(0, real), 3, 20)}
        t["gather"] = time_ms(gather, 3, 20)
        plain = {"scatter": time_ms(lambda: ST.group_scatter_plain(
                     table, g, arranged), 1, 5),
                 "gather": time_ms(lambda: ST.group_gather_plain(table, g),
                                   1, 5)}
        # device ms: the gather kernel's, index_select's (its one kernel),
        # then the first design's by both clocks
        dev = (kernel_device_ms(gather, (GATHER_KERNEL,)),
               kernel_device_ms(lambda: table.index_select(0, real), ("",)))
        with first_design(libs):
            old = (time_ms(gather, 3, 20),
                   kernel_device_ms(gather, (GATHER_KERNEL,)))
        nbytes = 2 * n_real * W * table.element_size() + K * 4
        bound = nbytes / PEAK_BYTES * 1e3
        ok = ok_s and ok_g
        ok_all &= ok
        for key, err, row in (("scatter", err_s, "424"),
                              ("gather", err_g, "498")):
            more = ("; in place, untouched groups unchanged" if key ==
                    "scatter" else
                    f"; device {GATHER_KERNEL} {dev[0]:.4f} ms, index_select "
                    f"{dev[1]:.4f} ms; first design (streaming hints) "
                    f"{old[0]:.4f} ms (device {old[1]:.4f} ms); shuffled "
                    f"slots held too")
            log(f"group_{key} {str(dt)[6:]} ({nG} groups of {W}, {K} slots, "
                f"{n_real} real): kernel {t[key]:.4f} ms "
                f"({nbytes / t[key] / 1e6:.1f} GB/s), plain "
                f"{plain[key]:.4f} ms, "
                f"{'index_copy_' if key == 'scatter' else 'index_select'} "
                f"{lib[key]:.4f} ms, bound {bound:.4f} ms (bytes: "
                f"{nbytes / 1e6:.1f} MB); max abs err {err:.3g}" + more
                + f" {'ok' if ok else 'FAIL'}")
            if dt == torch.bfloat16:
                entries.append({
                    "name": f"group_{key}", "route": "cuda",
                    "source": SRC + "sparse_table.cu",
                    "replaces": _GROUP_REPLACES + row, "launches": None,
                    "max_abs_err": err, "ms": t[key],
                    "plain_ms": plain[key], "bound_ms": bound,
                    "bound_by": "bytes", "library_ms": lib[key]})
        del table, arranged, src
        _free()
    return ok_all, entries


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def check_launches(run, what, got, want):
    """Log and hold every launch counter of one phase to its expected
    count; the path's own kernels must have launched."""
    mine = [k for k, v in want.items() if v]
    ok = got == want and all(got[k] > 0 for k in mine)
    log(f"{run.name}: {what} launches "
        + ", ".join(f"{k} {got[k]} (expected {want[k]})" for k in got)
        + f" {'ok' if ok else 'FAIL'}")
    return ok


class _Tee(io.TextIOBase):
    """Standard output that is also kept, to read what a phase printed."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def phase_training(run):
    """cli.train on the card, one epoch of ``run``; every launch counter
    held to its expected count (a step of G microbatches launches the
    training kernels G times). A preset whose mesh wants several devices
    must print the JAX CLI's warning and train single-device. The loader's
    timings go to TIMINGS."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.cli import train as TRN
    from tencent_recommendation_2025_tpu_torch.data import synthetic
    from tencent_recommendation_2025_tpu_torch.data.pipeline import \
        train_val_split
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    if run.work.exists():
        shutil.rmtree(run.work)
    data_dir, model_dir, log_dir = run.data_dir, run.work / "model", \
        run.work / "logs"
    if not data_dir.exists():
        t0 = time.perf_counter()
        synthetic.generate(data_dir, mm_emb_ids=("81",), **run.fixture)
        log(f"{run.name}: fixture {run.fixture} generated in "
            f"{time.perf_counter() - t0:.1f} s")

    os.environ["TRAIN_DATA_PATH"] = str(data_dir)
    os.environ["TRAIN_CKPT_PATH"] = str(model_dir)
    os.environ["TRAIN_LOG_PATH"] = str(log_dir)
    timings = {}
    tee = _Tee(sys.stdout)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        state = TRN.main(run.args() + list(run.train_args)
                         + ["--num_epochs", "1"], timings=timings,
                         packs=PACKS)
    wall = time.perf_counter() - t0
    launches = read_launches()
    TIMINGS[run.name] = timings

    cfg = run.config()
    mc = cfg.mesh
    want_dev = mc.data * mc.model * mc.seq * mc.pipe
    warned = True
    if want_dev > 1:
        line = TRN.single_device_warning(want_dev,
                                         torch.cuda.device_count())
        warned = line in tee.kept.getvalue()
        log(f"{run.name}: printed '{line}': {warned} "
            f"{'ok' if warned else 'FAIL'}")
    data = TencentGRData(data_dir, mm_emb_ids=("81",))
    _, va = train_val_split(len(data.seq), cfg.train.valid_fraction,
                            cfg.train.seed)
    steps = state.step
    # validation batches, and a probe batch every grad_log_every steps; the
    # retrieval eval predicts every validation batch again (fewer users
    # than it asks for)
    n_val = -(-len(va) // run.batch_size)
    n_eval = n_val + steps // cfg.train.grad_log_every
    users = cfg.train.eval_retrieval_users
    if users:
        assert len(va) <= users
        n_eval += n_val
    # each of a step's G microbatches runs the training kernels once; the
    # retrieval eval of the one epoch scans once (topk_mips_approx)
    ok = steps > 0 and check_launches(
        run, "training", launches,
        expected_launches(run.kernels, cfg.model.num_blocks,
                          steps * cfg.train.grad_accum_steps, n_eval,
                          scans=int(users > 0)))
    records = [json.loads(ln) for ln in open(log_dir / "train.log")]
    lines = [ln for ln in records if "loss" in ln]
    losses = [ln["loss"] for ln in lines]
    finite = len(losses) == steps and bool(np.isfinite(losses).all())
    if users:
        evs = [ln for ln in records if ln.get("event") == "retrieval_eval"]
        ok_ev = len(evs) == 1 and evs[0]["n"] > 0 and \
            0.0 <= evs[0]["ndcg"] <= evs[0]["hr"] <= 1.0
        log(f"{run.name}: epoch-end retrieval eval (--eval_retrieval_users "
            f"{users}): {evs} {'ok' if ok_ev else 'FAIL'}")
        ok &= ok_ev
    ckpt = CK.latest_checkpoint(model_dir)
    ok_ck = ckpt is not None and ckpt.name.startswith(f"global_step{steps}.")
    log(f"{run.name}: train losses ({steps} steps): "
        f"{', '.join(f'{v:.4f}' for v in losses)}"
        f"; finite {finite}; checkpoint {ckpt.name if ckpt else None} "
        f"{'ok' if finite and ok_ck else 'FAIL'}")
    L = cfg.model.maxlen + 1
    log(f"{run.name}: cli.train wall {wall:.1f} s for {steps} steps of "
        f"{run.batch_size} at L={L} (data loading, validation and checkpoint "
        f"included); loader {timings.get('loader')}, cache build "
        f"{timings.get('cache_build_s', float('nan')):.2f} s"
        + (" (the previous run's pack, reused)"
           if timings.get("cache_reused") else "") + "; last logged "
        f"steps/s {lines[-1]['steps_per_second']:.3f}, "
        f"{lines[-1]['steps_per_second'] * run.batch_size:.1f} examples/s")
    return ok and finite and ok_ck and warned, launches, ckpt, data


def _host_prep(cfg, batch, tables, data, i):
    """The train loop's host prep of batch ``i`` of epoch 1: tower dedup,
    then the sparse-table prep (keyed as train_loop keys them)."""
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    key = (cfg.train.seed, 97, 1, i)
    if cfg.train.tower_dedup:
        batch = TR.augment_batch_dedup(batch, cfg, tables, data.itemnum,
                                       step_key=key)
    if cfg.train.sparse_tables:
        batch = TR.augment_batch_sparse(batch, cfg, data.itemnum, key,
                                        usernum=data.usernum)
    return batch


def _train_batches(data, n, run, rows=None):
    """The first ``n`` train batches of epoch 1 of ``run`` (streamed; cut to
    ``rows`` rows if given) and its config."""
    from tencent_recommendation_2025_tpu_torch.data.dataset import \
        TrainSampler
    from tencent_recommendation_2025_tpu_torch.data.pipeline import (
        TrainLoader, train_val_split)
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema

    cfg = run.config()
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    tr, _ = train_val_split(len(sampler), cfg.train.valid_fraction,
                            cfg.train.seed)
    loader = TrainLoader(sampler, tr, cfg.train.batch_size,
                         seed=cfg.train.seed)
    out = []
    for b in loader.epoch(1):
        if rows is not None:
            b = {k: v[:rows] for k, v in b.items()}
        out.append(b)
        if len(out) == n:
            break
    return cfg, schema, out


def _loss_and_grads(model, cfg, params, batch, tables, device, route=None,
                    mesh=None, metrics=None):
    """Loss and per-leaf gradients of one training forward (dropout off),
    on ``mesh`` where one is given (its row-sharded tables' gradients at
    the tables' rows: the shard-pad rows take none); ``metrics``, a dict,
    receives the forward's (``ep_overflow`` where the all-to-all ran)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.models import encoder as ENC
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    state = TR.init_state(model, cfg, params=params, device=device)
    if mesh is not None:
        state = PT.shard_existing_state(mesh, state)
    tabs = TR.device_tables(tables, device)
    saved = ENC.block_route
    if route is not None:
        ENC.block_route = lambda *a: route
    try:
        loss, got = TR.compute_loss(model, state.params,
                                    TR.put_batch(batch, device), tabs["mm"],
                                    tabs, cfg, train=True, mesh=mesh)
        loss.backward()
    finally:
        ENC.block_route = saved
    if metrics is not None:
        metrics.update({k: float(v) for k, v in got.items()})
    rows = CK.table_rows(model, packed=False) if mesh is not None else {}
    return loss.item(), {p: t.grad.float().cpu()[:rows.get(p)]
                         for p, t in TR.param_leaves(state.params)}


def _sparse_step(model, cfg, state, batch, tables, device, route=None):
    """Loss, dense gradients and the touched rows' update of one
    sparse-table train step (the port's make_train_step) from ``state``;
    the update is keyed "item_emb (touched rows' update)"."""
    import torch

    from tencent_recommendation_2025_tpu_torch.models import encoder as ENC
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    uids = torch.from_numpy(batch["touched_uids"]).long()
    real = uids[uids < state.params["item_emb"].shape[0]].to(device)
    before = state.params["item_emb"][real].float().cpu()
    tabs = TR.device_tables(tables, device)
    saved = ENC.block_route
    if route is not None:
        ENC.block_route = lambda *a: route
    try:
        state, m = TR.make_train_step(model, cfg)(
            state, TR.put_batch(batch, device), tabs["mm"], tabs)
    finally:
        ENC.block_route = saved
    out = {p: t.grad.float().cpu() for p, t in TR.dense_leaves(state.params,
                                                                cfg)}
    out["item_emb (touched rows' update)"] = \
        state.params["item_emb"][real].float().cpu() - before
    return float(m["loss"]), out


def phase_one_step(run, data, ckpt):
    """One step at full width and depth on the first 16 rows of the first
    train batch of ``run``, dropout 0, from its checkpoint: the card
    (kernels, bf16) against the plain versions on the CPU in bf16 and in
    f32, on the loss and each gradient; with sparse tables a whole train
    step from the checkpoint's state (the table's row-optimizer state too),
    on the loss, the dense gradients and the touched rows' update."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    cfg, schema, (batch,) = _train_batches(data, 1, run, rows=run.check_rows)
    saved_model = SeqRecModel(cfg=cfg.model, schema=schema,
                              fused=FusedVocab.build(schema),
                              usernum=data.usernum, itemnum=data.itemnum)
    saved_cfg = cfg
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_rate=0.0))
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    batch = _host_prep(cfg, batch, tables, data, 0)
    params, _ = CK.load_params(ckpt)

    def model_in(dtype):
        mc = dataclasses.replace(cfg.model, dtype=dtype)
        return (SeqRecModel(cfg=mc, schema=schema,
                            fused=FusedVocab.build(schema),
                            usernum=data.usernum, itemnum=data.itemnum),
                cfg.replace(model=mc))

    def one(dtype, device, route=None):
        model, c = model_in(dtype)
        if not cfg.train.sparse_tables:
            return _loss_and_grads(model, c, params, batch, tables, device,
                                   route)
        state, _ = CK.load_checkpoint(ckpt, saved_model, saved_cfg,
                                      device=device)
        return _sparse_step(model, c, state, batch, tables, device, route)

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    card_loss, card = one("bfloat16", "cuda")
    torch.cuda.synchronize()
    l16, g16 = one("bfloat16", "cpu", run.cpu_route)
    l32, g32 = one("float32", "cpu", run.cpu_route)

    def cos(a, b):
        na, nb = a.norm().item(), b.norm().item()
        if na == 0.0 and nb == 0.0:
            return 1.0
        return float(torch.dot(a.flatten(), b.flatten()) / (na * nb))

    ok_loss = abs(card_loss - l16) <= 1e-3 * abs(l16)
    worst16, worst32, fails = (None, 2.0), (None, 2.0, 0.0), []
    for name in card:
        c16_ = cos(card[name], g16[name])
        c32_ = cos(card[name], g32[name])
        floor = float(drift_limit(cos(g16[name], g32[name])))
        if c16_ < worst16[1]:
            worst16 = (name, c16_)
        if c32_ < worst32[1]:
            worst32 = (name, c32_, floor)
        if c16_ < 0.999 or c32_ < floor:
            fails.append(f"{name} ({c16_:.6f}, {c32_:.6f} vs {floor:.6f})")
    ok = ok_loss and not fails and np.isfinite(card_loss)
    log(f"{run.name}: one step, {run.check_rows} rows at full width and depth "
        f"({len(card)} gradients or updates, CPU plain versions in "
        f"{time.perf_counter() - t0:.1f} s): loss card {card_loss:.6f}, CPU "
        f"bf16 {l16:.6f}, CPU f32 {l32:.6f} (limit 1e-3 relative to bf16); "
        f"lowest gradient cosine to CPU bf16 {worst16[1]:.6f} ({worst16[0]}, "
        f"limit 0.999), to CPU f32 {worst32[1]:.6f} ({worst32[0]}, limit "
        f"{worst32[2]:.6f}: {DRIFT_RULE}); failing: {fails or 'none'} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def _kernel_split(by_name, names):
    """(device ms of the kernels named, text of each one's ms)."""
    def share(ns):
        return sum(v for k, v in by_name.items() if any(n in k for n in ns))

    return share(names), ", ".join(f"{n} {share((n,)):.3f}" for n in names)


def _device_ms(prof):
    """Device ms by kernel name in a torch.profiler trace."""
    from torch.autograd import DeviceType

    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.device_time_total / 1e3
    return by_name


def _kernel_launches(prof):
    """Launches by kernel name in a torch.profiler trace."""
    from torch.autograd import DeviceType

    return collections.Counter(e.name for e in prof.events()
                               if e.device_type == DeviceType.CUDA)


def route_names(route, train=True):
    """(the kernels a profiled bf16 step (train) or predict batch must run
    with device time, the kernels it may not run) of a route check:
    ``attn_bwd`` (attn_bwd_route), ``fused`` (wgmma_route), ``hstu``
    (hstu_route)."""
    if route == "attn_bwd":
        return ATTN_BWD_WGMMA, ATTN_BWD_NAMES[2:] + ATTN_BWD_DELETED
    if route == "fused":
        want = PRE_WGMMA[:1] + POST_WGMMA[:1]
        if train:
            want += PRE_WGMMA[1:] + POST_WGMMA[1:]
        return want, PRE_REPLACED + POST_REPLACED
    return (HSTU_WGMMA if train else HSTU_WGMMA[:1]), HSTU_FIRST


#: traces a route check takes of one call before it judges the last one
ROUTE_TRACES = 4


def route_trace(name, fn, routes, train=True, launches_ok=None):
    """One call of ``fn`` (a step or a predict batch) under torch.profiler
    for the route checks ``routes`` (names of :func:`route_names`):
    (the profile, the call's wall ms). The card's profiler loses kernel
    events late in a long process, at times a whole trace, and such a trace
    reads as a call that never ran its kernels. So while a trace holds no
    device time for a kernel the routes want (or ``launches_ok`` of its
    launches by kernel name is false), and none for a kernel they forbid,
    the call is traced again, ROUTE_TRACES traces in all; each retake is
    logged, and the checks judge the last trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    want = [n for r in routes for n in route_names(r, train)[0]]
    forbid = [n for r in routes for n in route_names(r, train)[1]]
    for i in range(ROUTE_TRACES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        by_name = _device_ms(prof)

        def ran(n):
            return any(n in k and v > 0 for k, v in by_name.items())

        missing = [n for n in want if not ran(n)]
        if launches_ok is not None and not launches_ok(
                _kernel_launches(prof)):
            missing.append("the launches it counts")
        if not missing or any(ran(n) for n in forbid) \
                or i == ROUTE_TRACES - 1:
            return prof, wall
        log(f"{name}: trace {i + 1} of {ROUTE_TRACES} lacks "
            f"{', '.join(missing)} and holds no forbidden kernel; traced "
            f"again")


def host_top(name, prof, wall):
    """Logs where the host's time goes in a profiled step: the CPU self time
    of every op summed (the step's host total) and the 10 ops with the most,
    with their calls."""
    avgs = list(prof.key_averages())
    total = sum(a.self_cpu_time_total for a in avgs) / 1e3
    top = sorted(avgs, key=lambda a: a.self_cpu_time_total, reverse=True)
    log(f"{name}: host time of the profiled step: {total:.3f} ms of CPU self "
        f"time over {len(avgs)} ops (wall {wall:.3f} ms); top 10 by self time "
        f"(ms, calls): " + ", ".join(
            f"{a.key[:48]} {a.self_cpu_time_total / 1e3:.3f} ({a.count})"
            for a in top[:10]))


def attn_bwd_route(name, by_name):
    """Whether a profiled bf16 step's backward ran the attention backward's
    wgmma kernels (both, with device time) and none of the kernels they
    replaced nor the generic instance; logs the names found."""
    want, forbid = route_names("attn_bwd")
    found = {n: sum(v for k, v in by_name.items() if n in k)
             for n in want + forbid}
    ok = all(found[n] > 0 for n in want) and not any(
        found[n] for n in forbid)
    log(f"{name}: attention backward route in the profiled step (device "
        f"ms): " + ", ".join(f"{n} {v:.3f}" for n, v in found.items())
        + f" {'ok' if ok else 'FAIL'}")
    return ok


def hstu_route(name, by_name, train=True):
    """Whether a profiled bf16 step (train) or predict batch of an HSTU
    attention run (hstu_mini, mini_long) ran the standalone attention's
    wgmma kernels, each with device time: hstu_fwd_wgmma_kernel and,
    training, the backward pair with reduce_rows_split_kernel; and none of
    the first design's kernels. Logs the names found."""
    want, forbid = route_names("hstu", train)
    found = {n: sum(v for k, v in by_name.items() if n in k)
             for n in HSTU_WGMMA + forbid}
    ok = all(found[n] > 0 for n in want) and not any(
        found[n] for n in forbid)
    log(f"{name}: the HSTU attention's wgmma route in the profiled "
        f"{'step' if train else 'predict batch'} (device ms): "
        + ", ".join(f"{n} {v:.3f}" for n, v in found.items())
        + f" {'ok' if ok else 'FAIL'}")
    return ok


def phase_train_speed(data, ckpt, run):
    """Train examples/s and tokens/s of the step itself (host clock,
    synchronised, after warm-up, on batches already on the card), and where
    one step's time goes (torch.profiler). Returns whether a fused run's
    profiled step took the attention backward's, the post half's and the
    gate/FFN backward's wgmma kernels, and an HSTU attention run's the
    standalone attention's (hstu_route; True for the other runs)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    # two batches, streamed through the python sampler
    cfg, schema, raw = _train_batches(data, 2, run)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    batches = [TR.put_batch(_host_prep(cfg, b, tables, data, i), "cuda")
               for i, b in enumerate(raw)]
    params, _ = CK.load_params(ckpt)
    state = TR.init_state(model, cfg, params=params, device="cuda")
    tabs = TR.device_tables(tables, "cuda")
    step = TR.make_train_step(model, cfg)
    for b in batches[:2]:
        state, m = step(state, b, tabs["mm"], tabs)
    torch.cuda.synchronize()
    n = 6
    t0 = time.perf_counter()
    for i in range(n):
        state, m = step(state, batches[i % len(batches)], tabs["mm"], tabs)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    B, L = cfg.train.batch_size, cfg.model.maxlen + 1
    log(f"{run.name}: train step (B={B}, L={L}, bf16, dropout "
        f"{cfg.model.dropout_rate}, tower dedup {cfg.train.tower_dedup}): "
        f"{dt * 1e3:.3f} ms, {B / dt:.1f} examples/s, {B * L / dt:.0f} "
        f"tokens/s (host clock, synchronised, {n} steps after 2 warm-up)")

    def one_step():
        nonlocal state, m
        state, m = step(state, batches[0], tabs["mm"], tabs)

    routes = {"fused": ("attn_bwd", "fused"), "hstu": ("hstu",),
              "hstu_chunk": ("hstu",)}.get(run.kernels, ())
    prof, wall = route_trace(run.name, one_step, routes)
    by_name = _device_ms(prof)
    busy = sum(by_name.values())
    fwd_names, bwd_names = KERNEL_NAMES[run.kernels]
    fwd, fsplit = _kernel_split(by_name, fwd_names)
    bwd, split = _kernel_split(by_name, bwd_names)
    others = ", ".join(f"{k[:60]} {v:.3f}" for k, v in by_name.most_common()
                       if not any(n in k for n in fwd_names + bwd_names)
                       )[:900]
    host_top(run.name, prof, wall)
    log(f"{run.name}: train step profile: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms (idle {max(0.0, 1 - busy / wall):.1%}); "
        f"{run.kernels} forward kernels {fwd:.3f} ms ({fsplit}), backward "
        f"kernels {bwd:.3f} ms ({split}); other kernels (ms): {others}")
    if run.kernels in ("hstu", "hstu_chunk"):
        return hstu_route(run.name, by_name)
    if run.kernels != "fused":
        return True
    ok = attn_bwd_route(run.name, by_name)
    return wgmma_route(run.name, by_name) and ok


# ---------------------------------------------------------------------------
# phase 5: serving
# ---------------------------------------------------------------------------

def phase_serving(ckpt, run):
    """cli.infer on the card on the checkpoint ``run`` trained; every launch
    counter held to its expected count; the first queries held to the
    plain versions on the CPU."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.cli import infer as INF
    from tencent_recommendation_2025_tpu_torch.data import formats
    from tencent_recommendation_2025_tpu_torch.data.dataset import \
        TestSampler
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.pipeline import TestLoader
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    res_dir = run.work / "result"
    mcfg = run.config().model
    data = TencentGRData(run.data_dir, mm_emb_ids=("81",), split="test")
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    model = SeqRecModel(cfg=mcfg, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    log(f"{run.name}: {mcfg.block_type} D={mcfg.hidden_units} "
        f"blocks={mcfg.num_blocks} H={mcfg.num_heads} ffn={mcfg.ffn_type} "
        f"norm_first={mcfg.norm_first} L={mcfg.maxlen + 1} "
        f"dtype={mcfg.dtype}: serving the trained checkpoint {ckpt.name}")

    os.environ["EVAL_DATA_PATH"] = str(run.data_dir)
    os.environ["EVAL_RESULT_PATH"] = str(res_dir)
    os.environ["MODEL_OUTPUT_PATH"] = str(ckpt.parent)
    timings = {}
    reset_launches()
    metrics = INF.main(run.args(), timings=timings)
    launches = read_launches()
    nb = timings["n_query_batches"]
    # every test user is a query, in batches of 128; the exact top-k scans
    # them in retrieve_topk's query batches
    ok = nb == -(-run.fixture["num_users"] // 128) and check_launches(
        run, "serving", launches,
        expected_launches(run.kernels, mcfg.num_blocks, 0, nb,
                          scans=scan_calls(timings["n_queries"])))

    # first query batch again through the plain version of every kernel on
    # the path, on the CPU: in f32, and in bf16 (the card's rounding points)
    queries = formats.load_fbin(res_dir / "query.fbin")
    corpus = formats.load_fbin(res_dir / "embedding.fbin")
    finite = bool(np.isfinite(queries).all() and np.isfinite(corpus).all())
    shapes_ok = queries.shape == (run.fixture["num_users"],
                                  mcfg.hidden_units) \
        and corpus.shape == (run.fixture["num_items"], mcfg.hidden_units)
    torch.set_num_threads(os.cpu_count() or 1)
    batch, _, n_valid = next(iter(TestLoader(
        TestSampler(data, schema, mcfg.maxlen), 128, num_workers=8)))
    cpu_params, _ = CK.load_params(ckpt)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    n_valid = min(n_valid, run.n_check)
    tb = {k: torch.from_numpy(v[:run.n_check]) for k, v in batch.items()}
    mm = {k: torch.from_numpy(v) for k, v in tables.mm.items()}
    t0 = time.perf_counter()
    ref32 = plain_queries(model, cpu_params, tb, mm, "float32",
                          run.cpu_route)[:n_valid]
    ref16 = plain_queries(model, cpu_params, tb, mm, "bfloat16",
                          run.cpu_route)[:n_valid]
    got = queries[:n_valid]
    cos32, cos16 = cosine(got, ref32), cosine(got, ref16)
    # bf16 arithmetic alone (the plain version in bf16) drifts from f32 over
    # the blocks, for some queries past 0.999 cosine: there the card is held
    # to a limit that scales with that drift
    floor = cosine(ref16, ref32)
    limit32 = drift_limit(floor)
    cos_ok = bool((cos32 >= limit32).all() and cos16.min() >= 0.999)
    log(f"{run.name}: first {n_valid} queries (plain versions on the CPU in "
        f"{time.perf_counter() - t0:.1f} s): card bf16 vs CPU bf16 cosine min "
        f"{cos16.min():.6f} (limit 0.999); card bf16 vs CPU f32 cosine min "
        f"{cos32.min():.6f} median {np.median(cos32):.6f} (limit "
        f"{DRIFT_RULE}: below 0.999 for {int((limit32 < 0.999).sum())} "
        f"queries, c at its lowest {floor.min():.6f}); max abs diff to f32 "
        f"{np.abs(got - ref32).max():.4g} {'ok' if cos_ok else 'FAIL'}")
    log(f"{run.name}: outputs: queries {queries.shape}, corpus "
        f"{corpus.shape}, finite={finite} "
        f"{'ok' if finite and shapes_ok else 'FAIL'}")
    ok &= profile_predict(
        model, CK.load_params(ckpt, model, device="cuda")[0],
        {k: torch.from_numpy(v).cuda() for k, v in batch.items()},
        {k: v.cuda() for k, v in mm.items()}, run)
    serving = {
        "queries_per_s": timings["n_queries"] / timings["predict_s"],
        "corpus_items_per_s": timings["n_items"] / timings["encode_items_s"],
        "topk_ms": timings["topk_s"] * 1e3,
        "n_queries": timings["n_queries"], "n_items": timings["n_items"],
        "hr10": metrics["hr"], "ndcg10": metrics["ndcg"]}
    log(f"{run.name}: serving at L={mcfg.maxlen + 1} " + json.dumps(serving))
    SERVED[run.name] = metrics
    return ok and cos_ok and finite and shapes_ok, launches


def profile_predict(model, params, batch, mm, run):
    """Where one predict batch's time goes: device time by kernel name
    (torch.profiler) against the synchronised host clock. Returns whether a
    fused run's batch took the fused block's wgmma forward kernels, and an
    HSTU attention run's hstu_fwd_wgmma_kernel (True for the other
    runs)."""
    import torch

    model.predict(params, batch, mm)
    torch.cuda.synchronize()
    routes = {"fused": ("fused",), "hstu": ("hstu",),
              "hstu_chunk": ("hstu",)}.get(run.kernels, ())
    prof, wall_ms = route_trace(run.name,
                                lambda: model.predict(params, batch, mm),
                                routes, train=False)
    by_name = _device_ms(prof)
    busy = sum(by_name.values())
    names = KERNEL_NAMES[run.kernels][0]
    mine, _ = _kernel_split(by_name, names)
    others = ", ".join(f"{k[:60]} {v:.3f}" for k, v in by_name.most_common()
                       if not any(n in k for n in names))[:600]
    log(f"{run.name}: predict profile (one batch of "
        f"{batch['seq'].shape[0]}): wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms (idle {max(0.0, 1 - busy / wall_ms):.1%}); "
        f"{run.kernels} kernels {mine:.3f} ms; other kernels (ms): {others}")
    if run.kernels in ("hstu", "hstu_chunk"):
        return hstu_route(run.name, by_name, train=False)
    return run.kernels != "fused" or wgmma_route(run.name, by_name,
                                                train=False)


def plain_queries(model, params, batch, mm, dtype, route):
    """Last-position queries of one CPU batch in ``dtype`` through the
    encoder's ``route``: the plain versions of the kernels the card takes
    there ("fused" or "core"; None: the dense route)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.models import embedding as E
    from tencent_recommendation_2025_tpu_torch.models import encoder as ENC

    cfg = dataclasses.replace(model.cfg, dtype=dtype)
    with torch.no_grad():
        fe = E.fuse_sequence(params, batch, mm, model.fused, model.schema,
                             cfg)
        out = ENC.encode(params, fe, batch["seq"], batch["token_type"],
                         params["pos_emb"], cfg, route=route)
    return out[:, -1].float().numpy()


def cosine(a, b):
    import numpy as np

    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


# ---------------------------------------------------------------------------
# phase 4b: the fused-feature lookup's one-hot backward
# ---------------------------------------------------------------------------

#: the runs whose step's fused-feature lookups phase_lookup_bwd replays
LOOKUP_RUNS = ("flagship", "mini_long")
#: ids a product of onehot_chunked_grad takes at once
ONEHOT_CHUNK = 1 << 15


def onehot_chunked_grad(ids, offsets, sizes, cot, n_rows):
    """The other repeatable design of the one-hot backward, timed beside
    the port's (``parallel.sharded_embedding.row_grad_sum``, a stable sort
    and a segmented sum): per (offset, vocab) group, as the JAX
    ``_fl_bwd`` takes it, f32 products one_hot(id - 1, vocab)^T @ cot over
    chunks of ONEHOT_CHUNK ids, summed in chunk order (cuBLAS, no atomic),
    written at rows offset + 1 .. offset + vocab."""
    import torch

    F = len(offsets)
    D = cot.shape[-1]
    flat = ids.reshape(-1, F).long()
    c = cot.reshape(-1, F, D).float()
    out = c.new_zeros((n_rows, D))
    groups = {}
    for f in range(F):
        groups.setdefault((int(offsets[f]), int(sizes[f])), []).append(f)
    for (off, vocab), fs in groups.items():
        idc = flat[:, fs].t().reshape(-1)
        cc = c[:, fs].transpose(0, 1).reshape(-1, D)
        cols = torch.arange(1, vocab + 1, device=ids.device)
        acc = c.new_zeros((vocab, D))
        for s in range(0, idc.shape[0], ONEHOT_CHUNK):
            oh = (idc[s:s + ONEHOT_CHUNK, None] == cols[None]).float()
            acc += oh.t() @ cc[s:s + ONEHOT_CHUNK]
        out[off + 1:off + 1 + vocab] = acc
    return out


def segment_sum_one_level(rows, cot, n_rows):
    """``row_grad_sum``'s first design, timed beside it: one
    ``segment_reduce`` over the sorted rows, each row's terms walked by
    one thread (thousands where a small vocabulary's rows hold every
    id)."""
    import torch

    flat = rows.reshape(-1).long()
    x = cot.reshape(flat.shape[0], cot.shape[-1]).float()
    key = torch.where((flat >= 0) & (flat < n_rows), flat,
                      torch.full_like(flat, n_rows))
    key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        key, torch.arange(n_rows + 1, device=key.device))
    return torch.segment_reduce(x[order], "sum", offsets=starts, axis=0,
                                unsafe=True)


def _lookup_inputs(ids, offsets, sizes):
    """(the rows the one-hot backward sums into, -1 for none; the rows
    index_add_ adds into, the clamped gather's; its keep mask) of one
    recorded lookup."""
    import torch

    off = torch.as_tensor(offsets, dtype=torch.long, device=ids.device)
    sz = torch.as_tensor(sizes, dtype=torch.long, device=ids.device)
    live = (ids > 0) & (ids <= sz)
    grad_rows = torch.where(live, ids.long() + off,
                            torch.full_like(ids, -1, dtype=torch.long))
    return grad_rows, live


def phase_lookup_bwd(run, data):
    """The fused-feature lookups of one train step of ``run`` (bf16, its
    first batch after the host prep, dropout 0), recorded from
    ``compute_loss``'s forward, replayed with seeded f32 cotangents: the
    table gradient of all of them through the port's lookup (the one-hot
    backward) twice, bitwise equal, on one device and on a local data mesh
    of 2 shards (a ShardedTable, each shard's rows in turn); against an
    index_add_ of the same rows in f64 (rtol 1e-5); then the step's
    lookup backward timed four ways on the same inputs, once each: the port's
    (row_grad_sum), the one-hot products in chunks (onehot_chunked_grad),
    the index_add_ the port took before (which sent an id above its
    vocabulary to the next feature's rows) and the segment sum in one
    level (segment_sum_one_level), by CUDA events and by the profiler's
    device ms summed over every kernel."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.models import embedding as TE
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.parallel import \
        sharded_embedding as SE
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    t0 = time.perf_counter()
    cfg, schema, (batch,) = _train_batches(data, 1, run)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_rate=0.0))
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    batch = _host_prep(cfg, batch, tables, data, 0)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema),
                        usernum=data.usernum, itemnum=data.itemnum)
    state = TR.init_state(model, cfg, device="cuda")
    tabs = TR.device_tables(tables, "cuda")
    calls, orig = [], TE.fused_feature_lookup

    def record(table, ids, offsets, dtype=None, sizes=None):
        calls.append((ids.detach(), np.asarray(offsets),
                      np.asarray(sizes)))
        return orig(table, ids, offsets, dtype=dtype, sizes=sizes)

    TE.fused_feature_lookup = record
    try:
        with torch.no_grad():
            TR.compute_loss(model, state.params, TR.put_batch(batch, "cuda"),
                            tabs["mm"], tabs, cfg, train=True)
    finally:
        TE.fused_feature_lookup = orig
    table = state.params["fused_feat"].detach()
    V, D = table.shape
    rng = np.random.default_rng(5)
    cots = [torch.from_numpy(rng.standard_normal(tuple(ids.shape) + (D,))
                             .astype(np.float32)).cuda()
            for ids, _, _ in calls]
    n_ids = sum(ids.numel() for ids, _, _ in calls)

    def through_lookup(t, shards=1):
        """The table gradient of every recorded lookup (the port's)."""
        leaf = SE.pad_rows(t, shards).clone().requires_grad_(True)
        src = leaf if shards == 1 else SE.ShardedTable.of_leaf(
            leaf, local_mesh(MeshConfig(data=shards)))
        loss = 0.0
        for (ids, offs, sizes), cot in zip(calls, cots):
            for rows in np.array_split(np.arange(ids.shape[0]), shards):
                if rows.size:
                    r = torch.from_numpy(rows).cuda()
                    out = TE.fused_feature_lookup(src, ids[r], offs,
                                                  sizes=sizes)
                    loss = loss + (out.float() * cot[r]).sum()
        loss.backward()
        return leaf.grad[:V]

    ok, text = True, []
    for shards in (1, 2):
        g1, g2 = through_lookup(table, shards), through_lookup(table, shards)
        torch.cuda.synchronize()
        same = torch.equal(g1, g2)
        ok &= same
        text.append(f"{'one device' if shards == 1 else 'data mesh of 2'}: "
                    f"two calls bitwise equal {same}")
    want = torch.zeros((V, D), dtype=torch.float64, device="cuda")
    for (ids, offs, sizes), cot in zip(calls, cots):
        rows, live = _lookup_inputs(ids, offs, sizes)
        want.index_add_(0, rows[live], cot[live].double())
    lim = 1e-5 * max(1.0, want.abs().max().item())
    inputs = []
    for (ids, offs, sizes), cot in zip(calls, cots):
        rows, live = _lookup_inputs(ids, offs, sizes)
        glob = torch.where(ids > 0, ids.long() + torch.as_tensor(
            offs, dtype=torch.long, device="cuda"), 0).clamp(max=V - 1)
        inputs.append((ids, offs, sizes, cot, rows, glob.reshape(-1),
                       (cot * (ids > 0)[..., None]).reshape(-1, D)))
    designs = {
        "sorted segment sum in two levels (the port's)": lambda: [
            SE.row_grad_sum(rows, cot, V)
            for _, _, _, cot, rows, _, _ in inputs],
        "one-hot products in chunks": lambda: [
            onehot_chunked_grad(ids, offs, sizes, cot, V)
            for ids, offs, sizes, cot, _, _, _ in inputs],
        "index_add_ (before)": lambda: [
            cot.new_zeros((V, D)).index_add_(0, glob, masked)
            for _, _, _, cot, _, glob, masked in inputs],
        "sorted segment sum in one level": lambda: [
            segment_sum_one_level(rows, cot, V)
            for _, _, _, cot, rows, _, _ in inputs]}
    # every design's sum over the lookups against the f64 sums of the
    # same rows (index_add_ also adds an id above its vocabulary: its
    # error is printed, not held)
    for name, fn in designs.items():
        total = g1.double() if "(the port's)" in name else \
            torch.stack(fn()).double().sum(0)
        err = (total - want).abs().max().item()
        held = not name.startswith("index_add_")
        ok &= err <= lim or not held
        text.append(f"{name} against an f64 index_add_ of the live rows: "
                    f"max abs err {err:.3g}"
                    + (f" (limit {lim:.3g})" if held else ""))
    times = {}
    for name, fn in designs.items():
        ms = time_ms(fn, 2, 5)
        dev = kernel_device_ms(fn, ("",), iters=3)
        times[name] = f"{ms:.4f} ms (device {dev:.4f})"
    _free()
    log(f"{run.name}: fused-feature lookup backward of one step "
        f"({len(calls)} lookups, {n_ids:,} ids, table {V} x {D}): "
        + "; ".join(text) + "; times: "
        + "; ".join(f"{k} {v}" for k, v in times.items())
        + f"; {time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    return ok


def phase_run(run, oks):
    """One end-to-end path: cli.train (with the one-step check where the run
    asks for it), the step's speed, then cli.infer. Returns the training
    and the serving launch counts."""
    t0 = time.perf_counter()
    oks[f"{run.name}_train"], trained, ckpt, data = phase_training(run)
    if run.one_step:
        oks[f"{run.name}_one_step"] = phase_one_step(run, data, ckpt)
    oks[f"{run.name}_route"] = phase_train_speed(data, ckpt, run)
    if run.name in LOOKUP_RUNS:
        oks[f"{run.name}_lookup_bwd"] = phase_lookup_bwd(run, data)
    log(f"{run.name} training phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    oks[f"{run.name}_serve"], served = phase_serving(ckpt, run)
    log(f"{run.name} serving phase: {time.perf_counter() - t0:.1f} s")
    return trained, served


# ---------------------------------------------------------------------------
# phase 5c: the training options
# ---------------------------------------------------------------------------

#: microbatches of the gradient-accumulation checks (B=128 -> 32 rows a
#: launch)
ACCUM_G = 4
#: cli.train --preset baseline_o1 --maxlen 1023 --grad_accum_steps 4 on the
#: flagship's fixture, --loader auto (the native pack): flash MHA at 32 rows
#: a launch
ACCUM_RUN = Run("baseline_o1_g4", "baseline_o1", MAXLEN, FIXTURE,
                WORK / "data", 128, ("--grad_accum_steps", str(ACCUM_G)),
                WORK / "baseline_o1_g4", "flash", 0, False)
#: the preemption runs' training users (the flagship fixture's first 512:
#: 4 steps an epoch at B=128) and epochs
PREEMPT_USERS = 512
PREEMPT_EPOCHS = 2
#: the resumed run's largest parameter difference to the uninterrupted run,
#: in multiples of two uninterrupted runs' own, where those differ
PREEMPT_NOISE_FACTOR = 10.0
#: cli.train's loader timings by run name
TIMINGS: dict = {}


def _since(before):
    now = read_launches()
    return {k: now[k] - before[k] for k in now}


def _grad_cos(a, b):
    import torch

    na, nb = a.norm().item(), b.norm().item()
    if na == 0.0 and nb == 0.0:
        return 1.0
    return float(torch.dot(a.flatten(), b.flatten()) / (na * nb))


def phase_accum(run, data, ckpt):
    """One train step of ``run``'s model at full width and depth (the
    flagship: B=128, L=1024, bf16; tower dedup off and dropout 0) from its
    checkpoint on one batch, at G = ACCUM_G microbatches against G = 1: the
    loss within 1e-3 relative, every gradient leaf at cosine >= 0.999 (bf16
    against bf16), the fused training forward and backward launched G
    times as often, the peak memory above the state lower; each step's
    time (host clock, synchronised, 5 steps after 2) and peak printed; a
    profiled G-microbatch step held to the fused route's wgmma kernels."""
    import torch

    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg, schema, (batch,) = _train_batches(data, 1, run)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dropout_rate=0.0),
        train=dataclasses.replace(cfg.train, tower_dedup=False))
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    params, _ = CK.load_params(ckpt)
    tabs = TR.device_tables(tables, "cuda")
    b = TR.put_batch(batch, "cuda")
    nb = cfg.model.num_blocks
    res, ok = {}, True
    for G in (1, ACCUM_G):
        c = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  grad_accum_steps=G))
        state = TR.init_state(model, c, params=params, device="cuda")
        step = TR.make_train_step(model, c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = read_launches()
        state, m = step(state, b, tabs["mm"], tabs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        got = _since(before)
        want = dict.fromkeys(got, 0)
        want.update(fused_train=nb * G, fused_bwd=nb * G)
        ok &= check_launches(run, f"G={G} step", got, want)
        res[G] = dict(loss=float(m["loss"]), peak=peak, grads={
            p: t.grad.float().clone() for p, t in TR.param_leaves(
                state.params)})
        for _ in range(2):
            state, m = step(state, b, tabs["mm"], tabs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            state, m = step(state, b, tabs["mm"], tabs)
        torch.cuda.synchronize()
        res[G]["ms"] = (time.perf_counter() - t0) / 5 * 1e3
        if G > 1:
            def one_step():
                nonlocal state, m
                state, m = step(state, b, tabs["mm"], tabs)

            name = f"{run.name} G={G}"
            prof, wall = route_trace(name, one_step, ("attn_bwd", "fused"))
            by_name = _device_ms(prof)
            busy = sum(by_name.values())
            log(f"{name}: profiled step wall {wall:.3f} ms, device busy "
                f"{busy:.3f} ms (idle {max(0.0, 1 - busy / wall):.1%})")
            ok &= attn_bwd_route(name, by_name)
            ok &= wgmma_route(name, by_name)
        del state
    one, acc = res[1], res[ACCUM_G]
    rel = abs(acc["loss"] - one["loss"]) / abs(one["loss"])
    worst = min((_grad_cos(acc["grads"][p], g), p)
                for p, g in one["grads"].items())
    ok_num = rel <= 1e-3 and worst[0] >= 0.999
    ok_mem = acc["peak"] < one["peak"]
    log(f"{run.name}: grad accumulation at B=128, L=1024, bf16 (dropout 0, "
        f"tower dedup off): loss G=1 {one['loss']:.6f}, G={ACCUM_G} "
        f"{acc['loss']:.6f} (relative {rel:.2e}, limit 1e-3); lowest "
        f"gradient cosine {worst[0]:.6f} ({worst[1]}; limit 0.999, bf16 "
        f"against bf16) {'ok' if ok_num else 'FAIL'}")
    log(f"{run.name}: step G=1 {one['ms']:.3f} ms, peak {one['peak'] / 2**20:.1f}"
        f" MiB above the state; G={ACCUM_G} {acc['ms']:.3f} ms, peak "
        f"{acc['peak'] / 2**20:.1f} MiB (host clock, synchronised, 5 steps "
        f"after 2; peak by torch.cuda.max_memory_allocated, first step) "
        f"{'ok' if ok_mem else 'FAIL'}")
    return ok and ok_num and ok_mem


class _SignalingLoader:
    """A cached train loader that sends this process SIGTERM as it hands
    out batch 1 of epoch 2; the train loop ends the step in flight, writes
    its preemption checkpoint and returns."""

    supports_prep = True

    def __init__(self, inner):
        self.inner, self.armed = inner, True

    def __len__(self):
        return len(self.inner)

    def epoch(self, e, prep=None):
        import signal

        for i, b in enumerate(self.inner.epoch(e, prep=prep)):
            if self.armed and e == 2 and i == 1:
                self.armed = False
                os.kill(os.getpid(), signal.SIGTERM)
            yield b


def _max_diff(a, b):
    """(largest absolute difference, lowest cosine, its leaf) over two
    states' parameters."""
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    diff, worst = 0.0, (2.0, None)
    for (p, x), (_, y) in zip(TR.param_leaves(a.params),
                              TR.param_leaves(b.params)):
        x, y = x.detach().float(), y.detach().float()
        diff = max(diff, (x - y).abs().max().item())
        worst = min(worst, (_grad_cos(x, y), p))
    return diff, worst


#: ops whose CUDA default is not deterministic (atomics) and which
#: torch.use_deterministic_algorithms replaces with a deterministic
#: implementation without a warning
DETERMINISTIC_SWAPS = ("aten::index_add_", "aten::index_put_",
                       "aten::_index_put_impl_", "aten::put_",
                       "aten::scatter_add_", "aten::scatter_reduce_",
                       "aten::index_reduce_", "aten::index_copy_",
                       "aten::embedding_dense_backward",
                       "aten::_embedding_bag_backward",
                       "aten::repeat_interleave", "aten::cumsum")


def _step_determinism(fresh_state, step_fn):
    """Which ops make a step's bits vary: one step taken twice from the
    same state (``fresh_state()`` loads it anew), its gradients compared
    bitwise, then the same under torch.use_deterministic_algorithms
    (warn_only, its warnings kept: ops it has no deterministic version of);
    and the ops of the step (a CPU trace) that the switch replaces. Returns
    (plain runs equal, switched runs equal, warned ops, replaced ops)."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    def grads():
        state = step_fn(fresh_state())
        torch.cuda.synchronize()
        return [t.grad.clone() for _, t in TR.param_leaves(state.params)
                if t.grad is not None]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    plain = same(grads(), grads())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            switched = same(grads(), grads())
        finally:
            torch.use_deterministic_algorithms(False)
    warned = set()
    for w in caught:
        text = str(w.message)
        hit = re.match(r"(\S+) does not have a deterministic", text)
        warned.add(hit.group(1) if hit else
                   "cuBLAS" if "CuBLAS" in text else text[:60])
    state = fresh_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(state)
        torch.cuda.synchronize()
    ran = {e.key for e in prof.key_averages()}
    return plain, switched, sorted(warned), sorted(
        op for op in DETERMINISTIC_SWAPS if op in ran)


def phase_preempt(run, data, cache_dir):
    """Preemption and step-exact resume at the flagship's width (B=128,
    L=1024, bf16, the preset as it stands: tower dedup, dropout 0.01): the
    fixture's first PREEMPT_USERS training users, PREEMPT_EPOCHS epochs
    through train_loop on the native pack in ``cache_dir``. Two
    uninterrupted runs (the card's run-to-run spread), one that sends
    itself SIGTERM at epoch 2, step 1, and its resume from the preemption
    checkpoint with skip_steps: the same state.step as the uninterrupted
    run, a meta with preempted, epoch 1 and epoch_step >= 1, parameters
    bitwise equal where the two uninterrupted runs are, else within
    PREEMPT_NOISE_FACTOR times their own largest difference at per-leaf
    cosine >= 0.9999 (the ops that are not deterministic named). Then an
    async checkpoint written while the next step runs, bitwise equal to a
    synchronous save of the same state."""
    import json as _json

    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.data import native_pack as NP
    from tencent_recommendation_2025_tpu_torch.data.cached_dataset import \
        CachedTrainLoader
    from tencent_recommendation_2025_tpu_torch.data.dataset import \
        TrainSampler
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.pipeline import \
        train_val_split
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    t_phase = time.perf_counter()
    cfg = run.config()
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    tr, _ = train_val_split(len(sampler), cfg.train.valid_fraction,
                            cfg.train.seed)
    cache = NP.build_packed_cache_native(sampler, cache_dir)
    loader = CachedTrainLoader(cache, tr[:PREEMPT_USERS],
                               cfg.train.batch_size, seed=cfg.train.seed,
                               num_workers=8)
    n = len(loader)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    root = WORK / "preempt"
    if root.exists():
        shutil.rmtree(root)

    def loop(name, src, state=None, **kw):
        return TR.train_loop(
            model, cfg, src, None, tables, ckpt_dir=str(root / name),
            state=state if state is not None else TR.init_state(
                model, cfg, device="cuda"),
            num_epochs=PREEMPT_EPOCHS, verbose=False, device="cuda", **kw)

    full = [loop(f"full{i}", loader) for i in (1, 2)]
    pre = loop("pre", _SignalingLoader(loader))
    ckpt = CK.latest_checkpoint(root / "pre")
    restored, meta = CK.load_checkpoint(ckpt, model, cfg, device="cuda")
    at = restored.step   # the resumed loop updates the state in place
    res = loop("pre", loader, state=restored, start_epoch=meta["epoch"],
               skip_steps=meta["epoch_step"])
    want = PREEMPT_EPOCHS * n
    ok_meta = (meta.get("preempted") is True and meta["epoch"] == 1
               and meta["epoch_step"] >= 1
               and at == pre.step == n + meta["epoch_step"]
               and res.step == full[0].step == full[1].step == want)
    log(f"{run.name}: preemption at epoch 2 step 1 ({PREEMPT_USERS} users, "
        f"{n} steps an epoch): checkpoint {ckpt.name}, meta epoch "
        f"{meta['epoch']} epoch_step {meta['epoch_step']} preempted "
        f"{meta.get('preempted')}; state.step preempted {pre.step}, loaded "
        f"{at}, resumed {res.step}, uninterrupted {full[0].step} and {full[1].step} "
        f"(want {want}) {'ok' if ok_meta else 'FAIL'}")
    noise, noise_cos = _max_diff(full[0], full[1])
    diff, worst = _max_diff(full[0], res)
    if noise == 0.0:
        ok_eq = diff == 0.0
        rule = "bitwise (the uninterrupted runs are bitwise equal)"
    else:
        ok_eq = diff <= PREEMPT_NOISE_FACTOR * noise and worst[0] >= 0.9999
        rule = (f"<= {PREEMPT_NOISE_FACTOR:g} x the uninterrupted runs' own "
                f"{noise:.3e} (their lowest cosine {noise_cos[0]:.8f}) and "
                "cosine >= 0.9999")
    log(f"{run.name}: resumed run against the uninterrupted one: largest "
        f"difference {diff:.3e}, lowest cosine {worst[0]:.8f} ({worst[1]}); "
        f"rule {rule} {'ok' if ok_eq else 'FAIL'}")

    # the async save: the state copied at the call, the files written while
    # the next step updates the state in place
    step = TR.make_train_step(model, cfg)
    tabs = TR.device_tables(tables, "cuda")
    raw = next(iter(loader.epoch(PREEMPT_EPOCHS + 1)))
    batch = TR.put_batch(_host_prep(cfg, raw, tables, data, 0), "cuda")
    state = full[1]
    sync = CK.save_checkpoint(root / "sync", state, state.step,
                              model_config=model.cfg)
    t0 = time.perf_counter()
    handle = CK.save_checkpoint_async(root / "async", state, state.step,
                                      model_config=model.cfg)
    t_call = time.perf_counter() - t0
    state, _ = step(state, batch, tabs["mm"], tabs)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    path = handle.result()
    t_all = time.perf_counter() - t0
    manifest = _json.loads((path / "manifest.json").read_text())
    same = manifest == _json.loads((sync / "manifest.json").read_text())
    for e in manifest["leaves"]:
        same &= bool(np.array_equal(np.load(path / e["file"]),
                                    np.load(sync / e["file"])))
    moved = not torch.equal(state.params["pos_emb"].cpu(), torch.from_numpy(
        np.load(path / next(e["file"] for e in manifest["leaves"]
                            if e["path"] == "0/pos_emb"))))
    ok_async = same and moved
    log(f"{run.name}: async checkpoint ({len(manifest['leaves'])} leaves) "
        f"bitwise equal to a synchronous save of the same state: {same}; "
        f"the step that ran meanwhile moved the state: {moved}; the call "
        f"returned in {t_call * 1e3:.1f} ms, the step ended at "
        f"{t_step * 1e3:.1f} ms, the save at {t_all * 1e3:.1f} ms "
        f"{'ok' if ok_async else 'FAIL'}")
    if noise != 0.0 or diff != 0.0:
        plain, switched, warned, swapped = _step_determinism(
            lambda: CK.load_checkpoint(sync, model, cfg, device="cuda")[0],
            lambda st: step(st, batch, tabs["mm"], tabs)[0])
        log(f"{run.name}: one step twice from the same state: gradients "
            f"bitwise equal {plain}; under torch.use_deterministic_"
            f"algorithms {switched}; the step's ops whose CUDA default is "
            f"not deterministic and which that switch replaces: "
            f"{', '.join(swapped) or 'none'}; ops it warns of: "
            f"{', '.join(warned) or 'none'}")
    log(f"{run.name}: preemption phase {time.perf_counter() - t_phase:.1f} s")
    return ok_meta and ok_eq and ok_async


def phase_train_options(run, data, ckpt):
    """Phase 5c on the flagship's fixture: gradient accumulation at the
    flagship's width (:func:`phase_accum`), cli.train of ACCUM_RUN (flash
    MHA launches held to G times a step's, the native pack taken by --loader
    auto), preemption and step-exact resume (:func:`phase_preempt`, on
    ACCUM_RUN's pack). Returns (ok, the fused kernels' launches of the
    phase, ACCUM_RUN's)."""
    t0 = time.perf_counter()
    reset_launches()
    ok = phase_accum(run, data, ckpt)
    fused = read_launches()
    ok_run, accum_launches, _, _ = phase_training(ACCUM_RUN)
    ok_loader = TIMINGS[ACCUM_RUN.name].get("loader") == "native"
    log(f"{ACCUM_RUN.name}: --loader auto took "
        f"{TIMINGS[ACCUM_RUN.name].get('loader')} "
        f"{'ok' if ok_loader else 'FAIL'}")
    reset_launches()
    ok_pre = phase_preempt(run, data, ACCUM_RUN.work / "model"
                           / f"packed_cache_maxlen{MAXLEN}")
    fused = {k: v + read_launches()[k] for k, v in fused.items()}
    log(f"training options phase: {time.perf_counter() - t0:.1f} s")
    return ok and ok_run and ok_loader and ok_pre, fused, accum_launches


# ---------------------------------------------------------------------------
# phase 5d: data parallelism on a local mesh
# ---------------------------------------------------------------------------

#: sampled_softmax_dp at L=256 on the parity fixture (its own L=102 runs no
#: kernel; at 256 the fused kernels take its 4 heads of 16), no checkpoint:
#: its parameters from the preset's seed
SOFTMAX_DP_MESH_RUN = Run("softmax_dp_mesh", "sampled_softmax_dp", 255,
                          PARITY_FIXTURE, PARITY_DATA, 64, (),
                          WORK / "softmax_dp_mesh", "fused", 0, True,
                          check_rows=16)
#: (run, name, data shards) of the phase: 32 and 8 rows a shard
DP_CASES = ((FLAGSHIP_RUN, "flagship_dp", 4), (SOFTMAX_DP_MESH_RUN,
                                               "softmax_dp_mesh", 8))
#: timed steps of each side (after 2)
DP_STEPS = 6
#: microbatches of the BCE case's accumulated step on the mesh
DP_ACCUM_G = 2


class _ListLoader:
    """A train loader over batches already drawn: every epoch the same."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def epoch(self, e):
        return iter(self.batches)


class _Scalars:
    """A TensorBoard writer that keeps every scalar in ``kept`` (tag ->
    values)."""

    def __init__(self, kept):
        self.kept = kept

    def scalar(self, tag, value, step):
        self.kept.setdefault(tag, []).append(value)

    def close(self):
        pass


def _dp_prep(cfg, batch, tables, itemnum, i, shards):
    """The train loop's host prep of batch ``i`` of epoch 1 on ``shards``
    data shards: the shared negatives of the sampled softmax, then the tower
    dedup plan (stacked per shard above 1)."""
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    key = (cfg.train.seed, 97, 1, i)
    if cfg.train.loss_type == "sampled_softmax":
        batch = dict(batch, sampled_neg_ids=TR._sample_negatives(
            cfg, itemnum, key))
    if cfg.train.tower_dedup:
        batch = TR.augment_batch_dedup(batch, cfg, tables, itemnum,
                                       step_key=key, n_data_shards=shards)
    return batch


@contextlib.contextmanager
def _cpu_inbatch_draw():
    """The in-batch candidates drawn on the CPU from a generator seeded 0,
    whatever the device: the card's and the CPU's steps then take the same
    candidates (a device's generator draws other numbers)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import losses as LS

    saved = LS.inbatch_draw
    LS.inbatch_draw = lambda n, total, gen, dev: torch.randint(
        0, total, (n,), generator=torch.Generator().manual_seed(0)).to(dev)
    try:
        yield
    finally:
        LS.inbatch_draw = saved


def _fused_ms(by_name):
    """(forward, backward) device ms of the fused kernels in a profile and
    the text of the backward's split."""
    fwd, _ = _kernel_split(by_name, KERNEL_NAMES["fused"][0])
    bwd, split = _kernel_split(by_name, KERNEL_NAMES["fused"][1])
    return fwd, bwd, split


def phase_dp_case(run, name, S):
    """``run``'s preset on a local mesh of S data shards on the card (B/S
    rows a launch, the stacked tower-dedup plan, the learned tables
    row-sharded and the item-id lookups through the all-to-all, the static
    item and mm tables row-sharded: ``parallel.train.shard_tables``, S
    blocks each), from its checkpoint or (without one) the preset's seed:

    - speed: DP_STEPS synchronised steps after 2 on the mesh and on the
      single device from the same state and batches (bf16, the preset's
      dropout), launches held, and one profiled step of each, which must
      run the fused route's wgmma kernels: the fused forward and backward
      device ms at B/S rows beside B's; the mesh's ``ep_overflow`` of each
      step printed;
    - card against card (bf16, dropout 0; from the checkpoint, or the
      mesh's trained state): the mesh's step against the single device's
      on the first batch, loss within 1e-4 relative, every gradient at
      cosine >= 0.999 (the tables' at their rows), where no id overflowed
      its bucket (an overflowed id is a zero row on the mesh alone: the
      next check holds the step then);
    - card against the CPU: the mesh's step on its first 2 S rows against
      the CPU's plain bf16 version of the same step (the fused route's
      plain versions, the same mesh, which overflows the same ids; both
      draw the in-batch candidates on the CPU), the same ``ep_overflow``,
      loss within 1e-3 relative, every gradient at cosine >= 0.999;
    - under BCE, DP_ACCUM_G microbatches on the mesh against one (tower
      dedup off, dropout 0): loss within 1e-3 relative, every gradient at
      cosine >= 0.999, launches held;
    - ``train_loop`` for 2 steps on the mesh: its ``Performance/mfu``
      scalar written, between 0 and 1.

    Returns (ok, the fused launches of the phase)."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.data import synthetic
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.parallel import \
        sharded_embedding as TSE
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    t0 = time.perf_counter()
    if not run.data_dir.exists():
        synthetic.generate(run.data_dir, mm_emb_ids=("81",), **run.fixture)
        log(f"{name}: fixture {run.fixture} generated in "
            f"{time.perf_counter() - t0:.1f} s")
    data = TencentGRData(run.data_dir, mm_emb_ids=("81",))
    cfg, schema, raw = _train_batches(data, 2, run)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)

    def model_in(dtype, dropout=None):
        mc = dataclasses.replace(cfg.model, dtype=dtype)
        if dropout is not None:
            mc = dataclasses.replace(mc, dropout_rate=dropout)
        return (SeqRecModel(cfg=mc, schema=schema,
                            fused=FusedVocab.build(schema),
                            usernum=data.usernum, itemnum=data.itemnum),
                cfg.replace(model=mc))

    ckpt = CK.latest_checkpoint(run.work / "model")
    model, c16 = model_in("bfloat16")
    params = CK.load_params(ckpt)[0] if ckpt is not None else \
        model.init(torch.Generator().manual_seed(cfg.train.seed))
    mesh = local_mesh(MeshConfig(data=S))
    B, L, nb = cfg.train.batch_size, cfg.model.maxlen + 1, \
        cfg.model.num_blocks
    prepped = {n: [_dp_prep(cfg, b, tables, data.itemnum, i, n)
                   for i, b in enumerate(raw)] for n in (1, S)}
    cap = TR.tower_dedup_capacity(cfg, data.itemnum, S)
    shape = tuple(prepped[S][0]["dedup_uids"].shape)
    ok = shape == (S, cap)
    log(f"{name}: the stacked tower-dedup plan: dedup_uids {shape} (want "
        f"({S}, {cap})) {'ok' if ok else 'FAIL'}")
    tabs = TR.device_tables(tables, "cuda")
    fused = dict.fromkeys(read_launches(), 0)

    def count(got):
        for k, v in got.items():
            fused[k] += v

    # speed: the mesh, then the single device, from the same state
    res, overflow = {}, []
    # the static tables row-sharded over the mesh's table shards, once
    stabs = PT.shard_tables(mesh, tabs)
    blocks = {n: [tuple(b.shape) for b in t.blocks] for n, t in
              (("sparse", stabs["sparse"]), ("mm", stabs["mm"]["81"]))
              if isinstance(t, TSE.StaticTable)}
    ok_static = len(blocks) == 2 and all(len(b) == S for b in
                                         blocks.values())
    log(f"{name}: static tables row-sharded over the {S} table shards: "
        + ", ".join(f"{n} {len(b)} x {b[0]}" for n, b in blocks.items())
        + f" ({tables.sparse.shape[0]} rows) "
        f"{'ok' if ok_static else 'FAIL'}")
    ok &= ok_static
    for side, m_, n in (("mesh", mesh, S), ("single", None, 1)):
        batches = [TR.put_batch(b, "cuda") for b in prepped[n]]
        state = TR.init_state(model, c16, params=params, device="cuda")
        tb = tabs
        if m_ is not None:
            state = PT.shard_existing_state(m_, state)
            tb = stabs
        step = TR.make_train_step(model, c16, m_)
        reset_launches()
        ovf = []
        for b in batches:
            state, m = step(state, b, tb["mm"], tb)
            ovf.append(m.get("ep_overflow"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(DP_STEPS):
            state, m = step(state, batches[i % 2], tb["mm"], tb)
            ovf.append(m.get("ep_overflow"))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) / DP_STEPS * 1e3
        if m_ is not None:
            overflow = [int(v) for v in ovf]
        got = read_launches()
        want = dict.fromkeys(got, 0)
        want.update(fused_train=nb * n * (DP_STEPS + 2),
                    fused_bwd=nb * n * (DP_STEPS + 2))
        ok &= check_launches(run, f"{name} {side} speed steps ({n} x "
                             f"{B // n} rows)", got, want)
        ok &= bool(torch.isfinite(m["loss"]).item())
        count(got)

        def one_step():
            nonlocal state, m
            state, m = step(state, batches[0], tb["mm"], tb)

        reset_launches()
        prof, wall = route_trace(f"{name} {side}", one_step,
                                 ("attn_bwd", "fused"))
        count(read_launches())
        by_name = _device_ms(prof)
        ok &= attn_bwd_route(f"{name} {side}", by_name)
        ok &= wgmma_route(f"{name} {side}", by_name)
        fwd, bwd, split = _fused_ms(by_name)
        res[side] = dict(ms=ms, fwd=fwd, bwd=bwd, split=split,
                         busy=sum(by_name.values()), wall=wall)
        if side == "mesh":
            trained = PT.unpad_state(state, model, mesh).params
        del state
    if ckpt is None:
        params = trained              # the checks start from a trained state
    mesh_r, one_r = res["mesh"], res["single"]
    log(f"{name}: train step (B={B}, L={L}, bf16, dropout "
        f"{cfg.model.dropout_rate}): {S} data shards of {B // S} rows "
        f"{mesh_r['ms']:.3f} ms ({B / mesh_r['ms'] * 1e3:.1f} examples/s), "
        f"single device {one_r['ms']:.3f} ms ({B / one_r['ms'] * 1e3:.1f} "
        f"examples/s) (host clock, synchronised, {DP_STEPS} steps after 2)")
    log(f"{name}: ep_overflow of the mesh's {len(overflow)} steps (item ids "
        f"past their all-to-all bucket, zero rows and no gradient): "
        f"{', '.join(map(str, overflow))}")
    for side, r in res.items():
        rows = B // S if side == "mesh" else B
        n = S if side == "mesh" else 1
        idle = max(0.0, 1 - r["busy"] / r["wall"])
        log(f"{name}: {side} profiled step: wall {r['wall']:.3f} ms, busy "
            f"{r['busy']:.3f} ms (idle {idle:.1%}); fused forward "
            f"{r['fwd']:.3f} ms, backward "
            f"{r['bwd']:.3f} ms ({r['split']}) for {nb * n} launches each "
            f"at {rows} rows: {r['fwd'] / (nb * n):.4f} / "
            f"{r['bwd'] / (nb * n):.4f} ms a launch, "
            f"{r['fwd'] / B:.5f} / {r['bwd'] / B:.5f} ms a row")

    # card against card, and against the CPU (dropout 0)
    m0, c0 = model_in("bfloat16", dropout=0.0)

    def worst_of(g, ref):
        return min((_grad_cos(g[p], ref[p]), p) for p in ref)

    reset_launches()
    got = {}
    l_mesh, g_mesh = _loss_and_grads(m0, c0, params, prepped[S][0], tables,
                                     "cuda", mesh=mesh, metrics=got)
    l_one, g_one = _loss_and_grads(m0, c0, params, prepped[1][0], tables,
                                   "cuda")
    rel = abs(l_mesh - l_one) / abs(l_one)
    worst = worst_of(g_mesh, g_one)
    ovf = int(got.get("ep_overflow", 0))
    ok_cc = rel <= 1e-4 and worst[0] >= 0.999 and np.isfinite(l_mesh)
    # overflowed ids return zero rows on the mesh alone: the single device
    # is then another function, and the CPU's mesh step below the check
    held = "ok" if ok_cc else "FAIL"
    if ovf > 0:
        ok_cc = bool(np.isfinite(l_mesh))
        held = (f"not applicable: {ovf} ids overflowed (the CPU's mesh step "
                "below holds it)")
    log(f"{name}: card mesh step against the card's single-device step "
        f"(B={B}, bf16, dropout 0, ep_overflow {ovf}): loss {l_mesh:.6f} / "
        f"{l_one:.6f} (relative {rel:.2e}, limit 1e-4); lowest gradient "
        f"cosine {worst[0]:.6f} ({worst[1]}, limit 0.999) {held}")
    rows = 2 * S
    cut = _dp_prep(cfg, {k: v[:rows] for k, v in raw[0].items()}, tables,
                   data.itemnum, 0, S)
    t1 = time.perf_counter()
    got_card, got_cpu = {}, {}
    with _cpu_inbatch_draw():
        l_card, g_card = _loss_and_grads(m0, c0, params, cut, tables, "cuda",
                                         mesh=mesh, metrics=got_card)
        count(read_launches())
        l_cpu, g_cpu = _loss_and_grads(m0, c0, params, cut, tables, "cpu",
                                       route="fused", mesh=mesh,
                                       metrics=got_cpu)
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst = worst_of(g_card, g_cpu)
    ovf_card = int(got_card.get("ep_overflow", -1))
    ovf_cpu = int(got_cpu.get("ep_overflow", -1))
    ok_cpu = rel <= 1e-3 and worst[0] >= 0.999 and np.isfinite(l_card) \
        and ovf_card == ovf_cpu
    log(f"{name}: card mesh step against the CPU's plain bf16 version of it "
        f"({rows} rows, {S} shards of 2; CPU {time.perf_counter() - t1:.1f}"
        f" s; ep_overflow {ovf_card} / {ovf_cpu}): loss {l_card:.6f} / "
        f"{l_cpu:.6f} (relative {rel:.2e}, limit 1e-3); lowest gradient "
        f"cosine {worst[0]:.6f} ({worst[1]}, limit 0.999) "
        f"{'ok' if ok_cpu else 'FAIL'}")

    ok_acc = True
    if cfg.train.loss_type == "bce":
        # gradient accumulation on the mesh (tower dedup off: G > 1 refuses
        # it; BCE draws nothing, so G microbatches give the batch's step)
        cg = {G: c0.replace(train=dataclasses.replace(
            c0.train, tower_dedup=False, grad_accum_steps=G))
            for G in (1, DP_ACCUM_G)}
        b = TR.put_batch(raw[0], "cuda")
        acc = {}
        reset_launches()
        for G, c in cg.items():
            state = PT.shard_existing_state(mesh, TR.init_state(
                m0, c, params=params, device="cuda"))
            state, m = TR.make_train_step(m0, c, mesh)(state, b,
                                                       stabs["mm"], stabs)
            acc[G] = (float(m["loss"]), {p: t.grad.float().clone() for p, t
                                         in TR.param_leaves(state.params)})
            del state
        got = read_launches()
        count(got)
        want = dict.fromkeys(got, 0)
        want.update(fused_train=nb * S * (1 + DP_ACCUM_G),
                    fused_bwd=nb * S * (1 + DP_ACCUM_G))
        ok_acc = check_launches(run, f"{name} G=1 and G={DP_ACCUM_G} steps on "
                                "the mesh", got, want)
        (l1, g1), (lg, gg) = acc[1], acc[DP_ACCUM_G]
        rel = abs(lg - l1) / abs(l1)
        worst = worst_of(gg, g1)
        ok_g = rel <= 1e-3 and worst[0] >= 0.999
        ok_acc &= ok_g
        log(f"{name}: G={DP_ACCUM_G} on the mesh ({DP_ACCUM_G} microbatches "
            f"of {B // DP_ACCUM_G} rows, {B // DP_ACCUM_G // S} a shard; "
            f"bf16, dropout 0, tower dedup off) against G=1 on it: loss "
            f"{lg:.6f} / {l1:.6f} (relative {rel:.2e}, limit 1e-3); lowest "
            f"gradient cosine {worst[0]:.6f} ({worst[1]}, limit 0.999) "
            f"{'ok' if ok_g else 'FAIL'}")

    # the epoch loop on the mesh writes Performance/mfu on the card
    saved_writer, kept = TR.T.TBWriter, {}
    TR.T.TBWriter = lambda log_dir: _Scalars(kept)
    reset_launches()
    try:
        TR.train_loop(model, c16, _ListLoader(raw), None, tables,
                      num_epochs=1, mesh=mesh, verbose=False, device="cuda",
                      state=TR.init_state(model, c16, params=params,
                                          device="cuda"))
    finally:
        TR.T.TBWriter = saved_writer
    count(read_launches())
    mfu = kept.get("Performance/mfu", [])
    flops = TR.analytic_step_flops(c16, model, tower_dedup=True,
                                   n_data_shards=S)
    ok_mfu = len(mfu) == len(raw) and all(0.0 < v < 1.0 for v in mfu)
    log(f"{name}: train_loop on the mesh: Performance/mfu "
        f"{', '.join(f'{v:.4f}' for v in mfu) or 'absent'} (analytic "
        f"{flops / 1e9:.1f} GFLOP a step, peak "
        f"{TR.device_peak_flops('cuda', c16.model.dtype)}) "
        f"{'ok' if ok_mfu else 'FAIL'}")
    log(f"{name} phase: {time.perf_counter() - t0:.1f} s")
    return ok and ok_cc and ok_cpu and ok_acc and ok_mfu, fused


def phase_dp():
    """Phase 5d: :func:`phase_dp_case` for each of DP_CASES. Returns (ok,
    their fused launches summed)."""
    t0 = time.perf_counter()
    ok, fused = True, dict.fromkeys(read_launches(), 0)
    for run, name, S in DP_CASES:
        ok_c, got = phase_dp_case(run, name, S)
        ok &= ok_c
        fused = {k: v + got[k] for k, v in fused.items()}
    log(f"data-parallel phase: {time.perf_counter() - t0:.1f} s")
    return ok, fused


# ---------------------------------------------------------------------------
# phase 5f: tensor parallelism on a local data x model mesh
# ---------------------------------------------------------------------------

#: (run, name, data shards, model shards, batch) of phase 5f:
#: sharded_multihost on its own data 4 x model 2 (16 rows and 2 heads of 16
#: a standalone attention launch; its item table at packed scale, so that
#: each of the 8 table shards writes through the group scatter), and the
#: flagship on data 2 x model 2 at 32 rows (H = 1: every shard runs the
#: head whole, H % M != 0)
TP_CASES = ((SPARSE_RUN, "tp_sparse", 4, 2, 64),
            (FLAGSHIP_RUN, "tp_flagship", 2, 2, 64))
#: timed steps of each side (after 1)
TP_STEPS = 2


def phase_tp_case(run, name, S_data, M, B):
    """``run``'s preset on a local mesh of data ``S_data`` x model ``M``
    (bf16, dropout off) against the single device's card step from the
    same state and batch on the mesh's route ("core": the blocks unfused,
    the standalone attention; the single device's own fused route rounds
    elsewhere in bf16, and its gradients' cosine to the core route's is
    printed): the loss within 1e-3 relative, the lowest per-leaf gradient
    cosine >= 0.999; with a sparse ``item_emb`` (at
    packed scale here: ``TABLE_PACK_MIN_ROWS`` 1) every table shard's
    touched groups and accumulators bitwise a plain row write of the same
    step's rows (:func:`plain_group_writes`). The launches: the standalone
    HSTU attention (rows 13-14) once a block, data shard and model shard
    (once a block and data shard where M does not divide H), the group
    scatter once a table shard and chunk, no fused kernel; a profiled mesh
    step runs the attention's wgmma kernels (``hstu_route``). Logs the
    mesh's and the single device's step ms (host clock, TP_STEPS
    synchronised steps after 1), the mesh step's idle share, and the HSTU
    attention's device ms a launch at the shard's heads beside all heads.
    Returns (ok, the launches of the phase)."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.models import encoder as ENC
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    t0 = time.perf_counter()
    if not run.data_dir.exists():
        from tencent_recommendation_2025_tpu_torch.data import synthetic

        synthetic.generate(run.data_dir, mm_emb_ids=("81",), **run.fixture)
    data = TencentGRData(run.data_dir, mm_emb_ids=("81",))
    run = dataclasses.replace(run, batch_size=B)
    cfg, schema, (raw,) = _train_batches(data, 1, run)
    sparse = "item_emb" in cfg.train.sparse_tables
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dtype="bfloat16",
                                  dropout_rate=0.0),
        # tower dedup takes a model mesh only with a sparse item_emb
        train=dataclasses.replace(cfg.train, tower_dedup=sparse))
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    mesh = local_mesh(MeshConfig(data=S_data, model=M))
    S = S_data * M
    nb, H, D = cfg.model.num_blocks, cfg.model.num_heads, \
        cfg.model.hidden_units
    saved_min = ST.TABLE_PACK_MIN_ROWS
    ST.TABLE_PACK_MIN_ROWS = 1 if sparse else saved_min
    try:
        model = SeqRecModel(cfg=cfg.model, schema=schema,
                            fused=FusedVocab.build(schema),
                            usernum=data.usernum, itemnum=data.itemnum)
        params = model.init(torch.Generator().manual_seed(cfg.train.seed),
                            device="cuda")
        tabs = TR.device_tables(tables, "cuda")
        stabs = PT.shard_tables(mesh, tabs)

        def prep(n_data, n_tables):
            key = (cfg.train.seed, 97, 1, 0)
            b = dict(raw)
            if cfg.train.loss_type == "sampled_softmax":
                b["sampled_neg_ids"] = TR._sample_negatives(
                    cfg, data.itemnum, key)
            if cfg.train.tower_dedup:
                b = TR.augment_batch_dedup(b, cfg, tables, data.itemnum,
                                           step_key=key,
                                           n_data_shards=n_data)
            if sparse:
                b = TR.augment_batch_sparse(b, cfg, data.itemnum, key,
                                            n_table_shards=n_tables,
                                            usernum=data.usernum)
            return TR.put_batch(b, "cuda")

        def fresh(m_):
            state = TR.init_state(model, cfg, params=params, device="cuda")
            return state if m_ is None else PT.shard_existing_state(m_,
                                                                    state)

        res = {}
        one_b = prep(1, 1)
        for side, m_, b in (("single", None, one_b),
                            ("single_core", None, one_b),
                            ("mesh", mesh, prep(S_data, S))):
            state = fresh(m_)
            tb = tabs if m_ is None else stabs
            want = plain_group_writes(model, cfg, fresh(m_), b, tb, m_) \
                if sparse and m_ is not None else None
            step = TR.make_train_step(model, cfg, m_)
            reset_launches()
            saved_route = ENC.block_route
            if side == "single_core":
                # the route the mesh takes (the blocks unfused, the
                # standalone attention), so that the check holds the split
                # alone: the fused route rounds elsewhere in bf16
                ENC.block_route = lambda *a: "core"
            try:
                state, met = step(state, b, tb["mm"], tb)
            finally:
                ENC.block_route = saved_route
            torch.cuda.synchronize()
            if side == "single_core":
                res[side] = dict(loss=float(met["loss"]), got=read_launches(),
                                 grads={p: t.grad.float().clone() for p, t in
                                        TR.dense_leaves(state.params, cfg)})
                del state
                continue
            got = read_launches()
            grads = {p: t.grad.float().clone() for p, t in
                     TR.dense_leaves(state.params, cfg)}
            ok_groups = want is None or groups_written(
                want, state.params["item_emb"],
                state.tables["item_emb"]["acc"])
            t1 = time.perf_counter()
            for _ in range(TP_STEPS):
                state, _ = step(state, b, tb["mm"], tb)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) / TP_STEPS * 1e3
            prof = wall = None
            if m_ is not None:
                def one_step():
                    nonlocal state
                    state, _ = step(state, b, tb["mm"], tb)

                prof, wall = route_trace(name, one_step, ("hstu",))
            res[side] = dict(loss=float(met["loss"]), grads=grads, ms=ms,
                             got=got, ok_groups=ok_groups, prof=prof,
                             wall=wall)
            del state
            _free()
    finally:
        ST.TABLE_PACK_MIN_ROWS = saved_min
    one, core, tp = res["single"], res["single_core"], res["mesh"]
    rel = abs(tp["loss"] - core["loss"]) / abs(core["loss"])
    # a mesh's table gradients hold the shard-pad rows past the table's
    cos = {p: _grad_cos(tp["grads"][p][:len(g)], g)
           for p, g in core["grads"].items()}
    worst = min((c, p) for p, c in cos.items())
    fused = min((_grad_cos(core["grads"][p], g), p)
                for p, g in one["grads"].items())
    ok_num = rel <= 1e-3 and worst[0] >= 0.999 \
        and bool(np.isfinite(tp["loss"]))
    # launches of the checked mesh step
    calls = nb * S_data * (M if H % M == 0 else 1)
    key = "hstu_chunk" if HA._use_long(cfg.model.maxlen + 1,
                                       D // M if H % M == 0 else D) \
        else "hstu"
    got = tp["got"]
    want_l = dict.fromkeys(got, 0)
    want_l.update({f"{key}_fwd": calls, f"{key}_bwd": calls})
    if sparse:
        want_l["group_scatter"] = got["group_scatter"]
        ok_scatter = got["group_scatter"] >= S
    else:
        ok_scatter = True
    ok_launch = got == want_l and ok_scatter
    by_name = _device_ms(tp["prof"])
    ok_route = hstu_route(name, by_name)
    busy = sum(by_name.values())
    log(f"{name}: {run.preset} (B={B}, L={cfg.model.maxlen + 1}, D={D}, "
        f"H={H}, {nb} blocks, bf16, dropout 0) on data {S_data} x model {M} "
        f"({B // S_data} rows and {H // M if H % M == 0 else H} heads of "
        f"{D // H} a standalone attention launch) against the single "
        f"device's step on the mesh's route (unfused blocks, the standalone "
        f"attention) from the same state: loss {tp['loss']:.6f} / "
        f"{core['loss']:.6f} (relative {rel:.2e}, limit 1e-3); lowest "
        f"gradient cosine {worst[0]:.6f} ({worst[1]}, limit 0.999) "
        f"{'ok' if ok_num else 'FAIL'}; the single device's own fused "
        f"route against its core route: loss {one['loss']:.6f}, lowest "
        f"gradient cosine {fused[0]:.6f} ({fused[1]}; the two routes' bf16 "
        f"rounding, printed only)")
    if sparse:
        log(f"{name}: each of the {S} table shards' touched groups and "
            f"accumulators equal to a plain row write of compute_row_update"
            f"'s rows through its plan: {tp['ok_groups']} "
            f"{'ok' if tp['ok_groups'] else 'FAIL'}")
    log(f"{name}: launches of the checked mesh step: "
        + ", ".join(f"{k} {got[k]} (expected {want_l[k]})" for k in got
                    if got[k] or want_l[k])
        + f"; the single device's: " + ", ".join(
            f"{k} {v}" for k, v in one["got"].items() if v)
        + "; on the core route: " + ", ".join(
            f"{k} {v}" for k, v in core["got"].items() if v)
        + f" {'ok' if ok_launch else 'FAIL'}")
    log(f"{name}: train step {tp['ms']:.3f} ms on the mesh "
        f"({B / tp['ms'] * 1e3:.1f} examples/s), single device "
        f"{one['ms']:.3f} ms ({B / one['ms'] * 1e3:.1f} examples/s) (host "
        f"clock, synchronised, {TP_STEPS} steps after 1); profiled mesh "
        f"step: wall {tp['wall']:.3f} ms, device busy {busy:.3f} ms (idle "
        f"{max(0.0, 1 - busy / tp['wall']):.1%})")
    # the standalone attention at the shard's heads beside all of them
    L = cfg.model.maxlen + 1
    for Hc, Dc in ((H // M, D // M), (H, D)) if H % M == 0 else ((H, D),):
        q, k, v, dout, valid, rab = attention_inputs(B // S_data, L, Dc, Hc,
                                                     torch.bfloat16, 60)
        fns = (lambda: HA.hstu_attention_fwd(q, k, v, valid, rab, L, Hc),
               lambda: HA.hstu_attention_bwd(q, k, v, dout, valid, rab, L,
                                             Hc))
        shown = []
        for call, names in zip(fns, KERNEL_NAMES["hstu"]):
            ms = kernel_device_ms(call, names)
            # the profiler loses events late in a run: then CUDA events
            # with the queue held full (queued_ms), said so
            shown.append(f"{ms:.4f} device ms" if ms == ms else
                         f"{queued_ms(call):.4f} queued ms")
        log(f"{name}: HSTU attention at {B // S_data} rows, L={L}, {Hc} "
            f"heads of {Dc // Hc}: forward {shown[0]} / backward {shown[1]} "
            f"a launch")
        del q, k, v, dout, valid, rab
    _free()
    log(f"{name} phase: {time.perf_counter() - t0:.1f} s")
    return (ok_num and tp["ok_groups"] and ok_launch and ok_route, got)


def phase_tp():
    """Phase 5f: tensor parallelism on a local mesh (:data:`TP_CASES`).
    Returns (ok, the launches of its checked mesh steps)."""
    ok, launches = True, None
    for run, name, S_data, M, B in TP_CASES:
        o, got = phase_tp_case(run, name, S_data, M, B)
        ok &= o
        launches = got if launches is None else \
            {k: v + got[k] for k, v in launches.items()}
    return ok, launches


# ---------------------------------------------------------------------------
# phase 5g: pipeline parallelism on a local pipe x data mesh
# ---------------------------------------------------------------------------

#: (run, name, pipe, data, pp_microbatches, batch) of phase 5g: the flagship
#: at its B=128 on pipe 2 x data 2 with 8 microbatches a data column (8 rows
#: a fused launch, 4 blocks a stage: a card of a 4-card job), and
#: sharded_multihost (B=64, H=4, sparse item_emb at packed scale, the
#: sampled softmax) on pipe 2 x data 2 with 4 (8 rows a launch; 4 table
#: shards, each writing through the group scatter)
PP_CASES = ((FLAGSHIP_RUN, "pp_flagship", 2, 2, 8, 128),
            (SPARSE_RUN, "pp_sparse", 2, 2, 4, 64))
#: timed steps of each side (after 1)
PP_STEPS = 2
#: rows a launch at which the fused kernels are timed alone (the cases' 8,
#: a shard's 16 of pp_sparse), beside the single device's B
PP_LAUNCH_ROWS = (8, 16, 128)


def phase_pp_case(run, name, P, D, M, B):
    """``run``'s preset on a local mesh of pipe ``P`` x data ``D`` with
    ``M`` microbatches a data column (bf16, dropout off, tower dedup off as
    a pipe mesh turns it off) against the single device's fused step from
    the same state and batch: the loss within 1e-4 relative, the lowest
    per-leaf gradient cosine >= 0.9999; with a sparse ``item_emb`` (at
    packed scale here: ``TABLE_PACK_MIN_ROWS`` 1) every table shard's
    touched groups and accumulators bitwise a plain row write of the same
    step's rows (:func:`plain_group_writes`). The launches: the fused
    training forward and backward once a block and microbatch (NB x M x
    D), the group scatter at least once a table shard; a profiled mesh
    step runs the fused block's and the attention backward's wgmma
    kernels. Logs both sides' step ms (host clock, PP_STEPS synchronised
    steps after 1), idle shares, and the fused forward's and backward's
    device ms a launch at the microbatch's rows beside the single
    device's at B. Returns (ok, the launches of the checked mesh step)."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    t0 = time.perf_counter()
    if not run.data_dir.exists():
        from tencent_recommendation_2025_tpu_torch.data import synthetic

        synthetic.generate(run.data_dir, mm_emb_ids=("81",), **run.fixture)
    data = TencentGRData(run.data_dir, mm_emb_ids=("81",))
    run = dataclasses.replace(run, batch_size=B)
    cfg, schema, (raw,) = _train_batches(data, 1, run)
    sparse = "item_emb" in cfg.train.sparse_tables
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dtype="bfloat16",
                                  dropout_rate=0.0),
        train=dataclasses.replace(cfg.train, tower_dedup=False),
        mesh=MeshConfig(pipe=P, data=D, pp_microbatches=M))
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    mesh = local_mesh(cfg.mesh)
    S = P * D
    rows = B // S // (M // P)
    nb, H, L = cfg.model.num_blocks, cfg.model.num_heads, \
        cfg.model.maxlen + 1
    saved_min = ST.TABLE_PACK_MIN_ROWS
    ST.TABLE_PACK_MIN_ROWS = 1 if sparse else saved_min
    try:
        model = SeqRecModel(cfg=cfg.model, schema=schema,
                            fused=FusedVocab.build(schema),
                            usernum=data.usernum, itemnum=data.itemnum)
        params = model.init(torch.Generator().manual_seed(cfg.train.seed),
                            device="cuda")
        tabs = TR.device_tables(tables, "cuda")
        stabs = PT.shard_tables(mesh, tabs)

        def prep(n_tables):
            key = (cfg.train.seed, 97, 1, 0)
            b = dict(raw)
            if cfg.train.loss_type == "sampled_softmax":
                b["sampled_neg_ids"] = TR._sample_negatives(
                    cfg, data.itemnum, key)
            if sparse:
                b = TR.augment_batch_sparse(b, cfg, data.itemnum, key,
                                            n_table_shards=n_tables,
                                            usernum=data.usernum)
            return TR.put_batch(b, "cuda")

        def fresh(m_):
            state = TR.init_state(model, cfg, params=params, device="cuda")
            return state if m_ is None else PT.shard_existing_state(m_,
                                                                    state)

        res = {}
        for side, m_, b in (("single", None, prep(1)),
                            ("mesh", mesh, prep(S))):
            state = fresh(m_)
            tb = tabs if m_ is None else stabs
            want = plain_group_writes(model, cfg, fresh(m_), b, tb, m_) \
                if sparse and m_ is not None else None
            step = TR.make_train_step(model, cfg, m_)
            reset_launches()
            state, met = step(state, b, tb["mm"], tb)
            torch.cuda.synchronize()
            got = read_launches()
            grads = {p: t.grad.float().clone() for p, t in
                     TR.dense_leaves(state.params, cfg)}
            ok_groups = want is None or groups_written(
                want, state.params["item_emb"],
                state.tables["item_emb"]["acc"])
            t1 = time.perf_counter()
            for _ in range(PP_STEPS):
                state, _ = step(state, b, tb["mm"], tb)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) / PP_STEPS * 1e3

            def one_step():
                nonlocal state
                state, _ = step(state, b, tb["mm"], tb)

            prof, wall = route_trace(f"{name} {side}", one_step,
                                     ("attn_bwd", "fused"))
            by_name = _device_ms(prof)
            ok_route = wgmma_route(f"{name} {side}", by_name) \
                and attn_bwd_route(f"{name} {side}", by_name)
            fwd, bwd, split = _fused_ms(by_name)
            res[side] = dict(loss=float(met["loss"]), grads=grads, ms=ms,
                             got=got, ok_groups=ok_groups, wall=wall,
                             busy=sum(by_name.values()), fwd=fwd, bwd=bwd,
                             split=split, ok_route=ok_route)
            del state
            _free()
    finally:
        ST.TABLE_PACK_MIN_ROWS = saved_min
    one, pp = res["single"], res["mesh"]
    rel = abs(pp["loss"] - one["loss"]) / abs(one["loss"])
    # a mesh's table gradients hold the shard-pad rows past the table's
    cos = {p: _grad_cos(pp["grads"][p][:len(g)], g)
           for p, g in one["grads"].items()}
    worst = min((c, p) for p, c in cos.items())
    ok_num = rel <= 1e-4 and worst[0] >= 0.9999 \
        and bool(np.isfinite(pp["loss"]))
    calls = nb * M * D
    got = pp["got"]
    want_l = dict.fromkeys(got, 0)
    want_l.update(fused_train=calls, fused_bwd=calls)
    if sparse:
        want_l["group_scatter"] = got["group_scatter"]
    ok_launch = got == want_l and (not sparse or got["group_scatter"] >= S)
    log(f"{name}: {run.preset} (B={B}, L={L}, D={cfg.model.hidden_units}, "
        f"H={H}, {nb} blocks, bf16, dropout 0) on pipe {P} x data {D}, "
        f"{M} microbatches a data column ({rows} rows a fused launch, "
        f"{nb // P} blocks a stage) against the single device's fused step "
        f"from the same state: loss {pp['loss']:.6f} / {one['loss']:.6f} "
        f"(relative {rel:.2e}, limit 1e-4); lowest gradient cosine "
        f"{worst[0]:.7f} ({worst[1]}, limit 0.9999) "
        f"{'ok' if ok_num else 'FAIL'}")
    if sparse:
        log(f"{name}: each of the {S} table shards' touched groups and "
            f"accumulators equal to a plain row write of compute_row_update"
            f"'s rows through its plan: {pp['ok_groups']} "
            f"{'ok' if pp['ok_groups'] else 'FAIL'}")
    log(f"{name}: launches of the checked mesh step: "
        + ", ".join(f"{k} {got[k]} (expected {want_l[k]})" for k in got
                    if got[k] or want_l[k])
        + "; the single device's: " + ", ".join(
            f"{k} {v}" for k, v in one["got"].items() if v)
        + f" {'ok' if ok_launch else 'FAIL'}")
    log(f"{name}: train step {pp['ms']:.3f} ms on the mesh "
        f"({B / pp['ms'] * 1e3:.1f} examples/s), single device "
        f"{one['ms']:.3f} ms ({B / one['ms'] * 1e3:.1f} examples/s) (host "
        f"clock, synchronised, {PP_STEPS} steps after 1)")
    for side, r, n, at in (("mesh", pp, calls, rows),
                           ("single", one, nb, B)):
        log(f"{name}: {side} profiled step: wall {r['wall']:.3f} ms, busy "
            f"{r['busy']:.3f} ms (idle "
            f"{max(0.0, 1 - r['busy'] / r['wall']):.1%}); fused forward "
            f"{r['fwd']:.3f} ms, backward {r['bwd']:.3f} ms ({r['split']}) "
            f"for {n} launches each at {at} rows: {r['fwd'] / n:.4f} / "
            f"{r['bwd'] / n:.4f} ms a launch, {r['fwd'] / B:.5f} / "
            f"{r['bwd'] / B:.5f} ms a row")
    _free()
    log(f"{name} phase: {time.perf_counter() - t0:.1f} s")
    return (ok_num and pp["ok_groups"] and ok_launch and pp["ok_route"]
            and one["ok_route"], got)


def pp_launch_times():
    """The fused block's training forward and backward kernels alone at
    the flagship's shape and PP_LAUNCH_ROWS rows (bf16, the preset's
    dropout): device ms a launch and a row (:func:`kernel_device_ms`)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    H, p = FLAGSHIP["H"], FLAGSHIP_DROPOUT
    seed = torch.tensor([99], dtype=torch.int32, device="cuda")
    shown = []
    for rows in PP_LAUNCH_ROWS:
        x, ops, tt = block_inputs(**dict(FLAGSHIP, B=rows),
                                  dtype=torch.bfloat16, seed=12)
        _, av = FB.fused_hstu_block_train(x, ops, tt, H, seed, p)
        dout = torch.randn(x.shape, generator=torch.Generator(
            device="cuda").manual_seed(16), device="cuda").to(x.dtype)
        fwd = kernel_device_ms(lambda: FB.fused_hstu_block_train(
            x, ops, tt, H, seed, p), KERNEL_NAMES["fused"][0])
        bwd = kernel_device_ms(lambda: FB.fused_hstu_block_bwd(
            x, av, dout, ops, tt, H, seed, p), KERNEL_NAMES["fused"][1])
        shown.append(f"{rows} rows {fwd:.4f} / {bwd:.4f} ms a launch "
                     f"({fwd / rows:.5f} / {bwd / rows:.5f} ms a row)")
        del x, ops, tt, av, dout
    _free()
    log("pp: fused training forward / backward alone at L=1024, D=64, H=1 "
        "(device ms): " + "; ".join(shown))


def pp_dropout_check():
    """Dropout on a pipe mesh: the flagship's blocks (bf16, its dropout
    rate) on a local mesh of pipe 2, 16 identical rows in 2 microbatches of
    8; every fused launch's seed recorded. Two microbatches of identical
    rows draw different masks in every block (the masks the kernels draw:
    ``ops.fused_block.keep_mask`` of the launch's seed, which phase 3 holds
    the kernels to), and the kept share of all of them stays within 5
    binomial standard deviations of 1 - rate. Returns ok."""
    import torch

    from tencent_recommendation_2025_tpu_torch.config import ModelConfig
    from tencent_recommendation_2025_tpu_torch.models import encoder as ENC
    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import LocalMesh

    rate, R, L, D = FLAGSHIP_DROPOUT, 16, FLAGSHIP["L"], FLAGSHIP["D"]
    cfg = ModelConfig(hidden_units=D, num_heads=1, num_blocks=8,
                      maxlen=L - 1, block_type="hstu", ffn_type="swiglu",
                      dtype="bfloat16", dropout_rate=rate,
                      reference_init=False)
    F = ENC.swiglu_hidden_dim(D, cfg.ffn_hidden_mult, cfg.ffn_multiple_of)
    params = _tree_map(lambda t: t.to("cuda"), ENC.init_encoder_params(
        torch.Generator().manual_seed(3), cfg))
    g = torch.Generator().manual_seed(4)
    emb = torch.randn((1, L, D), generator=g).repeat(R, 1, 1).to("cuda")
    ids = torch.ones((R, L), dtype=torch.int32, device="cuda")
    pos = torch.zeros((L + 1, D), device="cuda")
    seen = []
    real = FB.fused_hstu_block_autograd

    def record(x, bp, tt, seed, *a, **k):
        seen.append((int(seed), x.shape[0]))
        return real(x, bp, tt, seed, *a, **k)

    FB.fused_hstu_block_autograd = record
    try:
        out = ENC.encode(params, emb, ids, ids, pos, cfg, train=True,
                         gen=torch.Generator(device="cuda").manual_seed(5),
                         mesh=LocalMesh(pipe=2, pp_microbatches=4),
                         route="fused")
        torch.cuda.synchronize()
    finally:
        FB.fused_hstu_block_autograd = real
    # the launches in the GPipe order: tick t runs stage s (blocks s k ..
    # s k + k - 1) on microbatch t - s
    P, m, k = 2, 2, cfg.num_blocks // 2
    order = [(t - st, st * k + j) for t in range(m + P - 1)
             for st in range(P) if 0 <= t - st < m for j in range(k)]
    ok = len(seen) == len(order) and all(n == R // 2 for _, n in seen)
    by = {key: sd for key, (sd, _) in zip(order, seen)}
    seeds = {sd for sd, _ in seen}
    ok &= len(seeds) == len(seen)          # no two launches share a seed
    kept = total = differ = 0
    for blk in range(cfg.num_blocks):
        s0, s1 = by.get((0, blk), 0), by.get((1, blk), 0)
        for site, W in ((0, D), (1, F)):
            m0 = FB.keep_mask(R // 2, L, W, s0, site, rate, "cuda") > 0
            m1 = FB.keep_mask(R // 2, L, W, s1, site, rate, "cuda") > 0
            differ += int(not torch.equal(m0[0], m1[0]))
            kept += int(m0.sum()) + int(m1.sum())
            total += m0.numel() + m1.numel()
    share = kept / total
    sigma = (rate * (1 - rate) / total) ** 0.5
    ok_share = abs(share - (1 - rate)) <= 5 * sigma
    ok_out = bool(torch.isfinite(out.float()).all())
    ok_all = ok and differ == 2 * cfg.num_blocks and ok_share and ok_out
    log(f"pp: dropout on pipe 2 (rate {rate}, {R} identical rows in 2 "
        f"microbatches of {R // 2}, 8 blocks): {len(seen)} fused launches, "
        f"{len(seeds)} distinct seeds; row 0 of the two microbatches "
        f"draws another mask at {differ} of {2 * cfg.num_blocks} (block, "
        f"site) pairs; kept share {share:.6f} of {total} draws (want "
        f"{1 - rate:.4f} within 5 sigma = {5 * sigma:.2e}) "
        f"{'ok' if ok_all else 'FAIL'}")
    _free()
    return ok_all


def phase_pp():
    """Phase 5g: pipeline parallelism on a local mesh (:data:`PP_CASES`),
    the fused kernels alone at a microbatch's rows, and the dropout masks.
    Returns (ok, the launches of its checked mesh steps)."""
    t0 = time.perf_counter()
    ok, launches = True, None
    for run, name, P, D, M, B in PP_CASES:
        o, got = phase_pp_case(run, name, P, D, M, B)
        ok &= o
        launches = got if launches is None else \
            {k: v + got[k] for k, v in launches.items()}
    pp_launch_times()
    ok &= pp_dropout_check()
    log(f"pipeline-parallel phase: {time.perf_counter() - t0:.1f} s")
    return ok, launches


def phase_native_pack(run):
    """The native pack of ``run``'s fixture and window (the long run's: 384
    users, L=4096) on the card's host, every field and the seen sets
    bitwise equal to the python pack cli.train built for it (kept in PACKS);
    both set-up times printed."""
    import numpy as np

    from tencent_recommendation_2025_tpu_torch.data import native_pack as NP
    from tencent_recommendation_2025_tpu_torch.data.dataset import \
        TrainSampler
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema

    py = next((v for k, v in PACKS.items()
               if k[0] == "cached" and k[-1] == run.maxlen), None)
    if py is None:
        log(f"{run.name}: no python pack of the window kept in PACKS FAIL")
        return False
    data = TencentGRData(run.data_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    sampler = TrainSampler(data, schema, run.maxlen)
    out = WORK / "native_pack" / run.name
    if out.exists():
        shutil.rmtree(out)
    t0 = time.perf_counter()
    nat = NP.build_packed_cache_native(sampler, out, threads=8)
    t_nat = time.perf_counter() - t0
    bad = [k for k, v in py.fields.items()
           if not np.array_equal(np.asarray(nat.fields[k]), v)]
    if not (np.array_equal(np.asarray(nat.seen_sets.offs), py.seen_sets.offs)
            and np.array_equal(np.asarray(nat.seen_sets.vals),
                               py.seen_sets.vals)):
        bad.append("seen sets")
    ok = not bad and set(nat.fields) == set(py.fields)
    t_py = TIMINGS.get(run.name, {}).get("cache_build_s", float("nan"))
    mb = sum(np.asarray(v).nbytes for v in nat.fields.values()) / 2**20
    log(f"{run.name}: native pack of {len(nat)} users at L={run.maxlen + 1} "
        f"({len(nat.fields)} fields, {mb:.1f} MiB) in {t_nat:.2f} s (8 "
        f"threads), the python pack in {t_py:.2f} s (cli.train, "
        f"{run.name} run); bitwise equal: "
        f"{'all fields and the seen sets' if ok else bad} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# phase 6b: the retrieval tiers
# ---------------------------------------------------------------------------

def _ids_recall(got, want):
    """Mean share of each row of ``want`` found in the same row of
    ``got``."""
    import numpy as np

    return float(np.mean([len(set(g.tolist()) & set(w.tolist())) / len(w)
                          for g, w in zip(got, want)]))


def phase_ann_methods(run):
    """``run``'s served result directory (embedding.fbin, id.u64bin,
    query.fbin) served again through ``retrieval.ann.run_ann`` with the
    approx, int8 and hnsw methods (what ``cli.infer --ann_method`` runs
    after encoding; tests/test_torch_train_cli.py drives that flag end to
    end): approx's ids equal the exact serve's, int8's and hnsw's top 10
    hold >= 0.9 of exact's; hnsw must have run the C++ tool (built from
    native/hnsw with make), not the JAX package's exact fallback. Prints
    each method's seconds."""
    import numpy as np

    from tencent_recommendation_2025_tpu_torch.config import RetrievalConfig
    from tencent_recommendation_2025_tpu_torch.data import formats
    from tencent_recommendation_2025_tpu_torch.retrieval import ann

    res = run.work / "result"
    exact = np.asarray(formats.read_result_ids(res / "id100.u64bin"))
    t0 = time.perf_counter()
    tool = ann.binary_path(build=True)
    log(f"{run.name}: HNSW tool {tool} (built or found in "
        f"{time.perf_counter() - t0:.1f} s)")
    ok_all = tool is not None
    for method in ("approx", "int8", "hnsw"):
        t0 = time.perf_counter()
        out = ann.run_ann(res, RetrievalConfig(method=method),
                          result_file=f"id100_{method}.u64bin")
        wall = time.perf_counter() - t0
        got = np.asarray(formats.read_result_ids(out))
        recall = _ids_recall(got, exact)
        ok = got.shape == exact.shape and (
            np.array_equal(got, exact) if method == "approx"
            else recall >= 0.9)
        ok_all &= ok
        log(f"{run.name}: ann method {method}: top-{got.shape[1]} of "
            f"{got.shape[0]} queries, "
            + (f"ids equal exact's: {np.array_equal(got, exact)}"
               if method == "approx" else
               f"recall@10 against exact {recall:.4f} (limit 0.9)")
            + f"; {wall:.2f} s with the files' I/O "
            f"{'ok' if ok else 'FAIL'}")
    return ok_all


# ---------------------------------------------------------------------------
# phase 5b: the generative tier (RQ-VAE tokenizer, decode head)
# ---------------------------------------------------------------------------

#: cli.semantic at RQVAEConfig's defaults (3 levels x 256 codes x 32 dims,
#: encoder 512, 256) on the flagship's checkpoint; its queries are 1024
#: users' predict, 4 batches of 256. 400 RQ-VAE steps (2000 until phase 5g
#: was added: 18.4 of the phase's 63.3 s at 108.8 steps/s); the checks the
#: phase judges read the artifacts, not how far they trained
SEMANTIC_ARGS = ("--rq_steps", "400", "--head_steps", "1000",
                 "--num_query_users", "1024")
SEMANTIC_EVAL_KEYS = {"rq_recon", "codes_used", "genret_train_hr",
                      "genret_beam_train_hr", "mips_train_hr", "num_pairs"}
#: the serving functions at scale: a seeded corpus of 1M items and 1024
#: queries (normal draws on the card with the flagship's served corpus's and
#: queries' per-dimension mean and deviation), 32 beams, top 10
SEMANTIC_SCALE = dict(N=1_000_000, Q=1024, W=32, k=10, seed=71)
#: first queries of the card's semantic serve held to the CPU's
SEMANTIC_CPU_ROWS = 128


def phase_semantic(run):
    """The generative tier on ``run``'s checkpoint, fixture and window: the
    port's cli.semantic (item tower over every id, the RQ-VAE trained and
    semantic_ids.npy written, the decode head trained on 1024 users' query
    pairs, artifacts saved beside the checkpoint, semantic_eval.json), its
    query encode held to the fused forward's launches (8 per batch of 256)
    and nothing else; then cli.infer --ann_method semantic --beam_width 32
    on the card (launches held), its first 128 queries served again by
    run_semantic_ann on the CPU from the same files and artifacts (mean
    top-10 overlap >= 0.98); semantic HR@10 / NDCG@10 printed beside the
    exact serve's; then the serving functions at scale
    (:func:`semantic_scale`). Returns (ok, the launches of both entry
    points)."""
    import numpy as np

    from tencent_recommendation_2025_tpu_torch.cli import infer as INF
    from tencent_recommendation_2025_tpu_torch.cli import semantic as SEM
    from tencent_recommendation_2025_tpu_torch.config import RetrievalConfig
    from tencent_recommendation_2025_tpu_torch.data import formats
    from tencent_recommendation_2025_tpu_torch.retrieval import \
        semantic_serve as SS

    t_phase = time.perf_counter()
    mcfg = run.config().model
    model_dir = run.work / "model"
    sem_dir = run.work / "semantic"
    os.environ["TRAIN_DATA_PATH"] = str(run.data_dir)
    os.environ["MODEL_OUTPUT_PATH"] = str(model_dir)
    os.environ["EVAL_RESULT_PATH"] = str(sem_dir)
    timings = {}
    reset_launches()
    t0 = time.perf_counter()
    ev = SEM.main(run.args() + list(SEMANTIC_ARGS), timings=timings)
    wall = time.perf_counter() - t0
    made = read_launches()
    nb = timings["n_query_batches"]
    ok = nb == 4 and check_launches(
        run, "cli.semantic (query encode, exact-MIPS hit rate)", made,
        expected_launches(run.kernels, mcfg.num_blocks, 0, nb,
                          scans=scan_calls(ev["num_pairs"])))
    ids = np.load(sem_dir / "semantic_ids.npy")
    itemnum = run.fixture["num_items"]
    ok_ids = bool(ids.shape == (itemnum + 1, 3) and ids.dtype == np.int32
                  and (ids[0] == 0).all() and ids.min() >= 0
                  and ids.max() < 256)
    ok_ev = set(ev) == SEMANTIC_EVAL_KEYS and bool(
        np.isfinite(ev["rq_recon"])) and ev["num_pairs"] > 0
    log(f"{run.name}: cli.semantic {wall:.1f} s: semantic_ids "
        f"{ids.shape} {ids.dtype}, distinct ids "
        f"{len(np.unique(ids[1:], axis=0))}; {json.dumps(ev)} "
        f"{'ok' if ok_ids and ok_ev else 'FAIL'}")
    log(f"{run.name}: cli.semantic stages (host clock, synchronised): item "
        f"tower {timings['item_reprs_s']:.3f} s; RQ-VAE "
        f"{timings['rq_steps'] / timings['rq_train_s']:.1f} steps/s "
        f"(batch 1024, {timings['rq_steps']} steps in "
        f"{timings['rq_train_s']:.2f} s); tokenize "
        f"{timings['tokenize_items'] / timings['tokenize_s']:.0f} items/s; "
        f"query predict {timings['predict_s']:.3f} s ({nb} batches of 256); "
        f"decode head {timings['head_steps'] / timings['head_train_s']:.1f} "
        f"steps/s ({timings['head_steps']} steps in "
        f"{timings['head_train_s']:.2f} s)")

    res = run.work / "result_semantic"
    os.environ["EVAL_DATA_PATH"] = str(run.data_dir)
    os.environ["EVAL_RESULT_PATH"] = str(res)
    served = {}
    reset_launches()
    metrics = INF.main(run.args() + ["--ann_method", "semantic",
                                     "--beam_width", "32"], timings=served)
    launches = read_launches()
    ok &= check_launches(
        run, "cli.infer --ann_method semantic", launches,
        expected_launches(run.kernels, mcfg.num_blocks, 0,
                          served["n_query_batches"]))
    exact = SERVED.get(run.name, {})
    log(f"{run.name}: semantic serve (beam 32, then the exact scorer's "
        f"fill): {served['topk_s']:.3f} s for {served['n_queries']} queries "
        f"over {served['n_items']} items; HR@10 {metrics['hr']:.4f} NDCG@10 "
        f"{metrics['ndcg']:.4f} beside the exact MIPS serve's HR@10 "
        f"{exact.get('hr', float('nan')):.4f} NDCG@10 "
        f"{exact.get('ndcg', float('nan')):.4f} (printed, not judged)")

    # the first queries again on the CPU, from the same files and artifacts
    cpu_dir = run.work / "semantic_cpu"
    cpu_dir.mkdir(parents=True, exist_ok=True)
    for f in ("embedding.fbin", "id.u64bin"):
        shutil.copy(res / f, cpu_dir / f)
    n = SEMANTIC_CPU_ROWS
    formats.save_emb(formats.load_fbin(res / "query.fbin")[:n],
                     cpu_dir / "query.fbin")
    t0 = time.perf_counter()
    SS.run_semantic_ann(cpu_dir, model_dir, RetrievalConfig(), beam_width=32,
                        device="cpu")
    cpu_s = time.perf_counter() - t0
    card = np.asarray(formats.read_result_ids(res / "id100.u64bin"))[:n]
    cpu = np.asarray(formats.read_result_ids(cpu_dir / "id100.u64bin"))
    overlap = _ids_recall(card, cpu)
    differ = int((card != cpu).any(axis=1).sum())
    ok_cpu = card.shape == cpu.shape == (n, 10) and overlap >= 0.98
    log(f"{run.name}: semantic top-10 of the first {n} queries, card vs "
        f"CPU ({cpu_s:.1f} s): mean overlap {overlap:.4f} (limit 0.98), "
        f"{differ} rows differ {'ok' if ok_cpu else 'FAIL'}")

    ok_scale = semantic_scale(model_dir, res)
    log(f"semantic phase: {time.perf_counter() - t_phase:.1f} s")
    return (ok and ok_ids and ok_ev and ok_cpu and ok_scale,
            {k: made[k] + launches[k] for k in made})


def semantic_scale(model_dir, res):
    """The generative serving functions on the card at SEMANTIC_SCALE, with
    the artifacts cli.semantic saved: tokenize the 1M-item corpus (8192
    rows a call, as run_semantic_ann), beam-decode the 1024 queries (one
    batch; 5 timed after 1), map the beams to items on the host
    (beam_retrieve), and the exact scorer's fill (genret_score_items_exact
    over the whole corpus in chunks of 4096, then its top 10); seconds on
    the host clock, synchronised, and the peak device memory; then one
    tokenize call and one beam decode under the profiler. Checks the
    shapes, that codes and item indices are in range and that every score
    is finite."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.data import formats
    from tencent_recommendation_2025_tpu_torch.models import rqvae as R
    from tencent_recommendation_2025_tpu_torch.retrieval.semantic_serve \
        import load_semantic_artifacts

    c = SEMANTIC_SCALE
    N, Q, W, k = c["N"], c["Q"], c["W"], c["k"]
    _free()
    rq, head, cfg = load_semantic_artifacts(model_dir, "cuda")
    L, C = cfg.num_levels, cfg.codebook_size
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])

    def draw(ref, rows):
        mu = torch.as_tensor(ref.mean(0), device="cuda")
        sd = torch.as_tensor(ref.std(0), device="cuda")
        return mu + sd * torch.randn((rows, ref.shape[1]), generator=gen,
                                     device="cuda")

    corpus = draw(formats.load_fbin(res / "embedding.fbin"), N)
    queries = draw(formats.load_fbin(res / "query.fbin"), Q)
    R.tokenize(rq, corpus[:8192])
    R.genret_beam_decode(head, rq, queries, cfg, W)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    codes = torch.cat([R.tokenize(rq, corpus[s:s + 8192])
                       for s in range(0, N, 8192)])
    torch.cuda.synchronize()
    t_tok = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(5):
        bc, bs = R.genret_beam_decode(head, rq, queries, cfg, W)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / 5
    codes_np, bc_np = codes.cpu().numpy(), bc.cpu().numpy()
    t0 = time.perf_counter()
    idx = R.beam_retrieve(bc_np, bs.cpu().numpy(), codes_np, k)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs, fi = R.top_k(R.genret_score_items_exact(head, rq, queries, codes,
                                                cfg), k)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    ok = bool(codes.shape == (N, L) and bc.shape == (Q, W, L)
              and idx.shape == (Q, k) and fi.shape == (Q, k)
              and codes.min() >= 0 and codes.max() < C
              and bc.min() >= 0 and bc.max() < C
              and idx.min() >= -1 and idx.max() < N
              and fi.min() >= 0 and fi.max() < N
              and torch.isfinite(bs).all() and torch.isfinite(fs).all()
              and (bs[:, 1:] <= bs[:, :-1]).all())
    short = int((idx < 0).any(axis=1).sum())
    distinct = len(np.unique(codes_np, axis=0))
    gb = 1e-9
    log(f"semantic at scale ({N} items x {corpus.shape[1]}, {Q} queries, "
        f"{L} levels x {C} codes, beam {W}, top {k}): tokenize "
        f"{N / t_tok:.0f} items/s ({t_tok:.3f} s, {distinct} distinct ids); "
        f"beam decode {Q / t_dec:.0f} queries/s ({t_dec * 1e3:.3f} ms a "
        f"batch of {Q}); beam_retrieve on the host {t_host:.3f} s ({short} "
        f"of {Q} rows short of {k}); the exact scorer's fill over the corpus "
        f"{t_fill:.3f} s; peak device memory above the corpus and queries "
        f"{(peak - base) * gb:.2f} GB (max_memory_allocated {peak * gb:.2f} "
        f"GB) {'ok' if ok else 'FAIL'}")
    for name, fn in (("tokenize (8192 rows)",
                      lambda: R.tokenize(rq, corpus[:8192])),
                     (f"beam decode ({Q} queries)",
                      lambda: R.genret_beam_decode(head, rq, queries, cfg,
                                                   W))):
        profile_call(f"semantic {name}", fn)
    del corpus, queries, codes
    _free()
    return ok


def profile_call(name, fn):
    """One synchronised call of ``fn`` under torch.profiler: its wall
    against the device's busy time, the host's time (``host_top``) and the
    kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = _device_ms(prof)
    busy = sum(by_name.values())
    host_top(name, prof, wall)
    log(f"{name}: profile: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"(idle {max(0.0, 1 - busy / wall):.1%}), "
        f"{sum(_kernel_launches(prof).values())} kernel launches; kernels "
        f"(ms): " + ", ".join(f"{k[:50]} {v:.3f}"
                              for k, v in by_name.most_common(6)))


#: the retrieval check: a seeded corpus of 10M rows of 64 and 1024 queries
#: (normal draws on the card); HNSW, whose index build on the host's
#: cores takes about 30 s per 50,000 rows at the reference's M=64,
#: efC=1280, runs on the first 20,000 rows
RETRIEVAL = dict(N=10_000_000, D=64, Q=1024, k=10, hnsw_rows=20_000)


def _library_topk(q, corpus, k, block=65536):
    """The library path the exact tier's kernel replaced, as its yardstick:
    cuBLAS's f32 product of each block of rows, ``torch.topk`` of its
    scores, and a ``torch.topk`` of the running winners with the block's."""
    import torch

    best_s = torch.full((q.shape[0], k), -float("inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.long, device=q.device)
    for lo in range(0, corpus.shape[0], block):
        top = torch.topk(q @ corpus[lo:lo + block].T, k, dim=1)
        cat_s = torch.cat([best_s, top.values], 1)
        cat_i = torch.cat([best_i, top.indices + lo], 1)
        sel = torch.topk(cat_s, k, dim=1).indices
        best_s, best_i = cat_s.gather(1, sel), cat_i.gather(1, sel)
    return best_s, best_i


def retrieval_kernel(report, corpus, queries, k):
    """The exact tier's kernel (``retrieval.mips.mips_topk``) on the
    retrieval corpus: against its plain version (ids equal; scores within
    1e-5 of the score scale, |q| times the rows' rms), then timed by CUDA
    events beside its bound (2QND at the bf16 peak or the f32 corpus read
    once, the larger), its plain version and the library path it replaced
    (:func:`_library_topk`); the scan kernel's registers and spills from
    the build's ``-Xptxas -v`` report (``report``) and its dynamic shared
    memory. Returns (ok, the kernel's JSON entry without launches)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import kernels
    from tencent_recommendation_2025_tpu_torch.retrieval import mips as MIPS

    (N, D), Q = corpus.shape, queries.shape[0]
    got_s, got_i = MIPS.mips_topk(queries, corpus, k)
    want_s, want_i = MIPS._topk_mips_plain(queries, corpus, k)
    scale = queries.norm(dim=1, keepdim=True) \
        * corpus.pow(2).sum(1).mean().sqrt()
    err = ((got_s - want_s).abs() / scale).max().item()
    same = torch.equal(got_i, want_i)
    ok = same and err <= 1e-5
    del got_s, got_i, want_s, want_i
    t = time_ms(lambda: MIPS.mips_topk(queries, corpus, k), 2, 10)
    t_plain = time_ms(lambda: MIPS._topk_mips_plain(queries, corpus, k), 1, 2)
    t_lib = time_ms(lambda: _library_topk(queries, corpus, k), 1, 2)
    bound, by, flops, nbytes = _bound(2.0 * Q * N * D, 4.0 * N * D)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = MIPS.scan_plan(Q, N, k, D, sms)
    names = (f"mips_scan_kernel<{plan.tm}>", "mips_merge_kernel")
    built = [r for r in kernels.ptxas_report(
        report.get("mips_topk", {}).get("log", "")) if r["kernel"] in names]
    regs = "; ".join(f"{r['kernel']} {r['registers']} registers, spills "
                     f"{r['spill_stores']}/{r['spill_loads']} B"
                     for r in built) or "not built in this run"
    smem = MIPS.scan_smem_bytes(plan.tm, D, k)
    log(f"retrieval kernel mips_topk ({N} x {D}, Q={Q}, k={k}; {plan}): "
        f"{t:.3f} ms ({flops / t / 1e9:.1f} TFLOP/s of f32 FFMA), bound "
        f"{bound:.3f} ms ({by}: {flops / 1e12:.3f} TFLOP; "
        f"{nbytes / 1e9:.2f} GB), plain {t_plain:.3f} ms, library_ms "
        f"{t_lib:.3f} ms; ids equal the plain version's {same}, largest "
        f"score error {err:.3g} of the score scale; {regs}; {smem} B of "
        f"dynamic shared memory a scan block {'ok' if ok else 'FAIL'}")
    return ok, {"name": "mips_topk", "route": "cuda",
                "source": SRC + "mips_topk.cu",
                "replaces": "none: the JAX package leaves the exact scan to "
                            "XLA", "launches": None, "max_abs_err": err,
                "ms": t, "plain_ms": t_plain, "bound_ms": bound,
                "bound_by": by, "library_ms": t_lib}


def phase_retrieval(report):
    """The retrieval tiers at 10M x 64 with Q=1024, k=10: first the exact
    tier's kernel against its plain version and timed
    (:func:`retrieval_kernel`); then exact (the kernel), approx (the same
    kernel on the card) and int8 (codes quantized on the host in row
    chunks, scores int8 x int8 exact in int32, ranked in bf16): each one's
    time (host clock, synchronised, after a warm-up on a 100,000-row
    slice), queries/s, peak device memory above the resident corpus, and
    recall@10 against exact; approx's ids must equal exact's. Then the
    HNSW tool on the first 20,000 rows: build and search seconds and
    recall@10 against exact on that slice. Returns (ok, the kernel's JSON
    entry); the phase's own ``mips_topk.launches`` (the check, the timings
    and the tiers) are logged apart, not put in the entry."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.data import formats
    from tencent_recommendation_2025_tpu_torch.retrieval import ann
    from tencent_recommendation_2025_tpu_torch.retrieval import mips as MIPS

    c = RETRIEVAL
    N, D, Q, k = c["N"], c["D"], c["Q"], c["k"]
    gen = torch.Generator(device="cuda").manual_seed(70)
    corpus = torch.randn((N, D), generator=gen, device="cuda")
    queries = torch.randn((Q, D), generator=gen, device="cuda")
    n = c["hnsw_rows"]
    base = corpus[:n].clone()
    launches = MIPS.mips_topk.launches
    ok_kernel, entry = retrieval_kernel(report, corpus, queries, k)

    def timed(fn, *args):
        fn(queries, *(a[:100_000] for a in args), k=k)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(queries, *args, k=k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return out, dt, torch.cuda.max_memory_allocated() - base

    (exact_s, exact), t_exact, m_exact = timed(MIPS.topk_mips, corpus)
    (_, approx), t_approx, m_approx = timed(MIPS.topk_mips_approx, corpus)
    host = corpus.cpu().numpy()
    t0 = time.perf_counter()
    codes, scales = MIPS.quantize_corpus_int8(host, "cuda")
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    (int8_s, int8), t_int8, m_int8 = timed(MIPS.topk_mips_int8, codes,
                                           scales)
    exact_np = exact.cpu().numpy()
    ok_approx = torch.equal(approx, exact)
    r_int8 = _ids_recall(int8.cpu().numpy(), exact_np)
    gb = 1e-9
    for name, t, m, extra in (
            ("exact", t_exact, m_exact, f"corpus f32 {N * D * 4 * gb:.2f} GB"),
            ("approx", t_approx, m_approx, f"ids equal exact's {ok_approx}"),
            ("int8", t_int8, m_int8,
             f"recall@10 against exact {r_int8:.4f}; corpus int8 "
             f"{(N * D + 4 * N) * gb:.2f} GB with scales, quantized on the "
             f"host in {t_quant:.1f} s")):
        log(f"retrieval {name} ({N} x {D}, Q={Q}, k={k}): {t * 1e3:.1f} ms, "
            f"{Q / t:.0f} queries/s, peak device memory above the corpus "
            f"{m * gb:.2f} GB; {extra}")
    del host
    ok_sharded = retrieval_sharded(
        corpus, codes, scales, queries,
        {"exact": (exact_s, exact, t_exact), "approx": (None, approx,
                                                        t_approx),
         "int8": (int8_s, int8, t_int8)})
    del corpus, codes, scales
    _free()

    # HNSW on the first rows, through the reference's file contract
    d = WORK / "retrieval_hnsw"
    d.mkdir(parents=True, exist_ok=True)
    _, want = MIPS.topk_mips(queries, base, k=k)
    formats.save_emb(base.cpu().numpy(), d / "embedding.fbin")
    formats.save_emb(np.arange(n, dtype=np.uint64).reshape(-1, 1),
                     d / "id.u64bin")
    formats.save_emb(queries.cpu().numpy(), d / "query.fbin")
    tool = ann.binary_path(build=True)
    ok_hnsw = tool is not None
    if ok_hnsw:
        from tencent_recommendation_2025_tpu_torch.config import \
            RetrievalConfig

        rc = RetrievalConfig()
        t0 = time.perf_counter()
        out = subprocess.run([
            str(tool), f"--dataset_vector_file_path={d / 'embedding.fbin'}",
            f"--dataset_id_file_path={d / 'id.u64bin'}",
            f"--query_vector_file_path={d / 'query.fbin'}",
            f"--result_id_file_path={d / 'id100.u64bin'}",
            f"--query_ann_top_k={k}", f"--faiss_M={rc.hnsw_m}",
            f"--faiss_ef_construction={rc.hnsw_ef_construction}",
            f"--query_ef_search={rc.hnsw_ef_search}",
            f"--faiss_metric_type={rc.metric_type}"],
            capture_output=True, text=True, check=True, timeout=300)
        wall = time.perf_counter() - t0
        build = float(out.stderr.split("build ")[-1].split("s")[0])
        got = np.asarray(formats.read_result_ids(d / "id100.u64bin"))
        r_hnsw = _ids_recall(got, want.cpu().numpy())
        log(f"retrieval hnsw ({n} x {D}, Q={Q}, k={k}, M={rc.hnsw_m}, "
            f"efC={rc.hnsw_ef_construction}, efS={rc.hnsw_ef_search}, "
            f"{os.cpu_count()} host cores): build {build:.2f} s, search and "
            f"file I/O {wall - build:.2f} s ({Q / (wall - build):.0f} "
            f"queries/s), recall@10 against exact on the same rows "
            f"{r_hnsw:.4f}")
    else:
        log("retrieval hnsw: the tool did not build FAIL")
    del base, queries
    _free()
    log(f"retrieval: mips_topk.launches {MIPS.mips_topk.launches - launches}"
        f" in this phase's own check, timings and tiers (not the main "
        f"paths'; the kernels line counts those)")
    ok = ok_kernel and ok_approx and ok_hnsw and ok_sharded
    log(f"retrieval tiers {'ok' if ok else 'FAIL'}")
    return ok, entry


#: corpus shards of phase 6b's sharded tiers (a local mesh on the card)
RETRIEVAL_SHARDS = 4
#: the pad-row case: rows (not a multiple of the shards), the planted top
#: rows on the last shard
PAD_ROWS = dict(N=1_000_001, top=10, seed=72)


def _near_ties(s1, i1, s2, i2, rel):
    """(places where the ids differ, whether every one of them holds two
    scores within ``rel`` of each other)."""
    import torch

    diff = i1 != i2
    close = (s1 - s2).abs() <= rel * torch.maximum(s1.abs(), s2.abs())
    return int(diff.sum()), bool((close | ~diff).all())


def pad_row_corpus(N, D, top, seed):
    """Every score negative, the true top ``top`` planted on the last shard:
    queries positive, rows -|x| - 1 elsewhere, and rows of the last shard's
    start -(j + 1) / 1000 * u (u a positive unit row, j = 0..top-1), which
    int8 quantizes exactly (one direction, scales apart by their factor).
    The last shard's zero pad rows score 0, above every real row."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    corpus = -(torch.rand((N, D), generator=gen, device="cuda") + 1.0)
    queries = torch.rand((64, D), generator=gen, device="cuda") + 0.1
    rows = -(-N // RETRIEVAL_SHARDS)
    u = torch.full((D,), 1.0 / D ** 0.5, device="cuda")
    at = (RETRIEVAL_SHARDS - 1) * rows + torch.arange(top, device="cuda")
    corpus[at] = -(torch.arange(top, device="cuda")[:, None] + 1.0) \
        / 1000.0 * u
    return corpus, queries, at


def retrieval_sharded(corpus, codes, scales, queries, single):
    """Phase 6b's sharded tiers: the 10M corpus row-sharded on a local mesh
    of RETRIEVAL_SHARDS corpus shards on the card (views of the corpus and
    of its int8 codes: no second copy), the same queries through
    ``sharded_topk_mips`` (exact, approx) and ``sharded_topk_mips_int8``:
    each tier's time (host clock, synchronised, after a warm-up on 100,000
    rows) and queries/s beside the single device's (``single``: tier ->
    (scores, ids, s)); exact ids equal to the single device's except at
    places whose two scores are within 1e-5 relative (counted); approx ids
    equal to sharded exact's; int8 recall@10 against the single device's
    int8 >= 0.999 and ids equal except at bf16 ties (2^-8 relative); then
    the pad-row case (:func:`pad_row_corpus`, PAD_ROWS) whose ids equal
    the single device's exact ids in all three tiers. Returns ok."""
    import torch

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh
    from tencent_recommendation_2025_tpu_torch.retrieval import mips as MIPS

    S, k = RETRIEVAL_SHARDS, RETRIEVAL["k"]
    N, Q = corpus.shape[0], queries.shape[0]
    mesh = local_mesh(MeshConfig(data=S))
    f32 = MIPS.shard_corpus(mesh, corpus, "cuda")
    i8 = MIPS.shard_corpus_int8(mesh, (codes, scales), "cuda")
    views = all(sh.data_ptr() == corpus[s * f32.rows:].data_ptr()
                for s, sh in enumerate(f32.shards))
    runs = {"exact": lambda c: MIPS.sharded_topk_mips(mesh, queries, c, k=k),
            "approx": lambda c: MIPS.sharded_topk_mips(mesh, queries, c,
                                                       k=k, approx=True),
            "int8": lambda c: MIPS.sharded_topk_mips_int8(mesh, queries, c,
                                                          k=k)}
    got, times = {}, {}
    for name, fn in runs.items():
        fn(MIPS.shard_corpus(mesh, corpus[:100_000], "cuda")
           if name != "int8" else MIPS.shard_corpus_int8(
               mesh, (codes[:100_000], scales[:100_000]), "cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[name] = fn(i8 if name == "int8" else f32)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    es, ei = got["exact"]
    n_ties, ok_exact = _near_ties(single["exact"][0], single["exact"][1], es,
                                  ei, 1e-5)
    ok_approx = torch.equal(got["approx"][1], ei)
    s8, i8_ids = got["int8"]
    r8 = _ids_recall(i8_ids.cpu().numpy(), single["int8"][1].cpu().numpy())
    n8, ties8 = _near_ties(single["int8"][0], single["int8"][1], s8, i8_ids,
                           2 ** -8)
    ok_int8 = r8 >= 0.999 and ties8
    for name in runs:
        t1, t = single[name][2], times[name]
        log(f"retrieval sharded {name} ({N} x {corpus.shape[1]} over {S} "
            f"corpus shards of {f32.rows} rows on one card, Q={Q}, k={k}): "
            f"{t * 1e3:.1f} ms, {Q / t:.0f} queries/s; single device "
            f"{t1 * 1e3:.1f} ms, {Q / t1:.0f} queries/s")
    log(f"retrieval sharded: shards are views of the corpus {views}; exact "
        f"ids against the single device's: {n_ties} places differ, every "
        f"one a near tie (two scores within 1e-5 relative) {ok_exact}; "
        f"approx ids equal sharded exact's {ok_approx}; int8 recall@10 "
        f"against the single device's int8 {r8:.6f} (limit 0.999), {n8} "
        f"places differ, every one a bf16 tie {ties8} "
        f"{'ok' if ok_exact and ok_approx and ok_int8 and views else 'FAIL'}")

    c = PAD_ROWS
    pc, pq, at = pad_row_corpus(N=c["N"], D=corpus.shape[1], top=c["top"],
                                seed=c["seed"])
    _, want = MIPS.topk_mips(pq, pc, k=k)
    pcodes, pscales = MIPS.quantize_corpus_int8(pc, "cuda")
    pad = {"exact": MIPS.sharded_topk_mips(mesh, pq, pc, k=k),
           "approx": MIPS.sharded_topk_mips(mesh, pq, pc, k=k, approx=True),
           "int8": MIPS.sharded_topk_mips_int8(mesh, pq, (pcodes, pscales),
                                               k=k)}
    planted = torch.equal(want, at[None, :].expand_as(want))
    ok_pad = planted and all(torch.equal(i, want) and float(s.max()) < 0
                             for s, i in pad.values())
    rows = -(-c["N"] // S)
    log(f"retrieval sharded pad rows: N={c['N']} over {S} shards of {rows} "
        f"rows ({S * rows - c['N']} zero pad rows on the last), every score "
        f"negative, the true top {k} planted on the last shard "
        f"({planted}): ids equal the single device's exact ids in "
        + ", ".join(f"{n} {torch.equal(i, want)}" for n, (_, i)
                    in pad.items())
        + f" {'ok' if ok_pad else 'FAIL'}")
    del f32, i8, pc, pcodes, pscales
    return ok_exact and ok_approx and ok_int8 and views and ok_pad


# ---------------------------------------------------------------------------
# phase 9: the 100M-row sparse step
# ---------------------------------------------------------------------------

#: benchmarks/sparse_table_bench.py --100m (l.23-46, 120-126): the JAX
#: package's north-star sparse step on one chip
SPARSE_100M = dict(itemnum=100_000_000, usernum=200, B=64, L=1024, D=64,
                   blocks=8, heads=1, feature_rows=200_000)


def synthetic_batch(rng, B, L, schema, itemnum, usernum):
    """The JAX package's synthetic train batch (``__graft_entry__.
    _make_batch`` without feature tables): a leading user token, item
    tokens of random ids in [1, itemnum), features drawn freely."""
    import numpy as np

    from tencent_recommendation_2025_tpu_torch.data import schema as S

    nis, nia = len(S.ITEM_SPARSE_IDS), len(S.ITEM_ARRAY_IDS)
    nus, nua = len(S.USER_SPARSE_IDS), len(S.USER_ARRAY_IDS)
    cap = schema.array_cap
    tt = np.ones((B, L), np.int32)
    tt[:, 0] = 2
    ntt = np.roll(tt, -1, axis=1)
    ntt[:, -1] = 0
    seq = rng.integers(1, itemnum, (B, L)).astype(np.int32)
    seq[:, 0] = rng.integers(1, usernum, B)
    pos = rng.integers(1, itemnum, (B, L)).astype(np.int32)
    return {
        "seq": seq, "pos": pos,
        "neg": rng.integers(1, itemnum, (B, L)).astype(np.int32),
        "token_type": tt, "next_token_type": ntt,
        "next_action_type": np.zeros((B, L), np.int32),
        "seq_item_sparse": rng.integers(0, 50, (B, L, nis)).astype(np.int32),
        "seq_item_array": np.zeros((B, L, nia, cap), np.int32),
        "seq_user_sparse": rng.integers(0, 50, (B, L, nus)).astype(np.int32),
        "seq_user_array": rng.integers(0, 50, (B, L, nua, cap)
                                       ).astype(np.int32),
        "pos_item_sparse": rng.integers(0, 50, (B, L, nis)).astype(np.int32),
        "pos_item_array": np.zeros((B, L, nia, cap), np.int32),
        "sample_valid": np.ones((B,), np.int32)}


def phase_sparse_100m():
    """The 100M-row sparse step on the card through the port's init_state
    (the table drawn on the card), augment_batch_sparse and
    make_train_step: one checked step (launch counts; every touched group,
    all its rows, equal to a plain row write of compute_row_update's rows
    from the same row gradients into a copy of it, and the touched
    accumulators to compute_row_update's, bitwise; a seeded sample of
    100,000 untouched rows bitwise unchanged), then its speed and a
    profiled step. Returns (ok, the launch counts over the phase's
    steps)."""
    import numpy as np
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
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    c = SPARSE_100M
    B, L, itemnum = c["B"], c["L"], c["itemnum"]
    cfg = Config(
        model=ModelConfig(hidden_units=c["D"], num_blocks=c["blocks"],
                          num_heads=c["heads"], maxlen=L - 1,
                          block_type="hstu", ffn_type="swiglu",
                          reference_init=False, dtype="bfloat16",
                          table_dtype="bfloat16"),
        train=TrainConfig(batch_size=B, loss_type="bce", l2_emb=0.0,
                          weight_decay=0.0, sparse_tables=("item_emb",),
                          table_optimizer="rowwise_adagrad",
                          table_moments_dtype="bfloat16"))
    vocab = {fid: 50 for fid in (*S.USER_SPARSE_IDS, *S.ITEM_SPARSE_IDS,
                                 *S.USER_ARRAY_IDS, *S.ITEM_ARRAY_IDS)}
    schema = FeatureSchema(vocab=vocab, mm_emb_ids=("81",), array_cap=8)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema),
                        usernum=c["usernum"], itemnum=itemnum)
    rng = np.random.default_rng(0)
    raw = synthetic_batch(rng, B, L, schema, itemnum, c["usernum"])
    # feature tables of 200,000 rows: larger ids clamp, as they clip there
    n = c["feature_rows"] + 1
    sparse_t = rng.integers(0, 50, (n, len(S.ITEM_SPARSE_IDS)))
    sparse_t[0] = 0
    tabs = {"sparse": torch.as_tensor(sparse_t.astype(np.int32),
                                      device="cuda"),
            "array": torch.zeros((n, len(S.ITEM_ARRAY_IDS), 8),
                                 dtype=torch.int32, device="cuda"),
            "mm": {"81": torch.as_tensor(rng.standard_normal(
                (n, MM_EMB_DIMS["81"])).astype(np.float32), device="cuda")}}
    t0 = time.perf_counter()
    batch = TR.augment_batch_sparse(raw, cfg, itemnum, (0, 1))
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = TR.init_state(model, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table = state.params["item_emb"]
    acc = state.tables["item_emb"]["acc"]
    Vp = table.shape[0]
    uids = batch["touched_uids"]
    n_real = int((uids < Vp).sum())
    real = torch.from_numpy(uids[:n_real]).long().cuda()
    cand = rng.integers(1, itemnum + 1, 130_000)
    cand = np.unique(cand[~np.isin(cand, uids)])
    sample = torch.from_numpy(rng.permutation(cand)[:100_000]).long().cuda()
    sample_before = table[sample].clone()
    # every touched group, whole: the kernel writes all R rows of each
    gview = ST.group_view(table, ST.scatter_group_rows(c["D"]))
    n_grp = int((batch["scatter_groups"] < gview.shape[0]).sum())
    grp = torch.from_numpy(batch["scatter_groups"][:n_grp]).long().cuda()
    uid_pos = torch.from_numpy(batch["scatter_uid_pos"][:n_real]).long().cuda()
    groups_before = gview[grp].clone()
    acc_before = acc[real].clone()
    # the starting state of phase 5e: the dense leaves as they are now
    params0 = {k: _tree_clone(v) for k, v in state.params.items()
               if k != "item_emb"}
    bd = TR.put_batch(batch, "cuda")
    step = TR.make_train_step(model, cfg)
    log(f"100m: itemnum {itemnum} ({Vp} rows, {tuple(table.shape)} "
        f"{table.dtype}, {table.numel() * 2 / 1e9:.1f} GB, drawn on the card "
        f"in {init_s:.1f} s), B={B}, L={L}, {c['blocks']} blocks, H="
        f"{c['heads']}, rowwise Adagrad, BCE; host prep {prep_s:.2f} s: "
        f"{n_real} touched rows in {len(batch['scatter_groups'])} group "
        f"slots")

    # the reference: the same row gradients (same step, same generator)
    # through compute_row_update
    _, _, per = TR.sparse_loss_backward(
        model, cfg, state, bd, tabs["mm"], tabs,
        TR.step_generator(cfg.train.seed, state.step, table.device))
    p = per["item_emb"]
    with torch.no_grad():
        want_rows, want_opt = ST.compute_row_update(
            table, state.tables["item_emb"], p["uids"], p["rows"].grad,
            kind="rowwise_adagrad", lr=TR.lr_at_step(cfg.train,
                                                     state.step + 1),
            step=state.step + 1, rows0=p["rows"].detach())
    want_acc = want_opt["acc"][:n_real]
    # the plain row write of those rows into a copy of the touched groups:
    # new rows at the touched slots, the old ones everywhere else
    want_groups = groups_before.clone().view(-1, c["D"]).index_copy_(
        0, uid_pos, want_rows[:n_real]).view(n_grp, -1)
    del per, p, want_rows
    reset_launches()
    state, m = step(state, bd, tabs["mm"], tabs)
    torch.cuda.synchronize()
    steps = 1
    got_groups = gview[grp]
    ok_rows = torch.equal(got_groups, want_groups)
    ok_acc = torch.equal(acc[real], want_acc)
    row_err = 0.0 if ok_rows else \
        (got_groups.float() - want_groups.float()).abs().max().item()
    ok_untouched = torch.equal(table[sample], sample_before)
    del want_groups, got_groups, want_acc
    touched = int(m["touched_rows"])
    loss = float(m["loss"])
    # phase 5e from the same state: the touched groups and accumulators
    # restored, the dense leaves of before the step; its launches read
    # apart from this phase's
    with torch.no_grad():
        gview[grp] = groups_before
        acc[real] = acc_before
    outer = read_launches()
    ok_sharded, sharded_launches, sharded_scatter = phase_sharded(
        model, cfg, raw, tabs, table, acc, params0, real, grp,
        groups_before, acc_before, sample, sample_before)
    set_launches(outer)
    del params0, groups_before, acc_before, sample_before
    # the peak of training, not of the check's copies
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, m = step(state, bd, tabs["mm"], tabs)
    torch.cuda.synchronize()
    n_timed = 5
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, m = step(state, bd, tabs["mm"], tabs)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_timed
    traced = 0

    def one_step():
        nonlocal state, m, traced
        state, m = step(state, bd, tabs["mm"], tabs)
        traced += 1

    prof, wall = route_trace("100m", one_step, ("attn_bwd", "fused"))
    steps += 2 + n_timed + traced
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    by_name = _device_ms(prof)
    busy = sum(by_name.values())
    scatter_ms, _ = _kernel_split(by_name, ("group_scatter_kernel",))
    fwd, _ = _kernel_split(by_name, KERNEL_NAMES["fused"][0])
    bwd, _ = _kernel_split(by_name, KERNEL_NAMES["fused"][1])
    chunks = -(-len(batch["scatter_groups"]) // ST._SCATTER_CHUNK_GROUPS)
    want = dict.fromkeys(launch_counters(), 0)
    want.update(fused_train=c["blocks"] * steps, fused_bwd=c["blocks"] * steps,
                group_scatter=chunks * steps)
    ok_launch = launches == want
    finite = bool(np.isfinite(loss) and np.isfinite(float(m["loss"])))
    gb = touched * c["D"] * 2 * 2 / 1e9
    fused_names = KERNEL_NAMES["fused"][0] + KERNEL_NAMES["fused"][1]
    others = ", ".join(f"{k[:50]} {v:.3f}" for k, v in by_name.most_common()
                       if not any(n in k for n in fused_names
                                  + ("group_scatter",)))[:700]
    log(f"100m: launches over {steps} steps: "
        + ", ".join(f"{k} {launches[k]} (expected {want[k]})"
                    for k in launches)
        + f" ({chunks} group-scatter chunks of "
        f"{ST._SCATTER_CHUNK_GROUPS} a step) {'ok' if ok_launch else 'FAIL'}")
    log(f"100m: checked step: loss {loss:.6f}; {n_grp} touched groups "
        f"({n_grp * gview.shape[1] // c['D']} rows) equal to a plain row "
        f"write of compute_row_update's {n_real} rows: {ok_rows} (max abs "
        f"diff {row_err:.3g}), accumulator {ok_acc}; 100,000 untouched rows "
        f"unchanged {ok_untouched}; losses finite {finite} "
        f"{'ok' if ok_rows and ok_acc and ok_untouched and finite else 'FAIL'}")
    log(f"100m: train step {dt * 1e3:.3f} ms, {B / dt:.1f} examples/s (host "
        f"clock, synchronised, {n_timed} steps after 3), touched rows "
        f"{touched}, lookup {gb / dt:.2f} GB/s ({touched} rows x {c['D']} x "
        f"2 bytes, gathered and written back), peak memory "
        f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated over the "
        f"{steps - 1} steps after the checked one); "
        f"profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"(idle {max(0.0, 1 - busy / wall):.1%}), group scatter "
        f"{scatter_ms:.3f} ms in {chunks} launches, fused forward "
        f"{fwd:.3f} ms, backward {bwd:.3f} ms; other kernels (ms): {others}")
    ok_route = attn_bwd_route("100m", by_name)
    ok_route &= wgmma_route("100m", by_name)
    log(f"sharded_100m: group scatter {sharded_scatter:.4f} device ms a "
        f"shard launch, beside the single device's {scatter_ms / chunks:.4f}"
        f" ms a launch ({scatter_ms:.3f} ms in {chunks} launches a step)")
    del state, table, gview, acc, bd, tabs
    _free()
    ok_static = phase_static_100m(raw)
    launches = {k: v + sharded_launches[k] for k, v in launches.items()}
    return (ok_rows and ok_acc and ok_untouched and ok_launch and finite
            and ok_route and ok_sharded and ok_static, launches)


#: phase 5e at full size: the static tables' rows (one per item and the
#: padding row 0) and their shards
STATIC_100M = dict(rows=100_000_001, shards=4, seed=73)


def phase_static_100m(raw):
    """Phase 5e's static tables at full size: the item ``sparse`` [V, 14]
    int32 and ``mm["81"]`` [V, 32] f32 tables of V = STATIC_100M rows (18.4
    GB, drawn on the card from a ``torch.Generator``), row-sharded over a
    local mesh of 4 table shards (``parallel.train.shard_tables``: the
    tables padded to 4 blocks, then the whole ones freed); their lookups
    of the 100M phase's history and candidate ids and of the edge ids
    against the whole tables' takes, computed before (:func:`step_ids`,
    :func:`static_lookup_checks`). Returns ok."""
    import torch

    from tencent_recommendation_2025_tpu_torch.config import (MM_EMB_DIMS,
                                                              MeshConfig)
    from tencent_recommendation_2025_tpu_torch.data import schema as S
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh

    t0 = time.perf_counter()
    c = STATIC_100M
    V = c["rows"]
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    tabs = {"sparse": torch.randint(0, 50, (V, len(S.ITEM_SPARSE_IDS)),
                                    generator=gen, dtype=torch.int32,
                                    device="cuda"),
            "mm": {"81": torch.randn((V, MM_EMB_DIMS["81"]), generator=gen,
                                     device="cuda")}}
    torch.cuda.synchronize()
    gb = (tabs["sparse"].numel() * 4 + tabs["mm"]["81"].numel() * 4) / 1e9
    ids = step_ids(raw, "cuda")
    ids["past"] = torch.tensor([V - 1, V, V + 7, 3 * V], device="cuda")
    # the whole tables' takes; then only the shards stay on the card
    wants = whole_takes(tabs, ids)
    stabs = PT.shard_tables(local_mesh(MeshConfig(data=c["shards"])), tabs)
    del tabs
    _free()
    held = torch.cuda.memory_allocated()
    ok = static_lookup_checks("static_100m", stabs, wants, ids)
    shard = sum(t.blocks[0].numel() * t.blocks[0].element_size()
                for _, t in _static_leaves(stabs))
    log(f"static_100m: sparse [{V}, 14] int32 and mm/81 [{V}, 32] f32 drawn "
        f"on the card ({gb:.2f} GB), row-sharded over {c['shards']} shards: "
        f"{shard / 1e9:.3f} GB a shard (both tables); device memory with "
        f"the shards {held / 1e9:.2f} GB; {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    del stabs, wants
    _free()
    return ok


def _tree_clone(t):
    """A copy of a parameter tree (tensors keep requires_grad)."""
    if isinstance(t, dict):
        return {k: _tree_clone(v) for k, v in t.items()}
    return t.detach().clone().requires_grad_(t.requires_grad)


# ---------------------------------------------------------------------------
# phase 5e: the 100M step on a local mesh of row-sharded table shards
# ---------------------------------------------------------------------------

#: data shards of phase 5e: the table's 4 row blocks, B / 4 = 16 rows a
#: fused launch
SHARDED_100M = 4
#: timed sharded steps (after 1)
SHARDED_STEPS = 3


def step_ids(raw, dev):
    """The ids a step's static lookups take, on ``dev``: the history's item
    ids (item tokens of ``seq``), the candidates (``neg``), and the edge
    ids 0, 1, 2**31 - 1 and -5."""
    import numpy as np
    import torch

    hist = np.where(raw["token_type"] == 1, raw["seq"], 0)
    edge = np.array([0, 1, 2 ** 31 - 1, -5], np.int64)
    return {k: torch.as_tensor(v, device=dev) for k, v in
            (("history", hist), ("candidates", raw["neg"]), ("edge", edge))}


def _static_leaves(tabs):
    """[(name, table)] of a static table tree's ``sparse`` and mm tables."""
    return [("sparse", tabs["sparse"])] + [(f"mm/{k}", t)
                                           for k, t in tabs["mm"].items()]


def whole_takes(tabs, id_sets):
    """{table: {id set: the whole table's take}} (``models.embedding.
    static_take``: ids clamped to the table's rows)."""
    from tencent_recommendation_2025_tpu_torch.models import embedding as E

    return {t: {n: E.static_take(w, ids) for n, ids in id_sets.items()}
            for t, w in _static_leaves(tabs)}


def static_lookup_checks(name, stabs, wants, id_sets):
    """Each row-sharded static table of ``stabs`` (``parallel.train.
    shard_tables``' tree) looked up at each id set of ``id_sets``: through
    ``models.embedding.static_take`` (on a local mesh one take of the
    padded table) and by a process mesh's rule (each shard's owned rows,
    zeros elsewhere, summed over the shards), both ``torch.equal`` to the
    whole table's take (``wants``: :func:`whole_takes`). Logs each table's
    shards and their bytes; returns ok."""
    import torch

    from tencent_recommendation_2025_tpu_torch.models import embedding as E
    from tencent_recommendation_2025_tpu_torch.parallel import \
        sharded_embedding as TSE

    ok, parts, shards = True, [], []
    for tname, st in _static_leaves(stabs):
        if not isinstance(st, TSE.StaticTable):
            ok = False
            parts.append(f"{tname} not sharded")
            continue
        blk = st.blocks[0]
        shards.append(f"{tname} {len(st.blocks)} x {tuple(blk.shape)} "
                      f"{blk.dtype} ({blk.numel() * blk.element_size() / 1e9:.3f}"
                      f" GB a shard; {st.rows} real rows)")
        for iname, ids in id_sets.items():
            want = wants[tname][iname]
            idx = ids.long().clamp(0, st.rows - 1)
            summed = sum(TSE.owned_rows(b, idx, s * st.rows_per_shard)
                         for s, b in enumerate(st.blocks))
            eq = torch.equal(E.static_take(st, ids), want) \
                and torch.equal(summed, want)
            ok &= eq
            parts.append(f"{tname}[{iname}] {eq}")
    log(f"{name}: static tables row-sharded: {'; '.join(shards)}")
    log(f"{name}: static lookups equal to the whole tables' takes "
        f"(torch.equal; the sharded take and the shards' owned rows "
        f"summed): {', '.join(parts)} {'ok' if ok else 'FAIL'}")
    return ok


def plain_group_writes(model, cfg, state, bd, stabs, mesh):
    """The reference of a sharded sparse step's write-back: the step's row
    gradients (its forward and backward from ``state``, step 0) through
    each table shard's plan and ``compute_row_update`` (rowwise Adagrad),
    written plainly into a copy of the shard's touched groups. Per shard
    (its touched group ids, their rows after the write, its real local
    rows, their accumulators after it)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        table_shards
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    table = state.params["item_emb"]
    acc = state.tables["item_emb"]["acc"]
    S, D = table_shards(mesh), table.shape[1]
    R = ST.scatter_group_rows(D)
    rps = table.shape[0] // S
    dev = table.device
    _, _, per = TR.sparse_loss_backward(
        model, cfg, state, dict(bd), stabs["mm"], stabs,
        TR.step_generator(cfg.train.seed, 0, dev), mesh=mesh,
        gens=TR.shard_gens(mesh, cfg.train.seed, 0, dev))
    p = per["item_emb"]
    plan = p["shard_plan"]
    blocks, accs = table.chunk(S), acc.chunk(S)
    want = []
    with torch.no_grad():
        zero = torch.zeros((1, D), dtype=torch.float32, device=dev)
        vals = torch.cat([p["rows"].grad.float(), zero])
        rows0 = torch.cat([p["rows"].detach().float(), zero])
        for s in range(S):
            lids, gpos = plan["lids"][s], plan["gpos"][s].long()
            n = int((lids < rps).sum())
            new_rows, opt_rows = ST.compute_row_update(
                blocks[s], {"acc": accs[s]}, lids, vals[gpos],
                kind="rowwise_adagrad", lr=TR.lr_at_step(cfg.train, 1),
                step=1, weight_decay=cfg.train.weight_decay,
                rows0=rows0[gpos])
            gv = ST.group_view(blocks[s], R)
            groups = plan["groups"][s]
            g = groups[:int((groups < gv.shape[0]).sum())].long()
            lid = lids[:n].long()
            pos = torch.searchsorted(g, lid // R) * R + lid % R
            want.append((g, gv[g].clone().view(-1, D).index_copy_(
                0, pos, new_rows[:n].to(table.dtype)).view(len(g), -1),
                lid, opt_rows["acc"][:n]))
    return want


def groups_written(want, table, acc) -> bool:
    """Whether each shard's touched groups of ``table`` (whole) and their
    accumulators are bitwise ``want``'s (:func:`plain_group_writes`)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST

    R = ST.scatter_group_rows(table.shape[1])
    S = len(want)
    return all(torch.equal(ST.group_view(b, R)[g], wg)
               and torch.equal(a[lid], wa)
               for b, a, (g, wg, lid, wa) in zip(table.chunk(S),
                                                  acc.chunk(S), want))


def phase_sharded(model, cfg, raw, tabs, table, acc, params0, real, grp,
                  groups_before, acc_before, sample, sample_before):
    """Phase 5e: the 100M phase's step on a local mesh of SHARDED_100M data
    shards, whose row-sharded item table is the 100M phase's own (its row
    blocks are the shards: no second table is drawn), from the state of
    that phase's checked step (``params0``: its dense leaves then; the
    touched groups ``grp`` and the touched rows' accumulators as
    ``groups_before`` and ``acc_before``, restored by the caller), with
    dropout off (a data shard draws its own masks):

    - the single device's step from that state, the touched groups and
      accumulators restored after it; then the mesh's checked step: its
      loss against the single device's (relative, limit 1e-4), the touched
      rows against the single device's (largest difference, lowest cosine,
      limit 0.999); each shard's touched groups,
      whole, and accumulators bitwise equal to a plain row write of
      ``compute_row_update``'s rows from the same step's row gradients
      (through the shard's plan) into a copy of them; the 100M phase's
      100,000 sampled untouched rows unchanged; launches: the fused kernels
      once per block and data shard, the group scatter once per shard and
      chunk, nothing else;
    - the host plan's ms (``host_shard_plan``), the step's ms (host clock,
      SHARDED_STEPS synchronised steps after 1) and one profiled step: the
      group scatter's device ms a shard launch, the fused kernels' at 16
      rows a launch, the idle share; the peak memory above the table.

    The phase's static item and mm tables (200,001 rows) row-shard over the
    same S shards (``parallel.train.shard_tables``) and every mesh step
    takes them so; their lookups of the step's history and candidate ids
    are held to the whole tables' (:func:`static_lookup_checks`).

    Returns (ok, the launch counts of its steps, the group scatter's device
    ms a shard launch)."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    t0 = time.perf_counter()
    S, c = SHARDED_100M, SPARSE_100M
    D, nb = c["D"], c["blocks"]
    R = ST.scatter_group_rows(D)
    Vp = table.shape[0]
    rps = Vp // S
    mesh = local_mesh(MeshConfig(data=S))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_rate=0.0))
    model = dataclasses.replace(model, cfg=cfg.model)

    def fresh():
        params = dict({k: _tree_clone(v) for k, v in params0.items()},
                      item_emb=table)
        return TR.TrainState(params, TR.make_optimizer(cfg, params), 0,
                             {"item_emb": {"acc": acc}})

    # the single device's step from the state, then the state restored
    one = TR.put_batch(TR.augment_batch_sparse(raw, cfg, model.itemnum,
                                               (0, 1)), table.device)
    _, m = TR.make_train_step(model, cfg)(fresh(), one, tabs["mm"], tabs)
    single_loss = float(m["loss"])
    single_rows = table[real].clone()
    gview = ST.group_view(table, R)
    with torch.no_grad():
        gview[grp] = groups_before
        acc[real] = acc_before
    del one, m
    t1 = time.perf_counter()
    batch = TR.augment_batch_sparse(raw, cfg, model.itemnum, (0, 1),
                                    n_table_shards=S)
    prep_s = time.perf_counter() - t1
    Kp = batch["tshard_lids"].shape[1]
    t1 = time.perf_counter()
    ST.host_shard_plan(batch["touched_uids"], Vp, R, S, Kp)
    plan_ms = (time.perf_counter() - t1) * 1e3
    state = PT.shard_existing_state(mesh, fresh())
    ok_same = state.params["item_emb"].data_ptr() == table.data_ptr()
    dev = table.device
    bd = TR.put_batch(batch, dev)
    # the static tables row-sharded over the same S shards (200,001 rows:
    # pad rows on the last shard; the batch's ids reach 1e8, past them)
    stabs = PT.shard_tables(mesh, tabs)
    ids = step_ids(raw, dev)
    ok_static = static_lookup_checks("sharded_100m", stabs,
                                     whole_takes(tabs, ids), ids)

    want = plain_group_writes(model, cfg, state, bd, stabs, mesh)
    blocks, accs = table.chunk(S), acc.chunk(S)
    step = TR.make_train_step(model, cfg, mesh)
    reset_launches()
    state, m = step(state, bd, stabs["mm"], stabs)
    torch.cuda.synchronize()
    got = read_launches()
    loss = float(m["loss"])
    ok_groups = groups_written(want, table, acc)
    n_grp = [len(g) for g, _, _, _ in want]
    del want
    ok_untouched = torch.equal(table[sample], sample_before)
    rows = table[real].float()
    ref = single_rows.float()
    row_err = (rows - ref).abs().max().item()
    live = ref.norm(dim=1) > 0       # the padding row 0 stays zero
    cos = torch.nn.functional.cosine_similarity(
        rows[live], ref[live], dim=1).min().item()
    rel = abs(loss - single_loss) / abs(single_loss)
    ok_num = rel <= 1e-4 and cos >= 0.999 and bool(np.isfinite(loss))
    chunks = -(-Kp // ST._SCATTER_CHUNK_GROUPS)
    want_l = dict.fromkeys(got, 0)
    want_l.update(fused_train=nb * S, fused_bwd=nb * S,
                  group_scatter=S * chunks)
    ok_launch = got == want_l
    log(f"sharded_100m: {S} data shards of {c['B'] // S} rows, the item "
        f"table's {S} row blocks of {rps} rows ({rps * D * 2 / 1e9:.2f} GB "
        f"each; the 100m phase's table itself: {ok_same}); host prep "
        f"{prep_s:.2f} s, of which host_shard_plan {plan_ms:.1f} ms ({Kp} "
        f"rows a shard; touched groups a shard "
        f"{', '.join(map(str, n_grp))})")
    log(f"sharded_100m: checked step: loss {loss:.6f} against the single "
        f"device's {single_loss:.6f} (relative {rel:.2e}, limit 1e-4); "
        f"{len(real)} touched rows against the single device's: largest "
        f"difference {row_err:.3g}, lowest cosine {cos:.6f} (limit 0.999) "
        f"{'ok' if ok_num else 'FAIL'}")
    log(f"sharded_100m: each shard's touched groups and accumulators equal "
        f"to a plain row write of compute_row_update's rows through its "
        f"plan: {ok_groups}; 100,000 untouched rows unchanged {ok_untouched}"
        f" {'ok' if ok_groups and ok_untouched and ok_same else 'FAIL'}")
    log(f"sharded_100m: launches of the checked step: "
        + ", ".join(f"{k} {got[k]} (expected {want_l[k]})" for k in got
                    if got[k] or want_l[k])
        + f" ({chunks} group-scatter chunks a shard; the single device "
        f"launches {-(-len(batch['touched_uids']) // ST._SCATTER_CHUNK_GROUPS)}"
        f" a step) {'ok' if ok_launch else 'FAIL'}")
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, bd, stabs["mm"], stabs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(SHARDED_STEPS):
        state, m = step(state, bd, stabs["mm"], stabs)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t1) / SHARDED_STEPS
    peak = torch.cuda.max_memory_allocated()
    traced = 0

    def one_step():
        nonlocal state, m, traced
        state, m = step(state, bd, stabs["mm"], stabs)
        traced += 1

    prof, wall = route_trace("sharded_100m", one_step, ("attn_bwd", "fused"))
    by_name = _device_ms(prof)
    busy = sum(by_name.values())
    scatter_ms, _ = _kernel_split(by_name, ("group_scatter_kernel",))
    fwd, bwd, _ = _fused_ms(by_name)
    steps = 1 + 1 + SHARDED_STEPS + traced
    launches = read_launches()
    ok_launch &= launches["group_scatter"] == S * chunks * steps
    ok_route = attn_bwd_route("sharded_100m", by_name)
    ok_route &= wgmma_route("sharded_100m", by_name)
    finite = bool(np.isfinite(float(m["loss"])))
    per_launch = scatter_ms / (S * chunks)
    log(f"sharded_100m: train step {dt * 1e3:.3f} ms ({c['B'] / dt:.1f} "
        f"examples/s; host clock, synchronised, {SHARDED_STEPS} steps after "
        f"1); profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"(idle {max(0.0, 1 - busy / wall):.1%}), group scatter "
        f"{scatter_ms:.3f} ms in {S * chunks} launches ({per_launch:.4f} ms "
        f"a shard launch), fused forward {fwd:.3f} ms, backward {bwd:.3f} ms"
        f" for {nb * S} launches each at {c['B'] // S} rows "
        f"({fwd / (nb * S):.4f} / {bwd / (nb * S):.4f} ms a launch); peak "
        f"memory {(peak - table.numel() * 2) / 2 ** 30:.2f} GiB above the "
        f"table's {table.numel() * 2 / 2 ** 30:.2f} GiB; losses finite "
        f"{finite}")
    del state, bd, blocks, accs
    _free()
    log(f"sharded_100m phase: {time.perf_counter() - t0:.1f} s")
    return (ok_num and ok_groups and ok_untouched and ok_same and ok_launch
            and ok_route and finite and ok_static, launches, per_launch)


# ---------------------------------------------------------------------------
# phase 6c: the sequence-parallel ring (hstu_flagship on a seq mesh)
# ---------------------------------------------------------------------------

RING_SHARDS = (2, 4)
#: TPU kernel lines of the ring's kernels (ops/fused_block.py)
_RING_REPLACES = {"ring_pair_fwd": "1269", "ring_pair_dq": "1304",
                  "ring_pair_dkdv": "1345", "ring_pre_fwd": "452",
                  "ring_post_fwd": "502", "ring_post_bwd": "612",
                  "ring_pre_bwd": "710"}
_RING_SOURCES = {"ring_pair_fwd": "ring_pair.cu",
                 "ring_pair_dq": "hstu_attn_bwd_sm90.cuh",
                 "ring_pair_dkdv": "hstu_attn_bwd_sm90.cuh",
                 "ring_pre_fwd": "fused_block.cu",
                 "ring_post_fwd": "fused_block.cu",
                 "ring_post_bwd": "fused_block_bwd.cu",
                 "ring_pre_bwd": "fused_block_bwd.cu"}


def ring_expected(blocks, S, steps):
    """Every counter's launches over ``steps`` training steps on a local
    mesh of S shards: per block and step, S pre and S post launches each
    way, and S (S + 1) / 2 pair launches of each pair kernel (the pairs
    wholly in the future launch nothing); every other counter 0."""
    want = dict.fromkeys(launch_counters(), 0)
    per = blocks * steps
    want.update(ring_pre_fwd=per * S, ring_post_fwd=per * S,
                ring_post_bwd=per * S, ring_pre_bwd=per * S,
                ring_pair_fwd=per * S * (S + 1) // 2,
                ring_pair_dq=per * S * (S + 1) // 2,
                ring_pair_dkdv=per * S * (S + 1) // 2)
    return want


def _pair_inputs(B, Lc, D, H, dtype, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(shape, s=0.5):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32)).to(dtype).cuda()

    q, k, v, dav = (t((B, Lc, D)) for _ in range(4))
    valid = torch.ones((B, Lc), dtype=torch.int32, device="cuda")
    valid[0, :Lc // 3 + 5] = 0
    if B > 1:
        valid[-1] = 0
    rab = t((H, 128), 0.1).float()
    return q, k, v, dav, valid, rab


def check_ring_pairs(B, Lc, D, H, off, dt, seed):
    """Rows 10-12 at one shape and offset against their plain versions on
    the card; a pair wholly in the future launches nothing and is 0."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    q, k, v, dav, valid, rab = _pair_inputs(B, Lc, D, H, dt, seed)
    before = read_launches()
    got = {"av": FB.ring_pair_fwd(q, k, v, valid, rab, off, H)}
    got["dq"], got["drab"] = FB.ring_pair_dq(q, k, v, dav, valid, rab, off, H)
    got["dk"], got["dv"] = FB.ring_pair_dkdv(q, k, v, dav, valid, rab, off,
                                             H)
    torch.cuda.synchronize()
    after = read_launches()
    n = int(off + Lc > 0)
    ok_count = {k_: after[k_] - before[k_] for k_ in after} == dict(
        dict.fromkeys(after, 0), ring_pair_fwd=n, ring_pair_dq=n,
        ring_pair_dkdv=n)
    want = {"av": FB.ring_pair_fwd_plain(q, k, v, valid, rab, off, H)}
    want["dq"], want["drab"] = FB.ring_pair_dq_plain(q, k, v, dav, valid, rab,
                                                     off, H)
    want["dk"], want["dv"] = FB.ring_pair_dkdv_plain(q, k, v, dav, valid,
                                                     rab, off, H)
    ok, worst, fails = ok_count, (None, 0.0), []
    blind = min(Lc, max(0, -off))   # query rows that see no key
    if n and blind:
        zero = got["av"][:, :blind].abs().max().item() == 0.0
        ok &= zero
        if not zero:
            fails.append(f"av rows 0..{blind - 1} (no visible key) not 0")
    for name in want:
        if n:   # the f32 partial is 0 on the fully padded row: held whole
            okg, eg, lim = compare_grad(got[name], want[name], dt)
        else:
            eg, lim = got[name].abs().max().item(), "exactly 0"
            okg = eg == 0.0 and not want[name].any()
        okg &= bool(torch.isfinite(got[name].float()).all())
        ok &= okg
        if eg >= worst[1]:
            worst = (name, eg)
        if not okg:
            fails.append(f"{name} {eg:.4g} ({lim})")
    log(f"ring pair B={B} Lc={Lc} D={D} H={H} hd={D // H} off={off} "
        f"{str(dt)[6:]}: launches {n} each {ok_count}"
        + (f"; rows 0..{blind - 1} see no key, exactly 0" if n and blind
           else "") + "; largest error "
        f"{worst[1]:.6g} ({worst[0]})"
        + (f", failing: {'; '.join(fails)}" if fails else "")
        + f" {'ok' if ok else 'FAIL'}")
    del q, k, v, dav, got, want
    _free()
    return ok


def check_ring_stages(B, Lc, D, H, F, dt, rate, seed):
    """The ring's pre and post stages and their backwards, each a launch of
    its own, against their plain versions on the card."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    x, ops, _ = block_inputs(B, Lc, D, H, F, 128, dt, seed)
    L = 2 * Lc
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(s=1.0):
        return (torch.randn(x.shape, generator=g, device="cuda") * s).to(dt)

    got, want = {}, {}
    for name, o in zip(("q", "k", "v", "u"), FB.ring_pre_fwd(x, ops, L, H)):
        got[f"pre {name}"] = o
    for name, o in zip(("q", "k", "v", "u"),
                       FB.ring_pre_fwd_plain(x, ops, L, H)):
        want[f"pre {name}"] = o
    u = want["pre u"]
    av, dout = rnd(0.05), rnd()
    got["post"] = FB.ring_post_fwd(x, av, u, ops, 77, rate)
    want["post"] = FB.ring_post_fwd_plain(x, av, u, ops, 77, rate)
    for out, fn in ((got, FB.ring_post_bwd), (want, FB.ring_post_bwd_plain)):
        for name, o in fn(x, av, dout, ops, 77, rate, L, H).items():
            out[f"post bwd {name}"] = o
    cots = [rnd() for _ in range(3)] + [rnd().float()]
    for out, fn in ((got, FB.ring_pre_bwd), (want, FB.ring_pre_bwd_plain)):
        for name, o in fn(x, ops, *cots, L, H).items():
            out[f"pre bwd {name}"] = o
    torch.cuda.synchronize()
    ok, worst, fails = True, (None, 0.0), []
    for name in want:
        cmp = compare if name == "post" else compare_grad
        okg, eg, lim = cmp(got[name], want[name], dt)
        okg &= bool(torch.isfinite(got[name].float()).all())
        ok &= okg
        if eg >= worst[1]:
            worst = (name, eg)
        if not okg:
            fails.append(f"{name} {eg:.4g} ({lim})")
    log(f"ring stages B={B} Lc={Lc} D={D} H={H} {str(dt)[6:]} p={rate}: "
        f"largest error {worst[1]:.6g} ({worst[0]})"
        + (f", failing: {'; '.join(fails)}" if fails else "")
        + f" {'ok' if ok else 'FAIL'}")
    del x, ops, got, want
    _free()
    return ok


def ring_bounds(B, Lc, D, H, F, pairs, elem):
    """(flops, bytes) of each ring kernel's call at a shard of Lc tokens:
    ``pairs`` the (query, key) pairs at distance >= 0 per row of the pair
    (this run's: Lc (Lc + 1) / 2 on the diagonal, Lc^2 behind it); each
    input read once, each output written once."""
    M, act = B * Lc, B * Lc * D * elem
    f32 = B * Lc * D * 4
    w_post = (D * D + D * 2 * F + F * D) * elem + (4 * D + D) * 4
    prod = 2 * B * D * pairs                # one [L, L] x D product
    return {
        "ring_pair_fwd": (2 * prod, 3 * act + B * Lc * 4 + H * 128 * 4 + f32),
        "ring_pair_dq": (3 * prod, 4 * act + B * Lc * 4 + 2 * H * 128 * 4
                         + f32),
        "ring_pair_dkdv": (4 * prod, 4 * act + B * Lc * 4 + H * 128 * 4
                           + 2 * f32),
        "ring_pre_fwd": pre_bounds(B, Lc, D, elem, ring=True)["fwd"],
        "ring_post_fwd": (2 * M * (D * D + D * 2 * F + F * D),
                          2 * act + f32 + w_post + act),
        # the single device's gate/FFN backward, on the shard
        "ring_post_bwd": gate_ffn_bwd_bound(B, Lc, D, H, F, elem),
        "ring_pre_bwd": pre_bounds(B, Lc, D, elem, ring=True)["bwd"]}


def phase_ring_times(B, Lc, D, H, F, libs):
    """At the S = 2 main path's shard (bf16): each ring kernel held to its
    plain version (a pair kernel at off 0, the diagonal with its causal
    mask, and at off Lc) and timed (CUDA events) beside it and its bound; a
    pair kernel's time is the mean over one block's pairs at S = 2 (two on
    the diagonal, off 0, and one behind it, off Lc), its bound the same
    mean. The pair forward also by its kernel's device time (the profiler)
    and beside its first design, pair_fwd_kernel (the copy of ring_pair.cu
    in ``libs``), by both clocks. Returns (ok, the JSON entries without
    launches)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    bf16 = torch.bfloat16
    q, k, v, dav, valid, rab = _pair_inputs(B, Lc, D, H, bf16, 61)
    x, ops, _ = block_inputs(B, Lc, D, H, F, 128, bf16, 62)
    L = 2 * Lc
    u = FB.ring_pre_fwd(x, ops, L, H)[3]
    dout = dav
    cots = (q, k, v, u)
    kern = {
        "ring_pair_fwd": lambda o: FB.ring_pair_fwd(q, k, v, valid, rab, o, H),
        "ring_pair_dq": lambda o: FB.ring_pair_dq(q, k, v, dav, valid, rab, o,
                                                  H),
        "ring_pair_dkdv": lambda o: FB.ring_pair_dkdv(q, k, v, dav, valid,
                                                      rab, o, H),
        "ring_pre_fwd": lambda o: FB.ring_pre_fwd(x, ops, L, H),
        "ring_post_fwd": lambda o: FB.ring_post_fwd(x, dav, u, ops, 5, 0.01),
        "ring_post_bwd": lambda o: FB.ring_post_bwd(x, dav, dout, ops, 5,
                                                    0.01, L, H),
        "ring_pre_bwd": lambda o: FB.ring_pre_bwd(x, ops, *cots, L, H)}
    plain = {
        "ring_pair_fwd": lambda o: FB.ring_pair_fwd_plain(q, k, v, valid, rab,
                                                          o, H),
        "ring_pair_dq": lambda o: FB.ring_pair_dq_plain(q, k, v, dav, valid,
                                                        rab, o, H),
        "ring_pair_dkdv": lambda o: FB.ring_pair_dkdv_plain(
            q, k, v, dav, valid, rab, o, H),
        "ring_pre_fwd": lambda o: FB.ring_pre_fwd_plain(x, ops, L, H),
        "ring_post_fwd": lambda o: FB.ring_post_fwd_plain(x, dav, u, ops, 5,
                                                          0.01),
        "ring_post_bwd": lambda o: FB.ring_post_bwd_plain(x, dav, dout, ops,
                                                          5, 0.01, L, H),
        "ring_pre_bwd": lambda o: FB.ring_pre_bwd_plain(x, ops, *cots, L, H)}

    def held(name, got, want):
        """(every output finite and within its tolerance, the largest
        error, the limits' text)."""
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        if isinstance(got[0], dict):
            got, want = tuple(got[0].values()), tuple(want[0][k]
                                                      for k in got[0])
        cmp = compare if name == "ring_post_fwd" else compare_grad
        res = [cmp(g, w, bf16) for g, w in zip(got, want)]
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        return (finite and all(r[0] for r in res), max(r[1] for r in res),
                "; ".join(r[2] for r in res))

    ok, entries = True, []
    for name in kern:
        offs = (0, 0, Lc) if "pair" in name else (0,)
        err = 0.0
        for o in sorted(set(offs)):
            ok_o, e_o, lim = held(name, kern[name](o), plain[name](o))
            torch.cuda.synchronize()
            _free()
            err = max(err, e_o)
            ok &= ok_o
            if not ok_o:
                log(f"{name} (B={B} Lc={Lc} D={D} H={H}, bf16, off {o}) "
                    f"against its plain version: max abs err {e_o:.4g} "
                    f"({lim}) FAIL")
        t = sum(time_ms(lambda: kern[name](o), 2, 10) for o in offs) \
            / len(offs)
        extra = ""
        if name == "ring_pair_fwd":
            # a call launches the one kernel: its device time by the
            # profiler and by a held queue, each the mean over the offsets
            def mean(f):
                return sum(f(lambda: kern[name](o)) for o in offs) / len(offs)

            def device(kname):
                return (mean(lambda fn: kernel_device_ms(fn, (kname,))),
                        mean(queued_ms))

            dev, queued = device(PAIR_FWD[0])
            with first_design(libs):
                old = mean(lambda fn: time_ms(fn, 2, 10))
                old_dev, old_queued = device(PAIR_FWD[1])
            extra = (f"; {PAIR_FWD[0]} device {dev:.4f} ms (profiler), "
                     f"{queued:.4f} ms (CUDA events, queue held full); "
                     f"first design {PAIR_FWD[1]} {old:.4f} ms (device "
                     f"{old_dev:.4f}, queue held {old_queued:.4f} ms)")
        _free()
        tp = sum(time_ms(lambda: plain[name](o), 1, 2) for o in offs) \
            / len(offs)
        _free()
        fl, nb = 0.0, 0.0
        for o in offs:
            pairs = Lc * (Lc + 1) // 2 if o == 0 else Lc * Lc
            f_, b_ = ring_bounds(B, Lc, D, H, F, pairs, 2)[name]
            fl, nb = fl + f_ / len(offs), nb + b_ / len(offs)
        bound, by, _, _ = _bound(fl, nb)
        log(f"{name} (B={B} Lc={Lc} D={D} H={H}, bf16"
            + (", mean of offsets 0, 0, Lc" if len(offs) > 1 else "")
            + f"): kernel {t:.4f} ms, plain {tp:.4f} ms, bound {bound:.4f} "
            f"ms ({by}: {fl / 1e9:.3f} GFLOP, {nb / 1e6:.2f} MB); kernel at "
            f"{fl / t / 1e9:.1f} TFLOP/s; max abs err against the plain "
            f"version {err:.4g}" + (" (offsets 0 and Lc)" if len(offs) > 1
                                     else "") + extra)
        entries.append({"name": name, "route": "cuda",
                        "source": SRC + _RING_SOURCES[name],
                        "replaces": f"{TPU}:{_RING_REPLACES[name]}",
                        "launches": None, "max_abs_err": err, "ms": t,
                        "plain_ms": tp, "bound_ms": bound, "bound_by": by,
                        "library_ms": None})
    del q, k, v, dav, x, ops, u
    _free()
    return ok, entries


def _ring_world(run, ckpt, rows=None, dropout=True, blocks=None):
    """The long run's model, tables, trained parameters and first two train
    batches (cut to ``rows``), for the ring's steps; ``blocks``: the model
    cut to its first ``blocks`` blocks."""
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    data = TencentGRData(run.data_dir, mm_emb_ids=("81",))
    cfg, schema, raw = _train_batches(data, 2, run, rows=rows)
    if not dropout:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    dropout_rate=0.0))
    if blocks is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    num_blocks=blocks))
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)

    def model_in(dtype):
        mc = dataclasses.replace(cfg.model, dtype=dtype)
        return (SeqRecModel(cfg=mc, schema=schema,
                            fused=FusedVocab.build(schema),
                            usernum=data.usernum, itemnum=data.itemnum),
                cfg.replace(model=mc))

    params, _ = CK.load_params(ckpt)
    if blocks is not None:       # blocks are stacked on a leading axis
        params["blocks"] = _tree_map(lambda t: t[:blocks], params["blocks"])
    return model_in, tables, params, raw


def _tree_map(fn, t):
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    return fn(t)


#: depth of the ring's one-step check: the long model's first 2 of its 8
#: blocks (its CPU reference took 71 s of an 866 s run at 8; the check 34 s
#: of a 797 s run at 4, once phase 5f was added)
RING_CHECK_BLOCKS = 2


def phase_ring_one_step(run, ckpt):
    """One step (loss and every gradient, dropout off) of the long model cut
    to RING_CHECK_BLOCKS blocks on the first 8 rows of the long run's first
    batch, on a local mesh of S = 2 and 4 shards on the card, held (a) to the single-device chunked fused
    step on the card: in f32 (cosine >= 0.999), and in bf16 to the
    single-device f32 step by the drift rule, c the single-device bf16
    step's own cosine (the ring's rounding points differ from the single
    device's, so the two bf16 steps are held through f32, not to each
    other); (b) to the CPU's plain ring, in bf16 (cosine >= 0.999) and in
    f32 (the drift rule). The CPU's plain ring runs once per dtype, at S =
    4 (the cheaper of the two on the CPU), and both card rings are held to
    it. Each card step's launches are held to their expected counts."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh

    model_in, tables, params, raw = _ring_world(run, ckpt, rows=8,
                                                dropout=False,
                                                blocks=RING_CHECK_BLOCKS)
    batch = raw[0]
    m16, c16 = model_in("bfloat16")
    m32, c32 = model_in("float32")
    blocks = c16.model.num_blocks

    def cos(a, b):
        na, nb = a.norm().item(), b.norm().item()
        if na == 0.0 and nb == 0.0:
            return 1.0
        return float(torch.dot(a.flatten(), b.flatten()) / (na * nb))

    def held(name, got, want, floor_of=None):
        """Every leaf's cosine to ``want`` at 0.999 or ``floor_of(leaf)``."""
        worst, fails = (None, 2.0, 0.999), []
        for leaf in want:
            c = cos(got[leaf], want[leaf])
            floor = 0.999 if floor_of is None else floor_of(leaf)
            if c < worst[1]:
                worst = (leaf, c, floor)
            if c < floor:
                fails.append(f"{leaf} ({c:.6f} < {floor:.6f})")
        log(f"ring one step, {name}: lowest gradient cosine {worst[1]:.6f} "
            f"({worst[0]}, limit {worst[2]:.6f}); failing: "
            f"{fails or 'none'} {'FAIL' if fails else 'ok'}")
        return not fails

    def drift(ref16, ref32):
        return lambda leaf: float(drift_limit(cos(ref16[leaf],
                                                  ref32[leaf])))

    def loss_ok(name, got, want, rel):
        ok_ = abs(got - want) <= rel * abs(want) and np.isfinite(got)
        log(f"ring one step, {name}: loss {got:.6f} against {want:.6f} "
            f"(limit {rel:g} relative) {'ok' if ok_ else 'FAIL'}")
        return ok_

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    reset_launches()
    l_one16, g_one16 = _loss_and_grads(m16, c16, params, batch, tables,
                                       "cuda")
    l_one32, g_one32 = _loss_and_grads(m32, c32, params, batch, tables,
                                       "cuda")
    ok = check_launches(run, "ring reference (single-device chunked, bf16 "
                        "and f32) steps", read_launches(),
                        expected_launches("fused", blocks, 2, 0))
    t1 = time.perf_counter()
    S_cpu = RING_SHARDS[-1]
    cpu_mesh = local_mesh(MeshConfig(seq=S_cpu))
    p16, q16 = _loss_and_grads(m16, c16, params, batch, tables, "cpu",
                               route="ring_fused", mesh=cpu_mesh)
    p32, q32 = _loss_and_grads(m32, c32, params, batch, tables, "cpu",
                               route="ring_fused", mesh=cpu_mesh)
    cpu_s = time.perf_counter() - t1
    for S in RING_SHARDS:
        mesh = local_mesh(MeshConfig(seq=S))
        reset_launches()
        l16, g16 = _loss_and_grads(m16, c16, params, batch, tables, "cuda",
                                   mesh=mesh)
        l32, g32 = _loss_and_grads(m32, c32, params, batch, tables, "cuda",
                                   mesh=mesh)
        ok &= check_launches(run, f"ring S={S} steps (bf16 and f32)",
                             read_launches(), ring_expected(blocks, S, 2))
        ok &= loss_ok(f"S={S} card ring f32 vs card single-device f32",
                      l32, l_one32, 1e-5)
        ok &= loss_ok(f"S={S} card ring bf16 vs card single-device bf16",
                      l16, l_one16, 1e-3)
        ok &= held(f"S={S} card ring f32 vs card single-device f32", g32,
                   g_one32)
        ok &= held(f"S={S} card ring bf16 vs card single-device f32 "
                   f"({DRIFT_RULE}, of the single-device bf16 step)", g16,
                   g_one32, drift(g_one16, g_one32))
        cpu = f"CPU plain ring S={S_cpu}"
        ok &= loss_ok(f"S={S} card ring bf16 vs {cpu} bf16 ({cpu} f32 "
                      f"{p32:.6f}; the CPU's two steps {cpu_s:.1f} s)", l16,
                      p16, 1e-3)
        ok &= held(f"S={S} card ring vs {cpu} bf16", g16, q16)
        ok &= held(f"S={S} card ring vs {cpu} f32 ({DRIFT_RULE})", g16, q32,
                   drift(q16, q32))
    log(f"ring one-step checks (8 rows, L=4096, {blocks} blocks): "
        f"{time.perf_counter() - t0:.1f} s")
    return ok


def phase_ring_speed(run, ckpt, S=2):
    """Train step ms and tokens/s on a local mesh of S shards (the long
    run's B = 32, L = 4096, bf16, dropout as the preset): 6 synchronised
    steps after 2, the counters set to 0 before the 8 and held after; then
    one step's profile, which must name the attention backward's wgmma
    kernels. Returns (ok, launches)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    model_in, tables, params, raw = _ring_world(run, ckpt)
    model, cfg = model_in("bfloat16")
    mesh = local_mesh(MeshConfig(seq=S))
    batches = [TR.put_batch(b, "cuda") for b in raw]
    state = TR.init_state(model, cfg, params=params, device="cuda")
    tabs = TR.device_tables(tables, "cuda")
    step = TR.make_train_step(model, cfg, mesh)
    reset_launches()
    for b in batches[:2]:
        state, m = step(state, b, tabs["mm"], tabs)
    torch.cuda.synchronize()
    n = 6
    t0 = time.perf_counter()
    for i in range(n):
        state, m = step(state, batches[i % 2], tabs["mm"], tabs)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    launches = read_launches()
    ok = check_launches(run, f"ring S={S} speed run (8 steps)", launches,
                        ring_expected(cfg.model.num_blocks, S, n + 2))
    ok &= bool(torch.isfinite(m["loss"]).item())
    B, L = cfg.train.batch_size, cfg.model.maxlen + 1
    log(f"ring S={S}: train step (B={B}, L={L}, shards of {L // S}, bf16, "
        f"dropout {cfg.model.dropout_rate}): {dt * 1e3:.3f} ms, "
        f"{B / dt:.1f} examples/s, {B * L / dt:.0f} tokens/s (host clock, "
        f"synchronised, {n} steps after 2 warm-up); loss "
        f"{float(m['loss']):.4f}")
    pairs = cfg.model.num_blocks * S * (S + 1) // 2

    def one_step():
        nonlocal state, m
        state, m = step(state, batches[0], tabs["mm"], tabs)

    prof, wall = route_trace(
        f"ring S={S}", one_step, ("attn_bwd", "fused"),
        launches_ok=lambda c: pair_fwd_launches(c) == (pairs, 0))
    by_name = _device_ms(prof)
    busy = sum(by_name.values())
    fwd_names, bwd_names = KERNEL_NAMES["ring"]
    fwd, fsplit = _kernel_split(by_name, fwd_names)
    bwd, split = _kernel_split(by_name, bwd_names)
    others = ", ".join(f"{k[:60]} {v:.3f}" for k, v in by_name.most_common()
                       if not any(n_ in k for n_ in fwd_names + bwd_names)
                       )[:900]
    host_top(f"ring S={S}", prof, wall)
    log(f"ring S={S}: train step profile: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms (idle {max(0.0, 1 - busy / wall):.1%}); forward "
        f"kernels {fwd:.3f} ms ({fsplit}), backward kernels {bwd:.3f} ms "
        f"({split}); other kernels (ms): {others}")
    ok &= attn_bwd_route(f"ring S={S}", by_name)
    ok &= wgmma_route(f"ring S={S}", by_name)
    ok &= pair_fwd_route(f"ring S={S}", by_name, _kernel_launches(prof),
                         pairs)
    return ok, launches


def pair_fwd_launches(counts):
    """(launches of pair_fwd_wgmma_kernel, of pair_fwd_kernel) in a
    profile's launches by kernel name."""
    return tuple(sum(v for k, v in counts.items() if n in k)
                 for n in PAIR_FWD)


def pair_fwd_route(name, by_name, counts, want):
    """Whether a profiled bf16 ring step launched pair_fwd_wgmma_kernel
    ``want`` times (S (S + 1) / 2 per block), with device time, and its
    first design pair_fwd_kernel never; logs both."""
    n_new, n_old = pair_fwd_launches(counts)
    ms = sum(v for k, v in by_name.items() if PAIR_FWD[0] in k)
    ok = n_new == want and n_old == 0 and ms > 0
    log(f"{name}: the pair forward in the profiled step: {PAIR_FWD[0]} "
        f"{n_new} launches (want {want}), {ms:.3f} device ms; {PAIR_FWD[1]} "
        f"{n_old} launches {'ok' if ok else 'FAIL'}")
    return ok


def phase_ring(ckpt, libs):
    """The ring's kernels against their plain versions (rows 10-12 at Lc =
    1024 and 2048, offsets 0, +Lc, -Lc, +3 Lc, Lc / 2 + 16 and -Lc / 2 -
    16, H = 1, 4 and 8 (hd 8), f32 and bf16; the stages at B = 4, Lc =
    2048), each held again and timed at the main path's shard (B = 32, Lc =
    2048; the pair forward beside its first design, a copy in ``libs``),
    the one-step checks at S = 2 and 4 and the S = 2 step's speed, on the
    long run's fixture and checkpoint. Returns (ok, JSON entries)."""
    import torch

    t0 = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    ok = True
    i = 0
    for Lc in (1024, 2048):
        for H in (1, 4, 8):
            # the same shard, a past one, a future one (no launch), a far
            # past one, and offsets off the 64-row tiles either way (the
            # negative one leaves the first rows without a visible key)
            for off in (0, Lc, -Lc, 3 * Lc, Lc // 2 + 16, -(Lc // 2) - 16):
                for dt in (f32, bf16):
                    ok &= check_ring_pairs(2, Lc, 64, H, off, dt, 70 + i)
                    i += 1
    ok &= check_ring_stages(4, 2048, 64, 1, 256, f32, 0.5, 95)
    ok &= check_ring_stages(4, 2048, 64, 1, 256, bf16, 0.01, 96)
    log(f"ring kernel checks: {time.perf_counter() - t0:.1f} s")
    ok_t, entries = phase_ring_times(LONG["B"], LONG["L"] // 2, LONG["D"],
                                     LONG["H"], LONG["F"], libs)
    ok &= ok_t
    ok &= phase_ring_one_step(LONG_RUN, ckpt)
    ok_s, launches = phase_ring_speed(LONG_RUN, ckpt)
    for e in entries:
        e["launches"] = launches[e["name"]]
    log(f"ring phase: {time.perf_counter() - t0:.1f} s")
    return ok and ok_s, entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    first = start_first_design_builds()
    report = kernels.build_all()
    libs = first_design_libs(first)
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(sorted(report)) or 'already built'}; and the first "
        f"design's copies of {', '.join(sorted(libs))})")
    for name, r in report.items():   # -Xptxas -v: registers and spills
        log(f"  {name}: " + "; ".join(
            f"{k['kernel']} {k['registers']} registers, spills "
            f"{k['spill_stores']}/{k['spill_loads']} B"
            for k in kernels.ptxas_report(r["log"])))

    oks = {"attn_bwd_spills": attn_bwd_spills(report),
           "post_spills": post_spills(report),
           "pre_spills": pre_spills(report),
           "pair_fwd_spills": fwd_spills(report, "ring_pair", PAIR_FWD[0]),
           "hstu_fwd_spills": fwd_spills(report, "hstu_attention",
                                         HSTU_WGMMA[0], variants=2)}
    t0 = time.perf_counter()
    oks["kernels"] = phase_kernels()
    oks["times"], entries = phase_times(FLAGSHIP)
    oks["times_chunked"], chunked = phase_times(LONG)
    entries += chunked
    oks["attn_bwd"], attn_bwd = phase_attn_bwd()
    oks["post"], post = phase_post()
    oks["pre"], pre = phase_pre(libs)
    oks["attention_kernels"] = phase_attention_kernels()
    oks["attention_times"], attention = phase_attention_times(libs)
    oks["digests"] = phase_digests()
    oks["silu"], silu_entries = phase_silu()
    oks["group_kernels"], group_entries = phase_group_kernels(libs)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    def attach_post(run, trained, served):
        """This run's launches into the post-half, gate/FFN and pre-half
        entries: the inference instance per forward without autograd, the
        training one per training forward, the gate per backward; the
        projection per forward of either kind, its backward per
        backward."""
        for entry, n in zip(post.get(run.name, ()), (
                trained["fused_fwd"] + served["fused_fwd"],
                trained["fused_train"], trained["fused_bwd"])):
            entry["launches"] = n
        for entry, n in zip(pre.get(run.name, ()), (
                trained["fused_fwd"] + served["fused_fwd"]
                + trained["fused_train"], trained["fused_bwd"])):
            entry["launches"] = n

    extra = {}   # launches of phase 5c's cli.train run, by the run it adds to
    # the exact tier's scans on the main paths: cli.train's retrieval eval,
    # cli.infer's exact top k and cli.semantic's exact-MIPS hit rate
    scans = []

    def run_path(run):
        """phase_run, its scans kept."""
        trained, served = phase_run(run, oks)
        scans.append(trained["mips_topk"] + served["mips_topk"])
        return trained, served

    def attach(run, trained, served):
        """This run's launches into its attention kernels' JSON entries."""
        more = extra.get(run.name, {})
        for name, entry in attention:
            if name == run.name:   # this run's forward or backward kernel
                way = "bwd" if "_bwd_" in entry["name"] else "fwd"
                key = f"{run.kernels}_{way}"
                entry["launches"] = trained[key] + served[key] \
                    + more.get(key, 0)

    # the fused JSON entries in order: fwd, fwd_train, bwd of each variant
    for run, found in ((FLAGSHIP_RUN, entries[:3]), (LONG_RUN, entries[3:])):
        trained, served = run_path(run)
        if run is FLAGSHIP_RUN:   # the generative tier on its checkpoint
            oks["semantic"], sem = phase_semantic(run)
            served = {k: v + sem[k] for k, v in served.items()}
            scans.append(sem["mips_topk"])
            # the training options on its fixture and checkpoint
            from tencent_recommendation_2025_tpu_torch.data.readers import \
                TencentGRData
            from tencent_recommendation_2025_tpu_torch.train import \
                checkpoint as CK

            oks["train_options"], opt, extra[PARITY_RUNS[3].name] = \
                phase_train_options(
                    run, TencentGRData(run.data_dir, mm_emb_ids=("81",)),
                    CK.latest_checkpoint(run.work / "model"))
            # data parallelism on a local mesh: its launches add to the
            # whole-sequence kernels' entries, as phase 5c's
            oks["dp"], dp = phase_dp()
            trained = {k: v + opt[k] + dp[k] for k, v in trained.items()}
            # tensor parallelism on a local mesh: its standalone HSTU
            # attention launches add to that kernel's entries (hstu_mini's
            # run), its group scatters to the group entries
            oks["tp"], tp = phase_tp()
            extra["hstu_mini"] = {k: tp[k] for k in ("hstu_fwd",
                                                     "hstu_bwd")}
            # pipeline parallelism on a local mesh: its fused launches add
            # to the whole-sequence kernels' entries, its group scatters to
            # the group entries
            oks["pp"], pp = phase_pp()
            trained = {k: v + pp[k] for k, v in trained.items()}
        for entry, n in zip(found, (served["fused_fwd"],
                                    trained["fused_train"],
                                    trained["fused_bwd"])):
            entry["launches"] = n
        for entry in attn_bwd[run.name]:   # one of each per fused backward
            entry["launches"] = trained["fused_bwd"]
        attach_post(run, trained, served)
    # the ring on the long run's fixture and checkpoint
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    oks["ring"], ring_entries = phase_ring(
        CK.latest_checkpoint(LONG_RUN.work / "model"), libs)
    attach(MINI_LONG_RUN, *run_path(MINI_LONG_RUN))
    # the long window's python pack is still in PACKS: the native one
    # against it, before the runs that follow replace it
    oks["native_pack"] = phase_native_pack(LONG_RUN)
    t0 = time.perf_counter()
    oks["mini_long_ann"] = phase_ann_methods(MINI_LONG_RUN)
    oks["retrieval"], mips_entry = phase_retrieval(report)
    log(f"retrieval phase: {time.perf_counter() - t0:.1f} s")
    # the head-dim runs after the runs of the same window (the pack reused)
    for run in PARITY_RUNS[:3]:
        attach(run, *run_path(run))
    for run in HEAD_DIM_RUNS:
        t0 = time.perf_counter()
        oks[f"{run.name}_train"], trained, _, _ = phase_training(run)
        attach(run, trained, dict.fromkeys(trained, 0))
        log(f"{run.name} training phase: {time.perf_counter() - t0:.1f} s")
    for run in PARITY_RUNS[3:]:
        attach(run, *run_path(run))
    entries += [entry for _, entry in attention] + silu_entries
    # sharded_multihost's table is below packed scale: no group scatter
    for run in (SPARSE_RUN, SOFTMAX_DP_RUN):
        trained, served = run_path(run)
        for entry in attn_bwd.get(run.name, ()):
            entry["launches"] = trained["fused_bwd"]
        attach_post(run, trained, served)
    t0 = time.perf_counter()
    oks["sparse_100m"], launches = phase_sparse_100m()
    log(f"100m phase: {time.perf_counter() - t0:.1f} s")
    for entry in group_entries:
        entry["launches"] = launches[entry["name"]] + tp[entry["name"]] \
            + pp[entry["name"]]
    entries += [e for es in attn_bwd.values() for e in es]
    entries += [e for es in post.values() for e in es]
    entries += [e for es in pre.values() for e in es]
    mips_entry["launches"] = sum(scans)
    entries += group_entries + ring_entries + [mips_entry]
    log(f"chip_smoke: {time.perf_counter() - START:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": entries}))
    failed = [k for k, v in oks.items() if not v]
    if failed:
        log(f"chip_smoke: FAILED ({', '.join(failed)})")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
