"""Configuration tree for the engine.

The reference configures itself with argparse flags plus seven environment
variables (reference ``model/BaseLine/main.py:17-48,52-57`` and
``infer.py:15,103,142,211``).  We keep that outer contract (see ``cli/``) but
the internal source of truth is a frozen dataclass tree with named presets
matching the five BASELINE.json configs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

# Multimodal content-embedding dims, fixed by the TencentGR data release
# (reference model/BaseLine/model.py:183 EMB_SHAPE_DICT).
MM_EMB_DIMS = {"81": 32, "82": 1024, "83": 3584, "84": 4096, "85": 3584, "86": 3584}

# Static cap on user tokens per sequence row. The TencentGR layout carries
# the user profile as ONE record per sequence (reference dataset.py:115-121
# inserts one type-2 token per record that carries user info), so the user
# tower computes on K gathered positions instead of every [B, L] position
# (models/embedding.fuse_sequence). The samplers enforce the cap loudly
# (data/dataset._build_ext_sequence).
MAX_USER_TOKENS_PER_ROW = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the sequence encoder + fusion towers."""

    hidden_units: int = 64
    num_blocks: int = 4
    num_heads: int = 4
    maxlen: int = 101               # sequence window (reference main.py:23)
    dropout_rate: float = 0.01
    norm_first: bool = False        # pre-LN vs post-LN wiring (reference model.py:337-346)
    block_type: str = "mha"         # "mha" (reference parity) | "hstu" (north star)
    ffn_type: str = "relu"          # "relu" (BaseLine C2a) | "swiglu" (BaseLineO1 C2b)
    ffn_hidden_mult: float = 4.0    # swiglu: pre-2/3-rule hidden multiple
    ffn_multiple_of: int = 256      # swiglu hidden rounding (BaseLineO1/model.py:103-165)
    # HSTU specifics
    hstu_rel_pos_buckets: int = 128  # relative-position-bias buckets
    dtype: str = "bfloat16"          # compute dtype; params stay float32
    # master dtype of the LEARNED item_emb table only. "bfloat16" halves
    # the table, raising the single-chip sparse-table ceiling to 50M+
    # rows; other params stay float32
    table_dtype: str = "float32"
    # store >=30M-row tables PACKED [V/R, 8, 128] (tile-compact layout; any
    # XLA op on a huge [V, 64] table stages a lane-padded 2x copy of the
    # whole thing). Under a mesh the GROUP dim shards so per-device slices
    # keep the compact layout (ops/sparse_table.sharded_gather_rows)
    pack_big_tables: bool = True
    use_flash_attention: bool = True  # Pallas fused attention kernel when shapes allow
    # fully-fused whole-block kernel (ops/fused_block.py): LNs + projections
    # + attention + gating + dropout + FFN in one Pallas kernel per block
    # (single-chip HSTU/SwiGLU at L<=1024); falls back automatically
    fused_block: bool = True
    remat_blocks: bool = True        # jax.checkpoint each scanned block in training
    # Faithful reference init zeroes every 1-D param INCLUDING LayerNorm
    # scales (reference main.py:95-102); sane init uses scale 1. Parity
    # presets keep the quirk, north-star presets do not.
    reference_init: bool = True


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Which feature families are active (schema itself lives in data/schema.py)."""

    mm_emb_ids: Tuple[str, ...] = ("81",)
    array_cap: int = 8               # static per-token cap for array features (no dynamic shapes)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    lr: float = 1e-3
    # Schedule (reference uses a constant lr — these default to it). The
    # single source of truth is trainer.lr_at_step: the optax schedule AND
    # the LearningRate telemetry both derive from it, so the logged value
    # can never diverge from what the optimizer applies.
    lr_schedule: str = "constant"    # "constant" | "cosine"
    lr_warmup_steps: int = 0
    lr_total_steps: int = 0          # cosine horizon (0 = no decay)
    num_epochs: int = 5
    l2_emb: float = 1e-3             # BaseLine: explicit L2 penalty on item table
    # The reference BaseLine uses torch.optim.AdamW with its DEFAULT
    # weight_decay=0.01 (main.py:131) on top of the explicit l2_emb penalty;
    # BaseLineO1 sets weight_decay=l2_emb explicitly (BaseLineO1/main.py:173).
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.98            # reference main.py:131
    seed: int = 42
    loss_type: str = "bce"           # "bce" (parity) | "sampled_softmax" (north star)
    num_sampled_negatives: int = 128  # sampled-softmax uniform negatives
    # in-batch negatives for sampled softmax (F9's other half): batch
    # positives double as shared negatives with empirical-frequency logQ
    # correction (ops/losses.inbatch_candidates); their embeddings reuse the
    # positives' tower outputs, so the marginal cost is one [B*L, N] matmul.
    # 0 = shared-uniform only.
    num_inbatch_negatives: int = 0
    # Tower dedup (trainer.augment_batch_dedup): run the item tower ONCE per
    # unique id in the step's candidate stream (seq item tokens + final
    # positives + negatives) and spread outputs back by a host-planned,
    # scatter-free gather (ops/sparse_table.planned_lookup). EXACT — item
    # features are a function of the item id (data/featurizer.ItemFeature
    # Tables; the reference looks features up per id too,
    # model/BaseLine/dataset.py:130-160) — and cuts tower matmuls + one-hot
    # feature backwards to O(unique ids). Pure data-parallel meshes: data>1
    # runs the stacked [S, cap] per-shard plan (vmapped tower + spreads);
    # composes with sparse_tables both single-device and stacked.
    tower_dedup: bool = False
    # Static unique-id capacity as a fraction of the candidate-stream length
    # (already clamped to itemnum+2 — unique ids can't exceed the vocab).
    # A batch whose unique count exceeds it DEGRADES TO NEUTRAL: it ships
    # un-dedup'd through the dense per-position towers (exact, slower) with
    # a rate-limited warning — never truncates, never kills the run.
    tower_dedup_cap_frac: float = 0.75
    # Gradient accumulation (dense-table paths): split the loaded batch
    # into G strided microbatches inside ONE jitted step (lax.scan) — only
    # one microbatch's activations stay live, so effective batch B trains
    # at ~B/G activation memory. EXACT: microbatch grads/losses combine
    # weighted by their masked-position counts. Unsupported with
    # sparse_tables / tower_dedup (host plans index global batch rows).
    grad_accum_steps: int = 1
    # Epoch-end retrieval eval (HR@10 / NDCG@10 over the validation split):
    # the competition metric the reference never surfaces during training
    # (it logs only valid loss, main.py:233-262). Encodes the full item
    # corpus with the item tower + scores last-position queries via the
    # approx-MIPS path; single-process, non-mesh runs only (the serving
    # flow covers sharded eval). 0 users = off.
    eval_retrieval_users: int = 0
    valid_fraction: float = 0.1      # 90/10 split (reference main.py:72)
    log_every: int = 10
    grad_log_every: int = 100
    # Sparse-table training (ops/sparse_table.py): tables listed here are
    # trained via dedup'd row gather + row-sparse updates — per-step optimizer
    # cost O(touched rows) instead of O(table). Required for the 100M-row
    # north star; the reference trains BOTH its tables densely
    # (model.py:115-117). Supports "item_emb" and "user_emb" (user_emb
    # rides the unpacked gather path — it stays [U+1, D] at init).
    sparse_tables: Tuple[str, ...] = ()
    # Per-shard touched-row capacity headroom for MESH-sharded packed tables
    # (ops/sparse_table.shard_capacity). Ownership is contiguous-range
    # (uid // rows_per_shard), so recency/popularity-clustered id layouts can
    # concentrate a batch's touched rows on one shard; host_shard_plan
    # crashes loudly (never drops rows) pointing back at this knob.
    sparse_shard_slack: float = 1.35
    # "rowwise_adagrad" (production: 4 bytes/row of state, 231 ms/step at
    # 10M rows on v5e) | "lazy_adam" (SparseAdam semantics, exactly matches
    # dense Adam where they overlap — but XLA's staged moment copies make it
    # pathologically slow beyond ~1M rows; use for small tables/tests)
    table_optimizer: str = "lazy_adam"
    # lazy-Adam moment storage; bf16 halves the moment tables AND the staged
    # gather+scatter copies (row math still runs f32)
    table_moments_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes. data=DP, model=TP, seq=SP, pipe=PP. Tables
    row-shard over (data×model) flattened unless table_axis overrides.

    ``pipe > 1`` runs the encoder blocks as a GPipe schedule over the
    ``pipe`` axis (parallel/pipeline_parallel.py) with
    ``pp_microbatches`` microbatches; requires model == seq == 1."""

    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    pp_microbatches: int = 8
    table_shard_axes: Tuple[str, ...] = ("pipe", "data", "model")


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    top_k: int = 10
    # C++ HNSW tool operating point (reference infer.py:223)
    hnsw_m: int = 64
    hnsw_ef_construction: int = 1280
    hnsw_ef_search: int = 640
    metric_type: int = 0             # 0 = inner product
    method: str = "exact"            # "exact" | "approx" (HW approx_max_k)
    #                                  | "int8" (quantized corpus, 4x
    #                                  smaller HBM) | "hnsw" (C++ tool)


@dataclasses.dataclass(frozen=True)
class RQVAEConfig:
    num_levels: int = 3
    codebook_size: int = 256
    code_dim: int = 32
    enc_hidden: Tuple[int, ...] = (512, 256)
    commit_beta: float = 0.25
    lr: float = 1e-3
    ema_decay: float = 0.99


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    retrieval: RetrievalConfig = dataclasses.field(default_factory=RetrievalConfig)
    rqvae: RQVAEConfig = dataclasses.field(default_factory=RQVAEConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets — the five BASELINE.json configs plus the two reference-parity ones.
# ---------------------------------------------------------------------------

def baseline_parity() -> Config:
    """Reference BaseLine config (main.py:21-44): B=64 lr=1e-3 D=64 4 blocks
    4 heads drop 0.01 l2 1e-3, softmax MHA + ReLU FFN."""
    return Config()


def baseline_o1_parity() -> Config:
    """Reference BaseLineO1 config (BaseLineO1/main.py:37-47): B=128 lr=5e-3
    1 head, AdamW wd=0.01, SwiGLU FFN."""
    return Config(
        model=ModelConfig(num_heads=1, ffn_type="swiglu"),
        train=TrainConfig(batch_size=128, lr=5e-3, l2_emb=0.0, weight_decay=0.01),
    )


def hstu_mini() -> Config:
    """BASELINE.json configs[0]: BaseLine HSTU, 2 blocks, seq 128, mini split."""
    return Config(
        model=ModelConfig(num_blocks=2, maxlen=128, block_type="hstu",
                          reference_init=False),
    )


def hstu_flagship() -> Config:
    """BASELINE.json configs[1]: BaseLineO1 HSTU, 8 blocks, seq 1024, 1 chip.

    num_heads=1 matches the reference O1 default (BaseLineO1/main.py:45) and
    is the fast configuration on TPU: attention FLOPs scale with D = H*hd,
    so fewer/wider heads do identical work at ~4x the MXU contraction
    efficiency (hd=64 vs hd=16 against the 128-lane systolic array)."""
    return Config(
        model=ModelConfig(
            hidden_units=64, num_blocks=8, num_heads=1, maxlen=1024,
            block_type="hstu", ffn_type="swiglu", reference_init=False,
            # remat ON wins on-chip: saving per-block FFN/uvqk residuals
            # costs more HBM traffic than recomputing them (measured
            # 723 -> 651 ex/s with remat off at B=128)
        ),
        train=TrainConfig(batch_size=128, lr=5e-3, l2_emb=0.0,
                          weight_decay=0.01,
                          # one item tower per unique candidate id (EXACT —
                          # tests/test_tower_dedup.py); the single-chip
                          # flagship fast path (multi-device meshes gate it
                          # off with a warning)
                          tower_dedup=True),
    )


def sampled_softmax_dp() -> Config:
    """BASELINE.json configs[3]: MM side features + sampled softmax, 1-host DP."""
    return Config(
        model=ModelConfig(block_type="hstu", ffn_type="swiglu", reference_init=False),
        train=TrainConfig(loss_type="sampled_softmax", l2_emb=0.0,
                          weight_decay=0.01, num_inbatch_negatives=64,
                          # stacked per-shard tower dedup (EXACT; vmapped
                          # spreads over the data axis — trainer.
                          # augment_batch_dedup)
                          tower_dedup=True),
        mesh=MeshConfig(data=8),
    )


def sharded_multihost() -> Config:
    """BASELINE.json configs[4]: row-sharded tables, all-to-all lookup, multi-host."""
    return Config(
        model=ModelConfig(block_type="hstu", ffn_type="swiglu", num_blocks=8,
                          reference_init=False),
        train=TrainConfig(loss_type="sampled_softmax", l2_emb=0.0,
                          weight_decay=0.01,
                          sparse_tables=("item_emb",),
                          table_optimizer="rowwise_adagrad",
                          # stacked [S, cap] dedup over the data axis; the
                          # TP'd tower weights shard under SPMD around it
                          # (round 5 — the sparse path has no a2a conflict)
                          tower_dedup=True),
        mesh=MeshConfig(data=4, model=2),
    )


PRESETS = {
    "baseline": baseline_parity,
    "baseline_o1": baseline_o1_parity,
    "hstu_mini": hstu_mini,
    "hstu_flagship": hstu_flagship,
    "sampled_softmax_dp": sampled_softmax_dp,
    "sharded_multihost": sharded_multihost,
}


@dataclasses.dataclass(frozen=True)
class EnvPaths:
    """The reference's environment-variable directory contract
    (main.py:52-57, infer.py:15,103,142,211)."""

    train_data_path: Optional[str] = None
    train_log_path: Optional[str] = None
    train_tf_events_path: Optional[str] = None
    train_ckpt_path: Optional[str] = None
    eval_data_path: Optional[str] = None
    eval_result_path: Optional[str] = None
    model_output_path: Optional[str] = None

    @classmethod
    def from_env(cls) -> "EnvPaths":
        g = os.environ.get
        return cls(
            train_data_path=g("TRAIN_DATA_PATH"),
            train_log_path=g("TRAIN_LOG_PATH"),
            train_tf_events_path=g("TRAIN_TF_EVENTS_PATH"),
            train_ckpt_path=g("TRAIN_CKPT_PATH"),
            eval_data_path=g("EVAL_DATA_PATH"),
            eval_result_path=g("EVAL_RESULT_PATH"),
            model_output_path=g("MODEL_OUTPUT_PATH"),
        )
