#!/usr/bin/env bash
# The quality ritual through the PyTorch/CUDA port: the synthetic
# 2000-user / 5000-item fixture (seed 21) -> the port's cli.train ->
# the port's cli.infer -> HR@10 / NDCG@10, on the card (pass --device cpu
# in the extra args for the CPU). The recipe of scripts/quality_run.sh;
# --maxlen 255 gives L=256, where both fused block kernels run.
#
# Usage:
#   scripts/torch_quality_run.sh WORKDIR [extra cli.train/cli.infer args...]
set -euo pipefail

REPO_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:${PYTHONPATH}}"
PKG=tencent_recommendation_2025_tpu_torch

WORK="$1"; shift 1
DATA="$WORK/data"
RUN="$WORK/hstu_flagship"
mkdir -p "$RUN"

if [[ ! -f "$DATA/seq.jsonl" ]]; then
  python - "$DATA" <<'PY'
import sys
from pathlib import Path

from tencent_recommendation_2025_tpu_torch.data import synthetic

d = Path(sys.argv[1])
d.mkdir(parents=True, exist_ok=True)
synthetic.generate(d, num_users=2000, num_items=5000, min_seq=20,
                   max_seq=120, seed=21)
print(f"fixture at {d}")
PY
fi

TRAIN_DATA_PATH="$DATA" TRAIN_LOG_PATH="$RUN/logs" \
TRAIN_TF_EVENTS_PATH="$RUN/tb" TRAIN_CKPT_PATH="$RUN/ckpt" \
  python -u -m "$PKG.cli.train" \
    --preset hstu_flagship --maxlen 255 --num_epochs 2 "$@" \
    2>&1 | tee "$RUN/train.out"

EVAL_DATA_PATH="$DATA" EVAL_RESULT_PATH="$RUN/result" \
MODEL_OUTPUT_PATH="$RUN/ckpt" \
  python -u -m "$PKG.cli.infer" \
    --preset hstu_flagship --maxlen 255 "$@" \
    2>&1 | tee "$RUN/infer.out"

grep -h "HR@10" "$RUN/infer.out" | tail -1
