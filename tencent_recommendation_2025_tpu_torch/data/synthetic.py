"""Synthetic mini-TencentGR dataset generator (the test/bench fixture).

Writes a directory honoring every on-disk contract in data/readers.py:
``seq.jsonl`` + ``seq_offsets.pkl``, ``indexer.pkl``, ``item_feat_dict.json``,
``creative_emb/emb_81_32.pkl`` (and optional 82.. dirs), plus the inference
side: ``predict_seq.jsonl`` + offsets, ``predict_set.jsonl`` and a
``ground_truth.json`` (held-out next item per user) for self-evaluated
HR@k/NDCG@k — the reference has no in-repo eval (SURVEY.md §6), so the fixture
carries its own truth.

Record layout per user line mirrors reference ``dataset.py:113-121``:
``[(u, i, user_feat, item_feat, action_type, timestamp), ...]`` where the
first record is the user-profile token.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import MM_EMB_DIMS
from . import schema as S


def _zipf_ids(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """1-based item ids with a popularity skew (real logs are zipfian)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    return rng.choice(np.arange(1, n + 1), size=size, p=p)


def generate(
    out_dir,
    num_users: int = 64,
    num_items: int = 200,
    min_seq: int = 6,
    max_seq: int = 40,
    mm_emb_ids: Sequence[str] = ("81",),
    seed: int = 0,
    num_predict_users: Optional[int] = None,
    cold_start: bool = False,
) -> Path:
    """``cold_start=True`` injects inference-only pathologies into the
    predict files: unseen items (reid > itemnum) and string feature values
    (the reference's cold-start rules, ``dataset.py:309-327,358-364``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    # ---- indexer: raw->reid maps --------------------------------------
    user_ids = {f"user_{i:06d}": i for i in range(1, num_users + 1)}
    item_ids = {f"creative_{i:08d}": i for i in range(1, num_items + 1)}
    feat_vocab_sizes: Dict[str, int] = {}
    for fid in (*S.USER_SPARSE_IDS, *S.USER_ARRAY_IDS):
        feat_vocab_sizes[fid] = int(rng.integers(5, 20))
    for fid in (*S.ITEM_SPARSE_IDS, *S.ITEM_ARRAY_IDS):
        feat_vocab_sizes[fid] = int(rng.integers(8, 50))
    indexer = {
        "u": user_ids,
        "i": item_ids,
        "f": {fid: {f"v{j}": j for j in range(1, n + 1)}
              for fid, n in feat_vocab_sizes.items()},
    }
    with open(out_dir / "indexer.pkl", "wb") as f:
        pickle.dump(indexer, f)

    # ---- item features (static per item) ------------------------------
    item_feat_dict = {}
    for reid in range(1, num_items + 1):
        feat = {fid: int(rng.integers(1, feat_vocab_sizes[fid] + 1))
                for fid in S.ITEM_SPARSE_IDS}
        for fid in S.ITEM_ARRAY_IDS:
            k = int(rng.integers(1, 4))
            feat[fid] = [int(v) for v in
                         rng.integers(1, feat_vocab_sizes[fid] + 1, size=k)]
        item_feat_dict[str(reid)] = feat
    with open(out_dir / "item_feat_dict.json", "w") as f:
        json.dump(item_feat_dict, f)

    # ---- multimodal stores --------------------------------------------
    emb_root = out_dir / "creative_emb"
    emb_root.mkdir(exist_ok=True)
    rev_i = {v: k for k, v in item_ids.items()}
    for fid in mm_emb_ids:
        dim = MM_EMB_DIMS[fid]
        # ~80% of items have a content vector
        have = rng.random(num_items) < 0.8
        store = {rev_i[reid]: rng.standard_normal(dim).astype(np.float32)
                 for reid in range(1, num_items + 1) if have[reid - 1]}
        if fid == "81":
            with open(emb_root / f"emb_{fid}_{dim}.pkl", "wb") as f:
                pickle.dump(store, f)
        else:
            d = emb_root / f"emb_{fid}_{dim}"
            d.mkdir(exist_ok=True)
            with open(d / "part0.json", "w") as f:
                for cid, v in store.items():
                    f.write(json.dumps({"anonymous_cid": cid,
                                        "emb": [float(x) for x in v]}) + "\n")

    # ---- user profile features ----------------------------------------
    def user_feat(_uid):
        feat = {fid: int(rng.integers(1, feat_vocab_sizes[fid] + 1))
                for fid in S.USER_SPARSE_IDS}
        for fid in S.USER_ARRAY_IDS:
            k = int(rng.integers(1, 5))
            feat[fid] = [int(v) for v in
                         rng.integers(1, feat_vocab_sizes[fid] + 1, size=k)]
        return feat

    # ---- sequences -----------------------------------------------------
    full_seqs = {}
    for uid in range(1, num_users + 1):
        n = int(rng.integers(min_seq, max_seq + 1))
        items = _zipf_ids(rng, num_items, n)
        records = [[uid, 0, user_feat(uid), None, None, 0]]
        t = 1_700_000_000
        for it in items:
            t += int(rng.integers(30, 3600))
            records.append([0, int(it), None, item_feat_dict[str(it)],
                            int(rng.integers(0, 2)), t])
        full_seqs[uid] = records

    def write_jsonl(path_prefix: str, seqs: dict):
        # offsets pickle is a LIST indexed by row — the layout the real
        # TencentGR release uses (reference BaseLineO1/dataset.py:93
        # ``enumerate(self.seq_offsets)`` only works on a list)
        offsets = []
        with open(out_dir / f"{path_prefix}.jsonl", "wb") as f:
            for uid, records in seqs.items():
                offsets.append(f.tell())
                f.write(json.dumps(records).encode() + b"\n")
        with open(out_dir / f"{path_prefix}_offsets.pkl", "wb") as f:
            pickle.dump(offsets, f)

    write_jsonl("seq", full_seqs)

    # ---- inference-side files ------------------------------------------
    n_pred = num_predict_users or num_users
    ground_truth = {}
    predict_seqs = {}
    rev_u = {v: k for k, v in user_ids.items()}
    for uid in list(full_seqs)[:n_pred]:
        records = full_seqs[uid]
        held_out = records[-1]            # last item record is the truth
        ground_truth[rev_u[uid]] = rev_i[held_out[1]]
        pred_records = [list(r) for r in records[:-1]]
        pred_records[0][0] = rev_u[uid]   # predict file uses the string user id
        if cold_start and uid % 3 == 0 and len(pred_records) > 3:
            # unseen item id (beyond itemnum) with string feature values
            cold_feat = {fid: f"unseen_{uid}" for fid in
                         list(pred_records[-1][3])[:2]}
            cold_feat.update({k: v for k, v in pred_records[-1][3].items()
                              if k not in cold_feat})
            pred_records.append([0, num_items + 1000 + uid, None, cold_feat,
                                 0, pred_records[-1][5] + 60])
        predict_seqs[uid] = pred_records
    write_jsonl("predict_seq", predict_seqs)
    with open(out_dir / "ground_truth.json", "w") as f:
        json.dump(ground_truth, f)

    # candidate corpus = every item, with retrieval ids 0..N-1
    with open(out_dir / "predict_set.jsonl", "w") as f:
        for rid, reid in enumerate(range(1, num_items + 1)):
            f.write(json.dumps({
                "creative_id": rev_i[reid],
                "retrieval_id": rid,
                "features": item_feat_dict[str(reid)],
            }) + "\n")

    return out_dir
