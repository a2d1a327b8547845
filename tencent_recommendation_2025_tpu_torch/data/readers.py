"""TencentGR on-disk stores: sequence files, indexer, item features, mm-embs.

On-disk contracts (reference ``model/BaseLine/dataset.py``):

- ``seq.jsonl`` + ``seq_offsets.pkl``: one JSON list per user of records
  ``(user_id, item_id, user_feat, item_feat, action_type, timestamp)``;
  the pickle maps row index -> byte offset for O(1) random access
  (``dataset.py:56-77``).
- ``indexer.pkl``: ``{'u': {raw->reid}, 'i': {creative->reid}, 'f': {fid: {val->reid}}}``
  (``dataset.py:46-52``).
- ``item_feat_dict.json``: item reid (str) -> feature dict (``dataset.py:44``).
- ``creative_emb/emb_{fid}_{dim}/*.json`` (fid 82..86) and ``emb_81_32.pkl``:
  frozen multimodal embeddings keyed by creative id (``dataset.py:437-472``).

The reader supports lazy seek-per-user (BaseLine) and full in-RAM preload
(BaseLineO1 C18, ``BaseLineO1/dataset.py:78-121``) behind one interface, plus
process-parallel mm-emb loading (O1 ``dataset.py:535-611``).
"""

from __future__ import annotations

import json
import pickle
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import MM_EMB_DIMS

try:  # orjson is optional; std json is the fallback (no self-install!)
    import orjson  # type: ignore

    def _loads(b):
        return orjson.loads(b)
except Exception:  # pragma: no cover
    def _loads(b):
        return json.loads(b)


class SequenceFile:
    """Random-access reader over ``seq.jsonl``-style files."""

    def __init__(self, jsonl_path: Path, offsets_path: Path, in_ram: bool = True):
        self.jsonl_path = Path(jsonl_path)
        with open(offsets_path, "rb") as f:
            self.offsets = pickle.load(f)
        self._in_ram = in_ram
        self._lines: Optional[List[bytes]] = None
        self._file = None
        if in_ram:
            # O1-style preload: split the whole file by offsets once.
            raw = self.jsonl_path.read_bytes()
            n = len(self.offsets)
            starts = [self.offsets[i] for i in range(n)]
            ends = starts[1:] + [len(raw)]
            self._lines = [raw[s:e] for s, e in zip(starts, ends)]
        else:
            self._file = open(self.jsonl_path, "rb")

    def __len__(self) -> int:
        return len(self.offsets)

    def load_user(self, uid: int):
        if self._lines is not None:
            return _loads(self._lines[uid])
        self._file.seek(self.offsets[uid])
        return _loads(self._file.readline())

    def close(self):
        if self._file is not None:
            self._file.close()


def load_indexer(data_dir: Path) -> Dict:
    with open(Path(data_dir) / "indexer.pkl", "rb") as f:
        return pickle.load(f)


def load_item_feat_dict(data_dir: Path) -> Dict[str, dict]:
    with open(Path(data_dir) / "item_feat_dict.json", "r") as f:
        return json.load(f)


def _load_single_mm_feat(args):
    mm_path_str, feat_id = args
    mm_path = Path(mm_path_str)
    dim = MM_EMB_DIMS[feat_id]
    emb_dict: Dict = {}
    if feat_id == "81":
        with open(mm_path / f"emb_{feat_id}_{dim}.pkl", "rb") as f:
            emb_dict = pickle.load(f)
    else:
        base = mm_path / f"emb_{feat_id}_{dim}"
        if base.exists():
            for json_file in sorted(base.glob("*.json")):
                with open(json_file, "rb") as f:
                    for line in f:
                        rec = _loads(line)
                        v = rec["emb"]
                        if isinstance(v, list):
                            v = np.asarray(v, dtype=np.float32)
                        emb_dict[rec["anonymous_cid"]] = v
    return feat_id, emb_dict


def load_mm_emb(mm_path: Path, feat_ids: Sequence[str],
                max_workers: int = 4) -> Dict[str, Dict]:
    """Load multimodal embedding stores, in parallel when there are several."""
    feat_ids = list(feat_ids)
    if len(feat_ids) <= 1 or max_workers <= 1:
        return dict(_load_single_mm_feat((str(mm_path), fid)) for fid in feat_ids)
    with ProcessPoolExecutor(max_workers=min(max_workers, len(feat_ids))) as ex:
        out = dict(ex.map(_load_single_mm_feat,
                          [(str(mm_path), fid) for fid in feat_ids]))
    return out


class TencentGRData:
    """All stores for one data directory, loaded once."""

    def __init__(self, data_dir, mm_emb_ids: Sequence[str] = ("81",),
                 in_ram: bool = True, split: str = "train"):
        self.data_dir = Path(data_dir)
        prefix = "seq" if split == "train" else "predict_seq"
        self.seq = SequenceFile(self.data_dir / f"{prefix}.jsonl",
                                self.data_dir / f"{prefix}_offsets.pkl",
                                in_ram=in_ram)
        self.indexer = load_indexer(self.data_dir)
        self.itemnum = len(self.indexer["i"])
        self.usernum = len(self.indexer["u"])
        self.indexer_i_rev = {v: k for k, v in self.indexer["i"].items()}
        self.indexer_u_rev = {v: k for k, v in self.indexer["u"].items()}
        self.item_feat_dict = load_item_feat_dict(self.data_dir)
        self.mm_emb_dict = load_mm_emb(self.data_dir / "creative_emb", mm_emb_ids)
        self.mm_emb_ids = tuple(mm_emb_ids)
