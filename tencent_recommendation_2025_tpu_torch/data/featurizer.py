"""Fixed-shape featurization: python feature dicts -> device-ready arrays.

TPU-first redesign of the reference's hot-path featurizer. The reference
converts python dicts to tensors *inside the model forward* with per-batch
dynamic max lengths (``model/BaseLine/model.py:186-224``) and packs multimodal
vectors into a ``[B, L, 4096]`` numpy array *per step*
(``model.py:281-299``) — dynamic shapes force XLA recompiles and the H2D
traffic dominates step time.  Here:

- every shape is **static**: array features are capped at ``schema.array_cap``;
- all *static per-item* features (sparse/array/multimodal) are packed **once**
  into dense id-indexed tables and gathered **on device** by item id, so the
  per-step host work is only the sequence ids + user-token features;
- sparse and array ids are remapped into a single **fused vocabulary** so the
  model does one embedding gather instead of 18 (see models/embedding.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from . import schema as S
from .schema import FeatureSchema


# ---------------------------------------------------------------------------
# Static per-item tables (host-built once, device-resident afterwards)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ItemFeatureTables:
    """Dense id-indexed item-side features. Row 0 = padding/defaults."""

    sparse: np.ndarray                      # [I+1, NIS] int32
    array: np.ndarray                       # [I+1, NIA, CAP] int32
    mm: Dict[str, np.ndarray]               # fid -> [I+1, dim] float32
    mm_present: Dict[str, np.ndarray]       # fid -> [I+1] bool


def _clean_value(v) -> int:
    """Cold-start rule: unseen (string) feature values become 0
    (reference ``dataset.py:309-327``)."""
    return 0 if isinstance(v, str) else int(v)


def pack_item_feat(feat: Optional[Mapping], schema: FeatureSchema
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One item's feature dict -> (sparse [NIS], array [NIA, CAP]) int32."""
    feat = feat or {}
    sp = np.zeros(len(S.ITEM_SPARSE_IDS), dtype=np.int32)
    for j, fid in enumerate(S.ITEM_SPARSE_IDS):
        if fid in feat:
            sp[j] = _clean_value(feat[fid])
    ar = np.zeros((len(S.ITEM_ARRAY_IDS), schema.array_cap), dtype=np.int32)
    for j, fid in enumerate(S.ITEM_ARRAY_IDS):
        vals = feat.get(fid) or []
        vals = [_clean_value(v) for v in vals][: schema.array_cap]
        ar[j, : len(vals)] = vals
    return sp, ar


def pack_user_feat(feat: Optional[Mapping], schema: FeatureSchema
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One user's feature dict -> (sparse [NUS], array [NUA, CAP]) int32."""
    feat = feat or {}
    sp = np.zeros(len(S.USER_SPARSE_IDS), dtype=np.int32)
    for j, fid in enumerate(S.USER_SPARSE_IDS):
        if fid in feat:
            sp[j] = _clean_value(feat[fid])
    ar = np.zeros((len(S.USER_ARRAY_IDS), schema.array_cap), dtype=np.int32)
    for j, fid in enumerate(S.USER_ARRAY_IDS):
        vals = feat.get(fid) or []
        vals = [_clean_value(v) for v in vals][: schema.array_cap]
        ar[j, : len(vals)] = vals
    return sp, ar


def build_item_tables(item_feat_dict: Mapping[str, Mapping], itemnum: int,
                      schema: FeatureSchema,
                      mm_emb_dict: Optional[Mapping[str, Mapping]] = None,
                      indexer_i_rev: Optional[Mapping[int, str]] = None,
                      ) -> ItemFeatureTables:
    """Pack the static item-feature dicts into dense tables.

    Mirrors the semantics of reference ``fill_missing_feat``
    (``dataset.py:237-265``): missing sparse/array -> defaults (0), multimodal
    attached only when the creative id is present in the store (else zeros).
    """
    nis, nia, cap = len(S.ITEM_SPARSE_IDS), len(S.ITEM_ARRAY_IDS), schema.array_cap
    sparse = np.zeros((itemnum + 1, nis), dtype=np.int32)
    array = np.zeros((itemnum + 1, nia, cap), dtype=np.int32)
    for sid, feat in item_feat_dict.items():
        reid = int(sid)
        if reid > itemnum:
            continue
        sp, ar = pack_item_feat(feat, schema)
        sparse[reid] = sp
        if nia:
            array[reid] = ar
    mm: Dict[str, np.ndarray] = {}
    mm_present: Dict[str, np.ndarray] = {}
    if mm_emb_dict:
        for fid in schema.mm_emb_ids:
            dim = schema.item_emb_dims[fid]
            t = np.zeros((itemnum + 1, dim), dtype=np.float32)
            present = np.zeros(itemnum + 1, dtype=bool)
            store = mm_emb_dict.get(fid, {})
            for reid in range(1, itemnum + 1):
                cid = indexer_i_rev[reid] if indexer_i_rev else None
                v = store.get(cid)
                if isinstance(v, np.ndarray):
                    t[reid] = v
                    present[reid] = True
            mm[fid] = t
            mm_present[fid] = present
    return ItemFeatureTables(sparse=sparse, array=array, mm=mm,
                             mm_present=mm_present)


# ---------------------------------------------------------------------------
# Fused-vocabulary remapping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedVocab:
    """Layout of the single fused sparse-feature embedding table.

    Global row 0 is the shared padding row; feature ``f``'s value ``v>0`` maps
    to row ``offset[f] + v`` where offsets partition ``[1, total)``. Embedding
    lookups multiply by ``(v != 0)`` so padding contributes exactly zero (the
    functional analog of torch ``padding_idx=0``, reference ``model.py:158-165``).
    """

    feature_ids: Tuple[str, ...]            # item_sparse + user_sparse + item_array + user_array
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]                   # per-feature vocab sizes
    total_rows: int

    @classmethod
    def build(cls, schema: FeatureSchema) -> "FusedVocab":
        fids = (*S.ITEM_SPARSE_IDS, *S.USER_SPARSE_IDS,
                *S.ITEM_ARRAY_IDS, *S.USER_ARRAY_IDS)
        offsets, sizes = [], []
        acc = 0                              # value v maps to offset + v, v in [1, vocab]
        for fid in fids:
            offsets.append(acc)
            sizes.append(schema.vocab[fid])
            acc += schema.vocab[fid] + 1     # +1 keeps per-feature row spacing
        return cls(feature_ids=fids, offsets=tuple(offsets),
                   sizes=tuple(sizes), total_rows=acc + 1)

    def group_sizes(self, fids) -> Tuple[int, ...]:
        return tuple(self.sizes[self.slot(f)] for f in fids)

    def slot(self, fid: str) -> int:
        return self.feature_ids.index(fid)

    @property
    def n_item_sparse(self) -> int:
        return len(S.ITEM_SPARSE_IDS)

    @property
    def n_user_sparse(self) -> int:
        return len(S.USER_SPARSE_IDS)

    @property
    def n_item_array(self) -> int:
        return len(S.ITEM_ARRAY_IDS)

    @property
    def n_user_array(self) -> int:
        return len(S.USER_ARRAY_IDS)
