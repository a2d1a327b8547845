"""TencentGR feature schema (the C5 registry of SURVEY.md §2.1).

The reference hard-codes the registry in two places
(``model/BaseLine/dataset.py:180-235`` and ``model.py:169-184``); here it is a
single dataclass consumed by both the data pipeline and the model so they can
never diverge.

Feature families:
- *sparse*: one categorical id per token  (user: 103/104/105/109; item: 14 ids)
- *array*:  a variable-length id list per token (user: 106/107/108/110)
- *continual*: scalar floats per token (empty in the released data)
- *item_emb*: frozen multimodal content vectors keyed by creative id
  (ids 81..86, dims MM_EMB_DIMS)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

from ..config import MM_EMB_DIMS

USER_SPARSE_IDS: Tuple[str, ...] = ("103", "104", "105", "109")
ITEM_SPARSE_IDS: Tuple[str, ...] = (
    "100", "117", "111", "118", "101", "102", "119",
    "120", "114", "112", "121", "115", "122", "116",
)
USER_ARRAY_IDS: Tuple[str, ...] = ("106", "107", "108", "110")
ITEM_ARRAY_IDS: Tuple[str, ...] = ()
USER_CONTINUAL_IDS: Tuple[str, ...] = ()
ITEM_CONTINUAL_IDS: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class FeatureSchema:
    """Vocab sizes per feature id plus the active multimodal ids.

    ``vocab`` maps feature id -> number of distinct values (reference
    ``feat_statistics``, i.e. ``len(indexer['f'][fid])``). Embedding tables get
    ``vocab+1`` rows with row 0 reserved for padding/default.
    """

    vocab: Mapping[str, int]
    mm_emb_ids: Tuple[str, ...] = ("81",)
    array_cap: int = 8

    # ---- views mirroring the reference's *_FEAT dicts -----------------
    @property
    def user_sparse(self) -> Dict[str, int]:
        return {k: self.vocab[k] for k in USER_SPARSE_IDS}

    @property
    def item_sparse(self) -> Dict[str, int]:
        return {k: self.vocab[k] for k in ITEM_SPARSE_IDS}

    @property
    def user_array(self) -> Dict[str, int]:
        return {k: self.vocab[k] for k in USER_ARRAY_IDS}

    @property
    def item_array(self) -> Dict[str, int]:
        return {k: self.vocab[k] for k in ITEM_ARRAY_IDS}

    @property
    def user_continual(self) -> Tuple[str, ...]:
        return USER_CONTINUAL_IDS

    @property
    def item_continual(self) -> Tuple[str, ...]:
        return ITEM_CONTINUAL_IDS

    @property
    def item_emb_dims(self) -> Dict[str, int]:
        return {k: MM_EMB_DIMS[k] for k in self.mm_emb_ids}

    # ---- default values (reference dataset.py:214-233) ----------------
    def default_value(self, feat_id: str):
        import numpy as np

        if feat_id in USER_ARRAY_IDS or feat_id in ITEM_ARRAY_IDS:
            return [0]
        if feat_id in self.mm_emb_ids:
            return np.zeros(MM_EMB_DIMS[feat_id], dtype=np.float32)
        return 0

    @property
    def feature_types(self) -> Dict[str, Sequence[str]]:
        """The reference's feat_types dict shape (dataset.py:191-212)."""
        return {
            "user_sparse": list(USER_SPARSE_IDS),
            "item_sparse": list(ITEM_SPARSE_IDS),
            "user_array": list(USER_ARRAY_IDS),
            "item_array": list(ITEM_ARRAY_IDS),
            "user_continual": list(USER_CONTINUAL_IDS),
            "item_continual": list(ITEM_CONTINUAL_IDS),
            "item_emb": list(self.mm_emb_ids),
        }

    @classmethod
    def from_indexer(cls, indexer: Mapping, mm_emb_ids: Sequence[str] = ("81",),
                     array_cap: int = 8) -> "FeatureSchema":
        vocab = {fid: len(indexer["f"][fid])
                 for fid in (*USER_SPARSE_IDS, *ITEM_SPARSE_IDS,
                             *USER_ARRAY_IDS, *ITEM_ARRAY_IDS)}
        return cls(vocab=vocab, mm_emb_ids=tuple(mm_emb_ids), array_cap=array_cap)


# Static orderings used to pack features into dense arrays (data/featurizer.py)
# and to lay out the fused embedding table (models/embedding.py). Order is the
# schema declaration order and MUST stay stable across checkpoints.
def sparse_feature_order(schema: FeatureSchema) -> Tuple[str, ...]:
    return (*ITEM_SPARSE_IDS, *USER_SPARSE_IDS)


def array_feature_order(schema: FeatureSchema) -> Tuple[str, ...]:
    return (*ITEM_ARRAY_IDS, *USER_ARRAY_IDS)
