"""The sequence-recommender model, inference half.

Counterpart of ``tencent_recommendation_2025_tpu/models/baseline.py``: a
static :class:`SeqRecModel` descriptor (config + schema + vocab layout) with
methods over a nested parameter dict of tensors.

- :meth:`init` — parameters from a seeded ``torch.Generator``, with the
  shapes and distributions of the JAX init (the numbers differ);
- :meth:`predict` — last-position query vectors;
- :meth:`encode_items` — candidate-corpus item tower.

The training forward and loss belong to a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from ..config import ModelConfig
from ..data.featurizer import FusedVocab
from ..data.schema import FeatureSchema
from . import embedding as E
from . import encoder as ENC


@dataclasses.dataclass(frozen=True)
class SeqRecModel:
    cfg: ModelConfig
    schema: FeatureSchema
    fused: FusedVocab
    usernum: int
    itemnum: int

    def init(self, gen: torch.Generator, device="cpu") -> Dict:
        """Fresh parameters drawn on the CPU from ``gen``, then moved."""
        params = E.init_embedding_params(gen, self.cfg, self.schema,
                                         self.fused, self.usernum,
                                         self.itemnum)
        params.update(ENC.init_encoder_params(gen, self.cfg))
        return tree_to(params, device)

    def item_embeddings(self, params: Mapping, ids: torch.Tensor,
                        item_sparse: torch.Tensor, item_array: torch.Tensor,
                        mm_tables: Mapping[str, torch.Tensor],
                        mm_override: Optional[Mapping[str, torch.Tensor]]
                        = None) -> torch.Tensor:
        """Item tower on explicit ids + features; ``mm_override`` supplies
        explicit multimodal vectors, else they are gathered by id."""
        mm_vecs = mm_override if mm_override is not None else \
            E.gather_mm(mm_tables, ids, self.schema,
                        dtype=E.torch_dtype(self.cfg.dtype))
        return E.item_tower(params, ids, item_sparse, item_array, mm_vecs,
                            self.fused, self.schema, self.cfg)

    def log2feats(self, params: Mapping, batch: Mapping,
                  mm_tables: Mapping[str, torch.Tensor]) -> torch.Tensor:
        fused_emb = E.fuse_sequence(params, batch, mm_tables, self.fused,
                                    self.schema, self.cfg)
        return ENC.encode(params, fused_emb, batch["seq"],
                          batch["token_type"], params["pos_emb"], self.cfg)

    @torch.no_grad()
    def predict(self, params: Mapping, batch: Mapping,
                mm_tables: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Query vectors: encoding of the last position [B, D]."""
        return self.log2feats(params, batch, mm_tables)[:, -1, :]

    @torch.no_grad()
    def encode_items(self, params: Mapping, ids: torch.Tensor,
                     item_sparse: torch.Tensor, item_array: torch.Tensor,
                     mm_vecs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Candidate-corpus encoder: the item tower over [N] candidates with
        explicit multimodal vectors."""
        return self.item_embeddings(params, ids, item_sparse, item_array,
                                    mm_tables={}, mm_override=mm_vecs)


def tree_to(tree, device=None, dtype=None):
    """Move (and optionally cast floating leaves of) a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if dtype is not None and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)
