"""The sequence-recommender model.

Counterpart of ``tencent_recommendation_2025_tpu/models/baseline.py``: a
static :class:`SeqRecModel` descriptor (config + schema + vocab layout) with
methods over a nested parameter dict of tensors.

- :meth:`init` — parameters from a seeded ``torch.Generator``, with the
  shapes and distributions of the JAX init (the numbers differ);
- :meth:`forward` / :meth:`logits` — the training forward: positive and
  negative logits over next-item positions;
- :meth:`predict` — last-position query vectors;
- :meth:`encode_items` — candidate-corpus item tower.

On a data-only mesh the item-id lookups of the training forward (the
sequence, the final positives, the BCE negatives, the tower-dedup column)
take the explicit all-to-all (:meth:`SeqRecModel._ep_override`), whose
bucket overflows :class:`ep_overflow_scope` counts.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..config import ModelConfig
from ..data.featurizer import FusedVocab
from ..data.schema import FeatureSchema
from ..ops.sparse_table import is_packed_scale, planned_lookup
from ..parallel.sharded_embedding import ShardedTable, sharded_lookup_a2a
from ..utils import tracing as TRC
from . import embedding as E
from . import encoder as ENC

#: the a2a overflow counts of the forward in flight (ep_overflow_scope)
_EP_OVERFLOW_ACC: contextvars.ContextVar = contextvars.ContextVar(
    "ep_overflow_acc", default=None)


class ep_overflow_scope:
    """Collects the bucket-overflow counts :meth:`SeqRecModel._ep_override`
    emits during one forward, in a context variable (per thread, nesting
    restored), never on the shared model: ``counts`` holds one count per
    a2a lookup (``trainer.compute_loss`` sums them)."""

    def __enter__(self):
        self.counts = []
        self._token = _EP_OVERFLOW_ACC.set(self.counts)
        return self

    def __exit__(self, *exc):
        _EP_OVERFLOW_ACC.reset(self._token)
        return False


@dataclasses.dataclass(frozen=True)
class SeqRecModel:
    cfg: ModelConfig
    schema: FeatureSchema
    fused: FusedVocab
    usernum: int
    itemnum: int

    def init(self, gen: torch.Generator, device="cpu") -> Dict:
        """Fresh parameters drawn on the CPU from ``gen``, then moved; an
        item table at packed scale is drawn on ``device`` itself."""
        params = E.init_embedding_params(gen, self.cfg, self.schema,
                                         self.fused, self.usernum,
                                         self.itemnum, device=device)
        params.update(ENC.init_encoder_params(gen, self.cfg))
        return tree_to(params, device)

    def _ep_override(self, params: Mapping, ids: torch.Tensor,
                     stacked: bool = False) -> Optional[torch.Tensor]:
        """The item-id embeddings by the explicit all-to-all
        (``parallel.sharded_embedding.sharded_lookup_a2a``), under the JAX
        package's conditions: a dense ``item_emb`` row-sharded on a mesh
        with data > 1 and model = seq = pipe = 1 (a sparse-trained table is
        a ``GatheredRows``, a table at packed scale trains sparse); None
        elsewhere. The count of ids that overflowed their bucket (zero rows,
        dropped gradients) goes to the enclosing :class:`ep_overflow_scope`.
        ``stacked``: ids [S, cap] of the stacked tower-dedup plan, row d
        sent by data shard d (a local mesh runs them in one call)."""
        tbl = params["item_emb"]
        if not isinstance(tbl, ShardedTable):
            return None
        shape = tbl.mesh.shape
        if shape.get("data", 1) <= 1 or any(
                shape.get(a, 1) != 1 for a in ("model", "seq", "pipe")) or (
                self.cfg.pack_big_tables and is_packed_scale(
                    self.itemnum + 1, self.cfg.hidden_units)):
            return None
        rows = list(enumerate(ids)) if stacked else [(0, ids)]
        outs = []
        for d, r in rows:
            emb, ovf = sharded_lookup_a2a(tbl.mesh, tbl, r,
                                          return_overflow=True, sender=d)
            acc = _EP_OVERFLOW_ACC.get()
            if acc is not None:
                acc.append(ovf)
            outs.append(emb)
        emb = torch.stack(outs) if stacked else outs[0]
        return emb.to(E.torch_dtype(self.cfg.dtype))

    def item_embeddings(self, params: Mapping, ids: torch.Tensor,
                        item_sparse: torch.Tensor, item_array: torch.Tensor,
                        mm_tables: Mapping[str, torch.Tensor],
                        mm_override: Optional[Mapping[str, torch.Tensor]]
                        = None, lookup_site: Optional[str] = None,
                        ep: bool = False,
                        item_emb_override: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Item tower on explicit ids + features; ``mm_override`` supplies
        explicit multimodal vectors, else they are gathered by id.
        ``lookup_site`` names the call site for sparse-training plans;
        ``ep`` routes the id lookup through :meth:`_ep_override` where it
        applies (the JAX package's sites that pass the mesh);
        ``item_emb_override`` gives the id embeddings outright."""
        mm_vecs = mm_override if mm_override is not None else \
            E.gather_mm(mm_tables, ids, self.schema,
                        dtype=E.torch_dtype(self.cfg.dtype))
        if item_emb_override is None and ep:
            item_emb_override = self._ep_override(params, ids)
        return E.item_tower(params, ids, item_sparse, item_array, mm_vecs,
                            self.fused, self.schema, self.cfg,
                            lookup_site=lookup_site,
                            item_emb_override=item_emb_override)

    def dedup_spreads(self, params: Mapping, batch: Mapping,
                      mm_tables: Mapping[str, torch.Tensor]):
        """Tower-dedup candidate embeddings (``train.tower_dedup``): the
        item tower runs ONCE on the batch's unique candidate ids
        (``dedup_uids`` and their features, gathered on the host by
        trainer.augment_batch_dedup) and its [cap, D] rows spread to each
        consumer site by its host plan (ops/sparse_table.planned_lookup).
        Returns (it_seq [B, L, D], pos_last [B, 1, D], negs: [B, L, D]
        under BCE, the sampled negatives [N, D] under sampled softmax).

        The stacked plan of a data mesh (``dedup_uids`` [S, cap], every plan
        leaf [S, ...]) runs one tower over the S x cap rows and each shard's
        spreads over its own rows, which concatenate in data order into the
        global batch's rows. Its shared sampled-softmax negatives have no
        plan: ``negs`` is None there, and the caller towers them itself."""
        uids = batch["dedup_uids"]

        def flat(t):   # the stacked plan's [S, cap, ...] as [S * cap, ...]
            return t if uids.dim() == 1 else t.flatten(0, 1)

        ep = self._ep_override(params, uids, stacked=uids.dim() == 2)
        tu = self.item_embeddings(params, flat(uids),
                                  flat(batch["dedup_sparse"]),
                                  flat(batch["dedup_array"]), mm_tables,
                                  lookup_site="dedup",
                                  item_emb_override=None if ep is None
                                  else flat(ep))

        def spread(site):
            if f"dedup_{site}_idx" not in batch:
                return None
            plan = [batch[f"dedup_{site}_{k}"] for k in
                    ("idx", "perm", "starts", "ends")]
            if uids.dim() == 1:
                return planned_lookup(tu, *plan)
            tus = tu.reshape(uids.shape + tu.shape[-1:])
            return torch.cat([planned_lookup(tus[s], *(p[s] for p in plan))
                              for s in range(uids.shape[0])])

        return spread("seq"), spread("pos_last"), spread("negs")

    def log2feats(self, params: Mapping, batch: Mapping,
                  mm_tables: Mapping[str, torch.Tensor], train: bool = False,
                  gen: Optional[torch.Generator] = None,
                  return_item_tower: bool = False,
                  item_tower_override: Optional[torch.Tensor] = None,
                  mesh=None):
        """The encoder's output [B, L, D] (and the sequence's item tower,
        ``return_item_tower``). Spans: ``towers`` (the lookups and fusion
        towers) and ``blocks`` (the attention blocks and the last
        LayerNorm)."""
        ep = None
        with TRC.span("towers"):
            if item_tower_override is None:
                ep = self._ep_override(params, torch.where(
                    batch["token_type"] == 1, batch["seq"],
                    torch.zeros_like(batch["seq"])))
            fused_out = E.fuse_sequence(
                params, batch, mm_tables, self.fused, self.schema, self.cfg,
                return_item_tower=return_item_tower,
                item_tower_override=item_tower_override,
                item_emb_override=ep)
        fused_emb, it_seq = fused_out if return_item_tower \
            else (fused_out, None)
        with TRC.span("blocks"):
            out = ENC.encode(params, fused_emb, batch["seq"],
                             batch["token_type"], params["pos_emb"],
                             self.cfg, train=train, gen=gen, mesh=mesh)
        return (out, it_seq) if return_item_tower else out

    def forward(self, params: Mapping, batch: Mapping,
                mm_tables: Mapping[str, torch.Tensor],
                item_tables: Mapping[str, torch.Tensor], train: bool = True,
                gen: Optional[torch.Generator] = None, mesh=None,
                spreads: Optional[Tuple[torch.Tensor, ...]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(log_feats [B, L, D], pos_embs, neg_embs). The positives' tower
        is the sequence item tower shifted by one (``pos[idx] ==
        seq[idx+1]`` with the same features by construction), so only the
        final target column runs its own tower. Negative-item features are
        gathered on the device from the static item tables by id.
        ``spreads``: these rows' (it_seq, pos_last, negs) of a tower-dedup
        plan already spread (a data shard's slice of the stacked plan's)."""
        if spreads is None and "dedup_uids" in batch:
            spreads = self.dedup_spreads(params, batch, mm_tables)
        if spreads is not None:
            it_seq, pos_last, neg_embs = spreads
            log_feats = self.log2feats(params, batch, mm_tables, train=train,
                                       gen=gen, item_tower_override=it_seq,
                                       mesh=mesh)
            pos_embs = torch.cat([it_seq[:, 1:], pos_last], dim=1)
            return log_feats, pos_embs, neg_embs
        log_feats, it_seq = self.log2feats(params, batch, mm_tables,
                                           train=train, gen=gen,
                                           return_item_tower=True, mesh=mesh)
        pos_last = self.pos_last(params, batch, mm_tables)
        pos_embs = torch.cat([it_seq[:, 1:].to(pos_last.dtype), pos_last],
                             dim=1)
        neg_embs = self.candidates(params, batch["neg"], mm_tables,
                                   item_tables, "posneg", ep=True)
        return log_feats, pos_embs, neg_embs

    def pos_last(self, params: Mapping, batch: Mapping,
                 mm_tables: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The final target column's item tower [B, 1, D]."""
        return self.item_embeddings(
            params, batch["pos"][:, -1:], batch["pos_item_sparse"][:, -1:],
            batch["pos_item_array"][:, -1:], mm_tables,
            lookup_site="pos_last", ep=True)

    def candidates(self, params: Mapping, ids: torch.Tensor,
                   mm_tables: Mapping[str, torch.Tensor],
                   item_tables: Mapping[str, torch.Tensor],
                   lookup_site: str, ep: bool = False) -> torch.Tensor:
        """Item tower on candidate ids whose features are gathered on the
        device from the static item tables by id (``embedding.static_take``:
        ids clamped to the tables, which may hold fewer rows than the item
        table; a table row-sharded on a data mesh looked up across its
        shards); ``ep`` as :meth:`item_embeddings`'s."""
        return self.item_embeddings(
            params, ids, E.static_take(item_tables["sparse"], ids),
            E.static_take(item_tables["array"], ids), mm_tables,
            lookup_site=lookup_site, ep=ep)

    def logits(self, params: Mapping, batch: Mapping,
               mm_tables: Mapping[str, torch.Tensor],
               item_tables: Mapping[str, torch.Tensor], train: bool = True,
               gen: Optional[torch.Generator] = None, mesh=None,
               spreads: Optional[Tuple[torch.Tensor, ...]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(pos_logits, neg_logits, loss_mask): dot products masked to
        next-item positions (and to real samples of a padded batch); the
        encoder on ``mesh`` (see ``models.encoder.encode``); ``spreads`` as
        :meth:`forward`'s."""
        log_feats, pos_embs, neg_embs = self.forward(
            params, batch, mm_tables, item_tables, train=train, gen=gen,
            mesh=mesh, spreads=spreads)
        loss_mask = batch["next_token_type"] == 1
        if "sample_valid" in batch:
            loss_mask = loss_mask & (batch["sample_valid"][:, None] > 0)
        pos_logits = (log_feats * pos_embs).sum(-1)
        neg_logits = (log_feats * neg_embs).sum(-1)
        m = loss_mask.to(pos_logits.dtype)
        return pos_logits * m, neg_logits * m, loss_mask

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
