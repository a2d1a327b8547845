"""Sequence sample builders — the reference's sampling semantics, packed.

This reproduces the exact sample semantics of the reference datasets
(``model/BaseLine/dataset.py:96-169`` train, ``:329-389`` test — see
SURVEY.md §3.3): interleave user-profile tokens (type 2, prepended) with item
tokens (type 1, appended), left-pad to ``maxlen+1``, predict only at positions
whose *next* token is an item, sample 1 uniform negative per such position
rejecting the user's seen items and featureless ids.

Unlike the reference, samples are packed straight into fixed-shape int32
arrays (no per-token python dicts survive past this point) and negative-item
features are *not* materialized on the host — they are gathered on device from
the static item tables (featurizer.build_item_tables) by id.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import schema as S
from .featurizer import pack_item_feat, pack_user_feat
from .readers import TencentGRData
from .schema import FeatureSchema


@dataclasses.dataclass
class TrainSample:
    seq: np.ndarray                 # [L] int32 (reid; item or user per token_type)
    pos: np.ndarray                 # [L] int32
    neg: np.ndarray                 # [L] int32
    token_type: np.ndarray          # [L] int32 (0 pad / 1 item / 2 user)
    next_token_type: np.ndarray     # [L] int32
    next_action_type: np.ndarray    # [L] int32
    seq_item_sparse: np.ndarray     # [L, NIS] int32
    seq_item_array: np.ndarray      # [L, NIA, CAP] int32
    seq_user_sparse: np.ndarray     # [L, NUS] int32
    seq_user_array: np.ndarray      # [L, NUA, CAP] int32
    pos_item_sparse: np.ndarray     # [L, NIS] int32
    pos_item_array: np.ndarray      # [L, NIA, CAP] int32


@dataclasses.dataclass
class TestSample:
    seq: np.ndarray
    token_type: np.ndarray
    seq_item_sparse: np.ndarray
    seq_item_array: np.ndarray
    seq_user_sparse: np.ndarray
    seq_user_array: np.ndarray
    user_id: str


from ..config import MAX_USER_TOKENS_PER_ROW as _MAX_USER_TOKENS


def _build_ext_sequence(user_sequence, test_mode: bool, itemnum: int):
    """Reference ``__getitem__`` interleaving: user tokens inserted at the
    front, item tokens appended (``dataset.py:115-121``)."""
    ext = []
    user_id = None
    for record in user_sequence:
        u, i, user_feat, item_feat, action_type = record[0], record[1], record[2], record[3], record[4]
        if test_mode and u:
            # predict files carry the raw string user id (dataset.py:345-350)
            user_id = u if isinstance(u, str) else None
        if u and user_feat:
            uu = 0 if (test_mode and isinstance(u, str)) else u
            ext.insert(0, (uu, user_feat, 2, action_type))
        if i and item_feat:
            ii = i
            if test_mode and i > itemnum:
                ii = 0  # unseen item: id zeroed, features kept (dataset.py:358-364)
            ext.append((ii, item_feat, 1, action_type))
    n_user = sum(1 for e in ext if e[2] == 2)
    if n_user > _MAX_USER_TOKENS:
        raise ValueError(
            f"sequence carries {n_user} user-profile tokens > "
            f"MAX_USER_TOKENS_PER_ROW={_MAX_USER_TOKENS} — the user tower "
            "computes on that many gathered positions per row "
            "(models/embedding.fuse_sequence); raise "
            "config.MAX_USER_TOKENS_PER_ROW for this data layout")
    return ext, user_id


class TrainSampler:
    """Builds TrainSamples from a TencentGRData store."""

    def __init__(self, data: TencentGRData, schema: FeatureSchema, maxlen: int):
        self.data = data
        self.schema = schema
        self.maxlen = maxlen
        self.L = maxlen + 1
        self.itemnum = data.itemnum
        # featureless-id rejection (reference _random_neq, dataset.py:79-94)
        self._neg_ok = np.zeros(self.itemnum + 2, dtype=bool)
        for sid in data.item_feat_dict:
            i = int(sid)
            if 1 <= i <= self.itemnum:
                self._neg_ok[i] = True

    def __len__(self) -> int:
        return len(self.data.seq)

    def _random_neq(self, seen: set, rng: np.random.Generator) -> int:
        t = int(rng.integers(1, self.itemnum + 1))
        while t in seen or not self._neg_ok[t]:
            t = int(rng.integers(1, self.itemnum + 1))
        return t

    def sample(self, uid: int, rng: np.random.Generator,
               return_seen: bool = False) -> TrainSample:
        """``return_seen=True`` additionally returns the FULL-history seen
        set used for negative rejection (reference ``ts``,
        ``model/BaseLine/dataset.py:137-141`` — built from the whole
        ext_user_sequence, NOT the maxlen window; cached loaders must
        reject against this same set to match)."""
        sch = self.schema
        L, cap = self.L, sch.array_cap
        nis, nia = len(S.ITEM_SPARSE_IDS), len(S.ITEM_ARRAY_IDS)
        nus, nua = len(S.USER_SPARSE_IDS), len(S.USER_ARRAY_IDS)

        user_sequence = self.data.seq.load_user(uid)
        ext, _ = _build_ext_sequence(user_sequence, test_mode=False,
                                     itemnum=self.itemnum)

        s = TrainSample(
            seq=np.zeros(L, np.int32), pos=np.zeros(L, np.int32),
            neg=np.zeros(L, np.int32), token_type=np.zeros(L, np.int32),
            next_token_type=np.zeros(L, np.int32),
            next_action_type=np.zeros(L, np.int32),
            seq_item_sparse=np.zeros((L, nis), np.int32),
            seq_item_array=np.zeros((L, nia, cap), np.int32),
            seq_user_sparse=np.zeros((L, nus), np.int32),
            seq_user_array=np.zeros((L, nua, cap), np.int32),
            pos_item_sparse=np.zeros((L, nis), np.int32),
            pos_item_array=np.zeros((L, nia, cap), np.int32),
        )
        if not ext:
            return (s, set()) if return_seen else s

        seen = {t[0] for t in ext if t[2] == 1 and t[0]}
        nxt = ext[-1]
        idx = self.maxlen
        for record in reversed(ext[:-1]):
            i, feat, type_, _act = record
            next_i, next_feat, next_type, next_act = nxt
            s.seq[idx] = i
            s.token_type[idx] = type_
            s.next_token_type[idx] = next_type
            if next_act is not None:
                s.next_action_type[idx] = next_act
            if type_ == 1:
                sp, ar = pack_item_feat(feat, sch)
                s.seq_item_sparse[idx] = sp
                if nia:
                    s.seq_item_array[idx] = ar
            else:
                sp, ar = pack_user_feat(feat, sch)
                s.seq_user_sparse[idx] = sp
                if nua:
                    s.seq_user_array[idx] = ar
            if next_type == 1 and next_i != 0:
                s.pos[idx] = next_i
                sp, ar = pack_item_feat(next_feat, sch)
                s.pos_item_sparse[idx] = sp
                if nia:
                    s.pos_item_array[idx] = ar
                s.neg[idx] = self._random_neq(seen, rng)
            nxt = record
            idx -= 1
            if idx == -1:
                break
        return (s, seen) if return_seen else s


class TestSampler:
    """Builds TestSamples from the predict-side store (cold-start aware)."""

    __test__ = False  # not a pytest class

    def __init__(self, data: TencentGRData, schema: FeatureSchema, maxlen: int):
        self.data = data
        self.schema = schema
        self.maxlen = maxlen
        self.L = maxlen + 1
        self.itemnum = data.itemnum

    def __len__(self) -> int:
        return len(self.data.seq)

    def sample(self, uid: int) -> TestSample:
        sch = self.schema
        L, cap = self.L, sch.array_cap
        nis, nia = len(S.ITEM_SPARSE_IDS), len(S.ITEM_ARRAY_IDS)
        nus, nua = len(S.USER_SPARSE_IDS), len(S.USER_ARRAY_IDS)

        user_sequence = self.data.seq.load_user(uid)
        ext, user_id = _build_ext_sequence(user_sequence, test_mode=True,
                                           itemnum=self.itemnum)
        # non-string reid users resolve through the reverse indexer
        if user_id is None:
            for record in user_sequence:
                if record[0]:
                    user_id = self.data.indexer_u_rev.get(record[0], str(record[0]))
                    break

        s = TestSample(
            seq=np.zeros(L, np.int32), token_type=np.zeros(L, np.int32),
            seq_item_sparse=np.zeros((L, nis), np.int32),
            seq_item_array=np.zeros((L, nia, cap), np.int32),
            seq_user_sparse=np.zeros((L, nus), np.int32),
            seq_user_array=np.zeros((L, nua, cap), np.int32),
            user_id=user_id or "",
        )
        if not ext:
            return s
        idx = self.maxlen
        for record in reversed(ext[:-1]):
            i, feat, type_, _act = record
            s.seq[idx] = i
            s.token_type[idx] = type_
            if type_ == 1:
                sp, ar = pack_item_feat(feat, sch)
                s.seq_item_sparse[idx] = sp
                if nia:
                    s.seq_item_array[idx] = ar
            else:
                sp, ar = pack_user_feat(feat, sch)
                s.seq_user_sparse[idx] = sp
                if nua:
                    s.seq_user_array[idx] = ar
            idx -= 1
            if idx == -1:
                break
        return s
