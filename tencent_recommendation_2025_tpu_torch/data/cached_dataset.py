"""Packed sample cache: build each user's sample once, vector-sample negatives.

Counterpart of ``tencent_recommendation_2025_tpu/data/cached_dataset.py``
(numpy only), for one process: no host sharding.

Everything the train sampler produces is deterministic per user EXCEPT the
negative ids (SURVEY.md §3.3): sequence interleaving, left-padding, feature
packing and positives never change across epochs. The reference re-runs the
whole python ``__getitem__`` every epoch (``dataset.py:96-169``). Here:

- a :class:`PackedCache` runs the TrainSampler once per user (threaded) and
  stores the fixed fields as big contiguous arrays ([U, L, ...]);
- each epoch, batches are plain array slices plus **vectorized rejection
  sampling** for negatives: draw uniforms for every prediction position at
  once, reject collisions with the user's seen-item set and featureless
  ids, redraw only the rejected lanes (a handful of rounds suffice;
  leftovers fall back to a guaranteed-valid draw).

The negative distribution matches the reference's loop exactly: uniform over
valid ids conditioned on rejection. The negative stream is keyed on (seed,
epoch, batch), as in the JAX package, so the same seed gives the same
batches.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from .dataset import TrainSampler

Batch = Dict[str, np.ndarray]

_FIXED_FIELDS = ("seq", "pos", "token_type", "next_token_type",
                 "next_action_type", "seq_item_sparse", "seq_item_array",
                 "seq_user_sparse", "seq_user_array", "pos_item_sparse",
                 "pos_item_array")


class SeenCSR:
    """Sorted-CSR seen-item membership (full-history sets, reference ``ts``
    semantics, ``dataset.py:137-141``): a values array, per-user offsets and
    a per-user binary search. ``seen[u]`` materialises one user's
    frozenset."""

    def __init__(self, vals: np.ndarray, offs: np.ndarray):
        assert offs.ndim == 1 and offs[-1] == len(vals)
        self.vals = vals            # sorted within each user segment
        self.offs = offs

    @classmethod
    def from_sets(cls, seen_iter) -> "SeenCSR":
        segs = [np.sort(np.asarray([i for i in s if i > 0], np.int32))
                for s in seen_iter]
        offs = np.zeros(len(segs) + 1, np.int64)
        np.cumsum([len(s) for s in segs], out=offs[1:])
        vals = np.concatenate(segs) if segs else np.zeros(0, np.int32)
        return cls(vals.astype(np.int32), offs)

    def __len__(self) -> int:
        return len(self.offs) - 1

    def __getitem__(self, u: int) -> frozenset:
        return frozenset(self.vals[self.offs[u]:self.offs[u + 1]].tolist())

    def contains(self, uids: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """[B, ...] bool: ids[b, ...] in user uids[b]'s seen set (exact)."""
        out = np.zeros(ids.shape, bool)
        for b, u in enumerate(np.asarray(uids)):
            seg = self.vals[self.offs[u]:self.offs[u + 1]]
            if len(seg):
                j = np.minimum(np.searchsorted(seg, ids[b]), len(seg) - 1)
                out[b] = seg[j] == ids[b]
        return out


class PackedCache:
    """All users' fixed sample fields packed into contiguous arrays."""

    def __init__(self, sampler: TrainSampler, num_workers: int = 16):
        self.sampler = sampler

        def build(uid):
            return sampler.sample(uid, np.random.default_rng((0, uid)),
                                  return_seen=True)

        with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
            pairs = list(pool.map(build, range(len(sampler))))
        self.fields: Dict[str, np.ndarray] = {
            name: np.stack([getattr(s, name) for s, _ in pairs])
            for name in _FIXED_FIELDS}
        # "seen" is the FULL-history item set (reference ts,
        # dataset.py:137-141), not the maxlen window
        self.seen_sets = SeenCSR.from_sets(seen for _, seen in pairs)
        self.neg_ok = sampler._neg_ok.copy()
        self.itemnum = sampler.itemnum

    def __len__(self) -> int:
        return len(self.seen_sets)

    def sample_negatives(self, uids: np.ndarray, rng: np.random.Generator,
                         rounds: int = 8) -> np.ndarray:
        """[B, L] negatives for the given users (0 where no prediction)."""
        pos = self.fields["pos"][uids]
        B, L = pos.shape
        neg = np.zeros((B, L), np.int32)
        pending = pos > 0
        for _ in range(rounds):
            if not pending.any():
                break
            draw = rng.integers(1, self.itemnum + 1, (B, L))
            accept = pending & self.neg_ok[draw] \
                & ~self.seen_sets.contains(uids, draw)
            neg = np.where(accept, draw, neg)
            pending &= ~accept
        # leftovers (unlucky draws): exact per-position redraw
        for b, l in zip(*np.nonzero(pending)):
            seen = self.seen_sets[int(uids[b])]
            t = int(rng.integers(1, self.itemnum + 1))
            while t in seen or not self.neg_ok[t]:
                t = int(rng.integers(1, self.itemnum + 1))
            neg[b, l] = t
        return neg

    def batch(self, uids: np.ndarray, batch_size: int,
              rng: np.random.Generator) -> Batch:
        """The users' fixed fields and fresh negatives, zero-padded to
        ``batch_size`` rows (``sample_valid`` marks the real ones)."""
        n = len(uids)
        out: Batch = {}
        for name, arr in self.fields.items():
            take = arr[uids]
            if n < batch_size:
                pad = np.zeros((batch_size - n, *take.shape[1:]), take.dtype)
                take = np.concatenate([take, pad])
            out[name] = take
        neg = self.sample_negatives(uids, rng)
        if n < batch_size:
            neg = np.concatenate(
                [neg, np.zeros((batch_size - n, neg.shape[1]), np.int32)])
        out["neg"] = neg
        out["sample_valid"] = (np.arange(batch_size) < n).astype(np.int32)
        return out


class CachedTrainLoader:
    """Drop-in replacement for ``pipeline.TrainLoader`` backed by a
    :class:`PackedCache`. Batches build on a small thread pool (numpy's
    fancy-index copies and rejection-sampling ufuncs release the GIL);
    negatives draw from a per-batch key ``(seed, epoch, b)``, so the stream
    does not depend on worker scheduling; at most ``num_workers + 1``
    batches are in flight."""

    #: ``train_loop`` hands its host prep (tower dedup) to :meth:`epoch`,
    #: which runs it on the worker pool beside the batch build
    supports_prep = True

    def __init__(self, cache: PackedCache, indices: np.ndarray,
                 batch_size: int, seed: int = 0, shuffle: bool = True,
                 num_workers: int = 4):
        self.cache = cache
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:
        return -(-len(self.indices) // self.batch_size)

    def epoch(self, epoch_idx: int, prep=None) -> Iterator[Batch]:
        order = self.indices.copy()
        rng = np.random.default_rng((self.seed, epoch_idx))
        if self.shuffle:
            rng.shuffle(order)
        n = len(self)

        def build(b):
            uids = order[b * self.batch_size:(b + 1) * self.batch_size]
            batch = self.cache.batch(uids, self.batch_size,
                                     np.random.default_rng(
                                         (self.seed, epoch_idx, b)))
            return prep(batch, b) if prep is not None else batch

        # one batch in flight before the first yield, topped up after each,
        # so a consumer that takes one batch builds no speculative ones
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            inflight: deque = deque()
            next_b = 0
            if n:
                inflight.append(pool.submit(build, 0))
                next_b = 1
            while inflight:
                yield inflight.popleft().result()
                while next_b < n and len(inflight) <= self.num_workers:
                    inflight.append(pool.submit(build, next_b))
                    next_b += 1
