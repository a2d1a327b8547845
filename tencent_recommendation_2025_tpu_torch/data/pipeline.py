"""Streaming input pipeline: sampling -> fixed-shape batches -> prefetch.

A host-side streaming loader: worker threads build samples (the python-side
sampling logic is the reference's bottleneck — SURVEY.md §3.1 "HOT"), batches
are stacked into a struct-of-arrays dict of numpy arrays with **fixed**
shapes, and the last partial batch is padded (padded rows have
``token_type == 0`` everywhere so they contribute nothing to the loss).
:func:`prefetch` builds and moves batch N+1 on a thread while N computes.

Per-host sharding for multi-host DP: each host takes an interleaved slice of
the user index space (``indices[host_id::num_hosts]``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .dataset import TestSampler, TrainSample, TrainSampler

Batch = Dict[str, np.ndarray]

_TRAIN_FIELDS = [f.name for f in dataclasses.fields(TrainSample)]


def collate_train(samples: Sequence[TrainSample], batch_size: int) -> Batch:
    """Stack samples into a fixed-[B,...] batch, zero-padding short batches."""
    out: Batch = {}
    n = len(samples)
    for name in _TRAIN_FIELDS:
        first = getattr(samples[0], name)
        stacked = np.zeros((batch_size, *first.shape), dtype=first.dtype)
        for i, s in enumerate(samples):
            stacked[i] = getattr(s, name)
        out[name] = stacked
    out["sample_valid"] = (np.arange(batch_size) < n).astype(np.int32)
    return out


def train_val_split(n: int, valid_fraction: float, seed: int):
    """The reference's 90/10 random split (``main.py:72``), seeded."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_valid = int(round(n * valid_fraction))
    return perm[n_valid:], perm[:n_valid]


class TrainLoader:
    """Iterates epochs of fixed-shape batches with threaded sample building."""

    def __init__(self, sampler: TrainSampler, indices: np.ndarray,
                 batch_size: int, seed: int = 0, shuffle: bool = True,
                 num_workers: int = 8, host_id: int = 0, num_hosts: int = 1,
                 drop_remainder: bool = False):
        self.sampler = sampler
        self.indices = np.asarray(indices)[host_id::num_hosts]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_remainder = drop_remainder

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def epoch(self, epoch_idx: int) -> Iterator[Batch]:
        order = self.indices.copy()
        rng = np.random.default_rng((self.seed, epoch_idx))
        if self.shuffle:
            rng.shuffle(order)
        n_batches = len(self)

        def build(uid_and_key):
            uid, key = uid_and_key
            return self.sampler.sample(int(uid), np.random.default_rng(key))

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(n_batches):
                uids = order[b * self.batch_size:(b + 1) * self.batch_size]
                keys = [(self.seed, epoch_idx, b, j) for j in range(len(uids))]
                samples = list(pool.map(build, zip(uids, keys)))
                yield collate_train(samples, self.batch_size)


class TestLoader:
    """Fixed-shape batches of test samples; returns (batch, user_ids, n_valid)."""

    __test__ = False  # not a pytest class

    def __init__(self, sampler: TestSampler, batch_size: int,
                 num_workers: int = 8):
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __len__(self) -> int:
        return -(-len(self.sampler) // self.batch_size)

    def __iter__(self):
        n = len(self.sampler)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(len(self)):
                idxs = range(b * self.batch_size,
                             min((b + 1) * self.batch_size, n))
                samples = list(pool.map(self.sampler.sample, idxs))
                n_valid = len(samples)
                user_ids = [s.user_id for s in samples]
                out: Batch = {}
                for name in ("seq", "token_type", "seq_item_sparse",
                             "seq_item_array", "seq_user_sparse",
                             "seq_user_array"):
                    first = getattr(samples[0], name)
                    stacked = np.zeros((self.batch_size, *first.shape),
                                       dtype=first.dtype)
                    for i, s in enumerate(samples):
                        stacked[i] = getattr(s, name)
                    out[name] = stacked
                yield out, user_ids, n_valid


def prefetch(iterator: Iterator, put: Callable, size: int = 2) -> Iterator:
    """Double-buffered prefetch: a producer thread builds the next batches
    and applies ``put`` (the move to the device) while the consumer
    computes. A producer error is raised on the consumer side; closing the
    generator early stops the producer within ~0.1 s."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    class _Err:
        def __init__(self, e):
            self.e = e

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if stop.is_set() or not offer(put(item)):
                    return
            offer(end)
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            offer(_Err(e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, _Err):
                raise item.e
            yield item
    finally:
        stop.set()
        t.join(timeout=5)
