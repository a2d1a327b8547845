"""The benchmark's one traffic generator.

A traffic mix is a JSON file under ``portbench/traffic/`` that this module
reads; nothing here knows a mix by name. From ``--seed`` it makes:

- per-item and per-user features, a pure function of the id and the seed
  (:func:`item_sparse`, :func:`user_features`), so that the host's and the
  device's copies agree and the program's tower dedup stays exact;
- histories: a leading user token, then item events of a drawn length,
  left-padded to the model's window, items drawn by Zipf popularity over
  the item table, mapped to ids by a seeded bijection; ``neg`` uniform over
  the items (the reference's sampler without its rejection of seen items);
- the program's batch dict, in the layout of its loaders
  (``data/dataset.py`` ``TrainSampler.sample`` and ``collate_train``).

Every seed gets the same multiset of history lengths (a stratified grid
over the mix's range, shuffled), so that the seed changes which items are
drawn and in what order, never how much work a batch holds.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

#: the TencentGR feature registry (the data format): item sparse ids, user
#: sparse ids and user array ids, in the order the batch and the fused
#: table lay them out (items have no array features in the release)
ITEM_SPARSE = ("100", "117", "111", "118", "101", "102", "119",
               "120", "114", "112", "121", "115", "122", "116")
USER_SPARSE = ("103", "104", "105", "109")
USER_ARRAY = ("106", "107", "108", "110")

_P = 2147483647          # 2^31 - 1: every product below fits in int64


def _mix(x, salt: int, xp):
    """A seeded integer hash in [0, P), identical in numpy and torch (in
    64-bit integers whatever the ids' type)."""
    x = x.astype(np.int64) if xp is np else x.long()
    h = (x % _P) * 1103515245 % _P
    h = (h + salt) % _P
    h = h * 48271 % _P
    h = (h + (h >> 13)) % _P
    return h * 69621 % _P


def _salt(seed: int, slot: int, kind: int) -> int:
    return int(np.random.SeedSequence([int(seed) % (1 << 63), slot, kind])
               .generate_state(1, np.uint32)[0]) % _P


def item_sparse(ids, seed: int, vocab: Dict[str, int], xp=np):
    """[..., 14] feature values in [1, vocab] of item ``ids``; zeros for
    id 0 (the padding row). ``xp``: numpy, or torch for tensors."""
    cols = []
    for j, fid in enumerate(ITEM_SPARSE):
        v = _mix(ids, _salt(seed, j, 1), xp) % vocab[fid] + 1
        cols.append(v * (ids > 0))
    return xp.stack(cols, -1) if xp is np else xp.stack(cols, dim=-1)


def user_features(uids, seed: int, vocab: Dict[str, int], cap: int):
    """(sparse [..., 4], array [..., 4, cap]) of user ids (numpy): each
    array feature holds 1 to ``cap`` values, zeros after them."""
    sp = np.stack([(_mix(uids, _salt(seed, j, 2), np) % vocab[f] + 1)
                   * (uids > 0) for j, f in enumerate(USER_SPARSE)], -1)
    arr = np.zeros(uids.shape + (len(USER_ARRAY), cap), np.int64)
    for j, f in enumerate(USER_ARRAY):
        n = _mix(uids, _salt(seed, j, 3), np) % cap + 1
        for c in range(cap):
            v = _mix(uids * cap + c, _salt(seed, j, 4), np) % vocab[f] + 1
            arr[..., j, c] = v * (c < n) * (uids > 0)
    return sp, arr


def zipf_items(rng, n: int, itemnum: int, s: float, seed: int):
    """``n`` item ids whose popularity ranks follow Zipf(s) over
    ``itemnum`` items (inverse CDF of the continuous law, floored), mapped
    to ids by a seeded affine bijection of [0, itemnum)."""
    u = rng.random(n)
    if abs(s - 1.0) < 1e-9:
        r = np.exp(u * np.log(itemnum + 1.0))
    else:
        a = 1.0 - s
        r = ((np.power(itemnum + 1.0, a) - 1.0) * u + 1.0) ** (1.0 / a)
    r = np.clip(np.floor(r).astype(np.int64), 1, itemnum) - 1
    mult = 1000003                      # prime, coprime to 10^k
    while np.gcd(mult, itemnum) != 1:
        mult += 2
    off = _salt(seed, 0, 5) % itemnum
    return (r * mult + off) % itemnum + 1


def history_lengths(rng, batch: int, lo: int, hi: int):
    """A stratified grid of ``batch`` lengths over [lo, hi], shuffled."""
    grid = lo + ((np.arange(batch) + 0.5) * (hi - lo + 1) / batch
                 ).astype(np.int64)
    return rng.permutation(np.minimum(grid, hi))


def make_batch(rng, mix: Dict, model: Dict, seed: int, rows: int,
               train: bool = True) -> Dict[str, np.ndarray]:
    """One batch of ``rows`` histories: the program's train batch (seq,
    pos, neg, token types, per-position features, ``sample_valid``), or
    with ``train=False`` its test batch (seq, token types, features)."""
    L = model["maxlen"] + 1
    itemnum, usernum = model["itemnum"], model["usernum"]
    vocab, cap = model["vocab"], model["array_cap"]
    lens = history_lengths(rng, rows, *mix["history_events"])
    if lens.max() > L:
        raise ValueError(f"histories up to {lens.max()} events exceed the "
                         f"window L={L}")
    seq = np.zeros((rows, L), np.int64)
    pos = np.zeros((rows, L), np.int64)
    tt = np.zeros((rows, L), np.int32)
    uid = rng.integers(1, usernum + 1, rows)
    items = zipf_items(rng, int(lens.sum()), itemnum, mix["zipf_s"], seed)
    at = 0
    for b, n in enumerate(lens):
        ev = items[at:at + n]
        at += n
        # ext = [user, i1 .. in]; seq = ext[:-1], pos = ext[1:], right-aligned
        seq[b, L - n] = uid[b]
        seq[b, L - n + 1:] = ev[:-1]
        pos[b, L - n:] = ev
        tt[b, L - n] = 2
        tt[b, L - n + 1:] = 1
    item_ids = np.where(tt == 1, seq, 0)
    # features of each distinct id once, then spread to the positions
    uniq, inv = np.unique(np.concatenate([item_ids.ravel(), pos.ravel()]),
                          return_inverse=True)
    feats = item_sparse(uniq, seed, vocab).astype(np.int32)[inv]
    n = item_ids.size
    rows_b = np.arange(rows)
    at_user = L - lens
    usp, uarr = user_features(uid, seed, vocab, cap)
    seq_usp = np.zeros((rows, L, len(USER_SPARSE)), np.int32)
    seq_uarr = np.zeros((rows, L, len(USER_ARRAY), cap), np.int32)
    seq_usp[rows_b, at_user] = usp
    seq_uarr[rows_b, at_user] = uarr
    out = {"seq": seq.astype(np.int32), "token_type": tt,
           "seq_item_sparse": feats[:n].reshape(rows, L, -1),
           "seq_item_array": np.zeros((rows, L, 0, cap), np.int32),
           "seq_user_sparse": seq_usp, "seq_user_array": seq_uarr}
    if not train:
        return out
    ntt = (pos > 0).astype(np.int32)
    out.update({
        "pos": pos.astype(np.int32),
        "neg": (rng.integers(1, itemnum + 1, (rows, L)) * ntt
                ).astype(np.int32),
        "next_token_type": ntt,
        "next_action_type": np.zeros((rows, L), np.int32),
        "pos_item_sparse": feats[n:].reshape(rows, L, -1),
        "pos_item_array": np.zeros((rows, L, 0, cap), np.int32),
        "sample_valid": np.ones((rows,), np.int32)})
    return out


def make_batches(mix: Dict, model: Dict, seed: int, rows: int,
                 train: bool = True):
    """The mix's ``batches`` distinct batches of ``rows`` histories, drawn
    from ``seed``: the window cycles through them."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 11])
    return [make_batch(rng, mix, model, seed, rows, train)
            for _ in range(mix["batches"])]
