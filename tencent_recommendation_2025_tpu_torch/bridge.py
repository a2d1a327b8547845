"""Parameters from the JAX package into the port.

:func:`params_from_jax` takes either a pytree of arrays (``SeqRecModel.init``
output of the JAX package passed through ``np.asarray``) or a checkpoint
directory, and returns the port's nested parameter dict on a device. The
names are the JAX pytree's own, blocks stacked along a leading
``[num_blocks]`` axis, so the mapping is one to one. :func:`tree_from_jax`
does the same for a tree of dicts and lists (the RQ-VAE tokenizer and its
decode head), keeping the lists.

Checkpoint layout (``train/checkpoint.py`` of both packages): ``manifest.json``
lists every leaf with its tree ``path``, ``file``, ``shape`` and ``dtype``,
or with ``shards`` (per-extent files) for a mesh-sharded leaf; leaves of a
train state's parameters have paths starting with ``0/``, its optimizer
state ``1/`` (:func:`opt_state_from_jax` reads a JAX-written one) and its
step ``2``. A table of 30M+ rows is stored packed as [V/R, 8, 128],
row-major, and unpacks as ``reshape(-1, D)[:itemnum + 1]``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

MANIFEST_FILE = "manifest.json"


def _to_numpy(leaf, dtype_name: Optional[str] = None) -> np.ndarray:
    arr = np.asarray(leaf)
    if (dtype_name or arr.dtype.name) == "bfloat16":
        return arr.view(np.uint16)        # reinterpreted by _to_torch
    return arr


def _to_torch(arr: np.ndarray, bf16: bool, device) -> torch.Tensor:
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def is_packed(arr) -> bool:
    return arr.ndim == 3 and tuple(arr.shape[1:]) == (8, 128)


def unpack_table(arr: np.ndarray, dim: int,
                 rows: Optional[int] = None) -> np.ndarray:
    """Packed [V/R, 8, 128] -> [V, dim] (first ``rows`` rows)."""
    out = arr.reshape(-1, dim)
    return out[:rows] if rows is not None else out


def _load_entry(path: Path, e: dict) -> np.ndarray:
    if "shards" not in e:
        return _to_numpy(np.load(path / e["file"], allow_pickle=False),
                         e.get("dtype"))
    dtype = np.uint16 if e["dtype"] == "bfloat16" else np.dtype(e["dtype"])
    out = np.zeros(tuple(e["shape"]), dtype)
    for s in e["shards"]:
        sl = tuple(slice(a, b) for a, b in s["index"])
        out[sl] = _to_numpy(np.load(path / s["file"]), e["dtype"])
    return out


def read_checkpoint_leaves(path) -> Dict[str, tuple]:
    """{param path: (numpy array, is_bf16)} of a checkpoint directory's
    parameter leaves (the ``0/`` subtree of a train state, or every leaf of
    a bare parameter tree)."""
    path = Path(path)
    manifest = json.loads((path / MANIFEST_FILE).read_text())
    entries = manifest["leaves"]
    state = any(e["path"].startswith("0/") for e in entries)
    out = {}
    for e in entries:
        p = e["path"]
        if state:
            if not p.startswith("0/"):
                continue
            p = p[2:]
        out[p] = (_load_entry(path, e), e["dtype"] == "bfloat16")
    return out


def _flatten(tree, prefix=""):
    if isinstance(tree, Mapping):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest(flat: Dict[str, object]) -> Dict:
    root: Dict = {}
    for p, v in flat.items():
        node = root
        *parents, last = p.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = v
    return root


def params_from_jax(src, device="cpu", itemnum: Optional[int] = None
                    ) -> Dict:
    """The port's parameter dict from a JAX parameter pytree or checkpoint
    directory. A packed ``item_emb`` (the only table the JAX package packs)
    unpacks to [Vp, D], its padded rows: the port's own layout of a table
    it trains sparsely at packed scale. With ``itemnum`` it keeps the
    ``itemnum + 1`` addressable rows only (serving)."""
    if isinstance(src, (str, Path)):
        flat = read_checkpoint_leaves(src)
    else:
        flat = {p: (_to_numpy(v), np.asarray(v).dtype.name == "bfloat16")
                for p, v in _flatten(src).items()}
    out = {}
    for p, (arr, bf16) in flat.items():
        if p == "item_emb" and is_packed(arr):
            arr = unpack_table(arr, flat["pos_emb"][0].shape[1],
                               itemnum + 1 if itemnum is not None else None)
        out[p] = _to_torch(arr, bf16, device)
    return _nest(out)


def opt_state_from_jax(path, device="cpu", dim: Optional[int] = None
                       ) -> Dict:
    """The optimizer state of a train state the JAX trainer wrote, in the
    port's terms, read by leaf path from the checkpoint's manifest:

    - ``step``: the train state's step (leaf ``2``);
    - ``count``, ``exp_avg``, ``exp_avg_sq`` ({param path: tensor}): optax's
      ``ScaleByAdamState`` (``count``, ``mu``, ``nu``), the first state of
      ``optax.adam`` / ``adamw`` over every parameter (``1/0/...``) or over
      the dense ones beside sparse tables (``1/dense/0/...``): AdamW's
      ``step``, ``exp_avg`` and ``exp_avg_sq``;
    - ``schedule_count``: the count of the learning-rate schedule's state
      (``1/<i>/count``, i >= 1), None for a constant rate;
    - ``tables`` ({table: {"mu", "nu"} or {"acc"}}): the row optimizers'
      state (``1/tables/<table>/<key>``); a packed table's moments
      ([V/R, 8, 128]) unpack to the port's [Vp, ``dim``].

    Any other leaf raises: it is an optimizer the port does not mirror."""
    path = Path(path)
    entries = json.loads((path / MANIFEST_FILE).read_text())["leaves"]
    leaves = {e["path"]: e for e in entries if not e["path"].startswith("0/")}
    if "2" not in leaves:
        raise ValueError(f"{path} holds no train state (no step leaf '2')")
    pre = "1/dense/" if any(p.startswith("1/dense/") for p in leaves) \
        else "1/"

    def load(e, shape=None):
        arr = _load_entry(path, e)
        if shape is not None:
            arr = arr.reshape(shape)
        return _to_torch(arr, e["dtype"] == "bfloat16", device)

    out = {"step": int(_load_entry(path, leaves["2"])), "count": None,
           "schedule_count": None, "exp_avg": {}, "exp_avg_sq": {},
           "tables": {}}
    for p, e in leaves.items():
        if p == "2":
            continue
        if p.startswith("1/tables/"):
            name, key = p[len("1/tables/"):].split("/")
            packed = e["shape"][1:] == [8, 128] and len(e["shape"]) == 3
            out["tables"].setdefault(name, {})[key] = load(
                e, (-1, dim) if packed else None)
        elif p == pre + "0/count":
            out["count"] = int(_load_entry(path, e))
        elif p.startswith(pre + "0/mu/"):
            out["exp_avg"][p[len(pre + "0/mu/"):]] = load(e)
        elif p.startswith(pre + "0/nu/"):
            out["exp_avg_sq"][p[len(pre + "0/nu/"):]] = load(e)
        elif p.startswith(pre) and p.endswith("/count") and \
                p[len(pre):-len("/count")].isdigit():
            out["schedule_count"] = int(_load_entry(path, e))
        else:
            raise ValueError(f"optimizer leaf {p!r} of {path} is not an "
                             "optax adam / adamw state or a row optimizer's")
    if out["count"] is None:
        raise ValueError(f"{path} holds no optax adam state ({pre}0/count)")
    return out


def _listify(tree):
    """Dicts whose keys are the positions 0..n-1 (a list's tree path
    parts) back to lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _listify(v) for k, v in tree.items()}
    if out and sorted(out) == sorted(str(i) for i in range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def tree_from_jax(src, device="cpu"):
    """The port's tensors from a JAX pytree of dicts and lists (the
    ``{"rq": ..., "head": ...}`` trees of ``models/rqvae.py``) or from a
    checkpoint directory of one: the same nest on ``device``, its ``enc``,
    ``dec`` and ``heads`` lists kept as lists."""
    if isinstance(src, (str, Path)):
        return _listify(_nest({p: _to_torch(arr, bf16, device)
                               for p, (arr, bf16)
                               in read_checkpoint_leaves(src).items()}))
    if isinstance(src, Mapping):
        return {k: tree_from_jax(v, device) for k, v in src.items()}
    if isinstance(src, (list, tuple)):
        return [tree_from_jax(v, device) for v in src]
    arr = np.asarray(src)
    return _to_torch(_to_numpy(arr), arr.dtype.name == "bfloat16", device)
