"""Partition rules: which dim of each parameter shards over the ``model`` axis.

Counterpart of ``tencent_recommendation_2025_tpu/parallel/partition.py``:
the same regex-over-path rules (``PARAM_RULES``, first match wins, the
rules addressing a leaf's trailing dims, the stacked blocks' leading
[num_blocks] axis on ``pipe``), here as plain data. A spec is a tuple with
one entry per leading dim, as ``PartitionSpec``'s: ``None`` (replicated
along it), an axis name, or a tuple of names; missing trailing entries are
replicated.

- **Tables** (``item_emb``, ``user_emb``, ``fused_feat``): row-sharded over
  (pipe, data, model), ``parallel/sharded_embedding.py``'s layout.
- **Tensor parallelism**: the tower DNNs and ``mm_proj`` column-split
  (their biases split); attention q/k/v, the packed HSTU ``uvqk`` and the
  FFN input column-split, their output projections row-split.
- **Replicated**: LayerNorms, ``rab``, ``pos_emb``, the biases of the
  row-split layers.

:func:`shard_params` gives each tensor-parallel leaf's slices and
:func:`whole_params` joins them again. **The packed leaves split per part,
not as contiguous column blocks**: the JAX package shards ``uvqk`` [D, 4D]
and ``w13`` [D, 2F] as contiguous column blocks and lets GSPMD repair the
layout; here model shard m holds its columns of each of u, v, q and k (of
each of w1 and w3), so that every layer runs on its own heads' columns
without a collective. This is a layout change only: the whole leaf, the
function it computes and every number a checkpoint holds are the JAX
package's.

:class:`ModelShards` is a tensor split along the model axis inside a step:
its parts are the shards this process holds (all M on a local mesh, its
own on a process mesh); :func:`tp_view` makes one of every tensor-parallel
leaf of a parameter tree (``models/`` dispatch on it).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from .mesh import TABLE_AXES, gather_model, model_size

# (path regex, spec) -- first match wins. Paths look like "item_emb",
# "blocks/attn/q/w", "mm_proj/81/w", ...
PARAM_RULES: Tuple[Tuple[str, tuple], ...] = (
    (r"^(item_emb|user_emb|fused_feat)$", (TABLE_AXES, None)),
    (r"^pos_emb$", ()),
    (r"^(itemdnn|userdnn|mm_proj/[^/]+)/w$", (None, "model")),
    (r"^(itemdnn|userdnn|mm_proj/[^/]+)/b$", ("model",)),
    # attention: qkv column-split, o row-split
    (r"/attn/(q|k|v)/w$", (None, "model")),
    (r"/attn/(q|k|v)/b$", ("model",)),
    (r"/attn/o/w$", ("model", None)),
    (r"/attn/o/b$", ()),
    # HSTU: packed uvqk column-split, out row-split, rab replicated
    (r"/hstu/uvqk/w$", (None, "model")),
    (r"/hstu/uvqk/b$", ("model",)),
    (r"/hstu/out/w$", ("model", None)),
    (r"/hstu/out/b$", ()),
    (r"/hstu/(rab|attn_ln/.*)$", ()),
    # FFN: in column-split, out row-split
    (r"/ffn/(fc1/w|w13)$", (None, "model")),
    (r"/ffn/fc1/b$", ("model",)),
    (r"/ffn/(fc2/w|w2)$", ("model", None)),
    (r"/ffn/fc2/b$", ()),
    # everything else (layernorms, ...) replicated
    (r".*", ()),
)

#: packed leaves: (path regex, parts along the model dim), each part split
#: over the model shards on its own
PACKED = ((r"/hstu/uvqk/(w|b)$", 4), (r"/ffn/w13$", 2))


def _flat(tree, prefix=""):
    if isinstance(tree, Mapping):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _map(tree, fn, prefix=""):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def match_partition_rules(rules, tree) -> Any:
    """Every leaf of ``tree`` mapped to the spec of the first rule of
    ``rules`` whose regex matches its path: the stacked blocks' leading
    axis on ``pipe``, entries past the leaf's dims dropped."""
    def match(path, leaf):
        ndim = getattr(leaf, "ndim", 0)
        for pattern, spec in rules:
            if re.search(pattern, path):
                if path.startswith("blocks/"):
                    spec = ("pipe",) + tuple(spec)
                return tuple(spec[:ndim]) if len(spec) > ndim \
                    else tuple(spec)
        return ()

    return _map(tree, match)


def param_shardings(params) -> Any:
    """The spec of every parameter leaf (``PARAM_RULES``)."""
    return match_partition_rules(PARAM_RULES, params)


def opt_state_shardings(params) -> Any:
    """The specs of the AdamW moments: each moment shards like its
    parameter (its ``exp_avg`` and ``exp_avg_sq``); the step counts are
    replicated (JAX ``opt_state_shardings``)."""
    specs = param_shardings(params)
    return _map(specs, lambda p, s: {"exp_avg": s, "exp_avg_sq": s})


def model_dim(spec: tuple) -> Optional[int]:
    """The dim of a spec that shards over ``model`` alone (a
    tensor-parallel leaf), None otherwise (the tables' (pipe, data, model)
    rows are the row-sharded layout's, not this one's)."""
    for i, s in enumerate(spec):
        if s == "model":
            return i
    return None


def model_dims(params) -> Dict[str, int]:
    """{path: model dim} of every tensor-parallel leaf of ``params``."""
    out = {}
    for path, spec in _flat(param_shardings(params)).items():
        d = model_dim(spec)
        if d is not None:
            out[path] = d
    return out


def _parts(path: str) -> int:
    for pattern, n in PACKED:
        if re.search(pattern, path):
            return n
    return 1


def shard_slice(t: torch.Tensor, path: str, dim: int, M: int, m: int
                ) -> torch.Tensor:
    """Model shard ``m`` of ``M``'s slice of the leaf (or moment) ``t`` at
    ``path``, along ``dim``: its block of each packed part (a view where
    one part, else a concatenation). Raises where a part does not split
    into M blocks."""
    n = _parts(path)
    width = t.shape[dim]
    if width % (n * M):
        raise ValueError(
            f"{path}: {width} columns in {n} part(s) do not split over "
            f"model={M} shards")
    per = width // n // M
    pieces = [t.narrow(dim, j * (width // n) + m * per, per)
              for j in range(n)]
    return pieces[0] if n == 1 else torch.cat(pieces, dim=dim)


def shard_join(parts: List[torch.Tensor], path: str, dim: int
               ) -> torch.Tensor:
    """The whole leaf from its M model slices, in model order (the inverse
    of :func:`shard_slice`)."""
    n = _parts(path)
    if n == 1:
        return torch.cat(parts, dim=dim)
    split = [p.chunk(n, dim=dim) for p in parts]
    return torch.cat([s[j] for j in range(n) for s in split], dim=dim)


def shard_params(mesh, params) -> Any:
    """``params`` with each tensor-parallel leaf split over ``mesh``'s model
    axis: on a process mesh this process's slice (a copy), on a local mesh
    the list of every shard's slice, in model order (views, or
    concatenations of views for the packed leaves). The tables and the
    replicated leaves are returned as they are."""
    M = model_size(mesh)
    dims = model_dims(params)

    def cut(path, t):
        if path not in dims or M == 1:
            return t
        if mesh.process:
            return shard_slice(t, path, dims[path], M,
                               mesh.model_index).clone()
        return [shard_slice(t, path, dims[path], M, m) for m in range(M)]

    return _map(params, cut)


def whole_params(mesh, shards) -> Any:
    """The inverse of :func:`shard_params`: each tensor-parallel leaf whole
    again (on a process mesh gathered over the model group)."""
    M = model_size(mesh)
    dims = model_dims(_map(shards, lambda p, t: t[0] if isinstance(t, list)
                           else t))

    def join(path, t):
        if path not in dims or M == 1:
            return t
        if isinstance(t, list):
            return shard_join(t, path, dims[path])
        return join_model(mesh, t, path, dims[path])

    return _map(shards, join)


def join_model(mesh, t: torch.Tensor, path: str, dim: int
               ) -> torch.Tensor:
    """The whole leaf (or moment) at ``path`` from this process's model
    slice ``t``: gathered over the model group of a process mesh and
    joined (:func:`shard_join`; no gradient)."""
    return shard_join(gather_model(t, mesh), path, dim)


class ModelShards:
    """A tensor split along the model axis inside a step: ``parts`` the
    shards this process holds, in model order (all M on a local mesh, its
    own on a process mesh), ``mesh`` the mesh whose model group joins
    them."""

    def __init__(self, parts: List[torch.Tensor], mesh):
        self.parts = list(parts)
        self.mesh = mesh

    @property
    def size(self) -> int:
        """M, the model shards of the mesh."""
        return self.mesh.shape["model"]

    def to(self, *a, **k) -> "ModelShards":
        return ModelShards([p.to(*a, **k) for p in self.parts], self.mesh)

    def __getitem__(self, i) -> "ModelShards":
        return ModelShards([p[i] for p in self.parts], self.mesh)

    def map(self, fn, *others) -> "ModelShards":
        """``fn`` over the parts (and the same parts of ``others``,
        ModelShards of the same mesh)."""
        return ModelShards([fn(*ps) for ps in zip(
            self.parts, *(o.parts for o in others))], self.mesh)


def tp_view(params: Mapping, mesh) -> dict:
    """``params`` with every tensor-parallel leaf a :class:`ModelShards`
    on a mesh whose model axis is M > 1: a process mesh's own slice, a
    local mesh's slices of the whole leaf taken here (:func:`shard_params`,
    so that its gradient reaches the leaf); the dict itself otherwise.
    Leaves that are not tensors (a sharded table) pass as they are."""
    if model_size(mesh) == 1:
        return dict(params)
    if mesh.process:
        dims = model_dims(params)
        return _map(params, lambda p, t: ModelShards([t], mesh)
                    if p in dims else t)
    return _map(shard_params(mesh, params), lambda p, t: ModelShards(
        t, mesh) if isinstance(t, list) else t)


def row_parallel(x: ModelShards, w: ModelShards, dtype) -> torch.Tensor:
    """``x @ w`` of a row-split weight: each shard's partial product in f32
    (``x``'s shard against ``w``'s rows, the weight rounded to ``dtype``
    first, as the single device's product reads it), summed over the model
    group in model order (``reduce_from_model``), rounded once to
    ``dtype``: the single device's f32 accumulation of the whole
    product."""
    return x.mesh.reduce_from_model(
        [xm.float() @ wm.to(dtype).float()
         for xm, wm in zip(x.parts, w.parts)]).to(dtype)


def column_parallel(x: torch.Tensor, w: ModelShards,
                    b: Optional[ModelShards] = None) -> ModelShards:
    """``x @ w (+ b)`` of a column-split weight: the replicated input
    behind ``copy_to_model``, each shard's columns of the output."""
    xs = w.mesh.copy_to_model(x)
    if b is None:
        return ModelShards([xm @ wm for xm, wm in zip(xs, w.parts)], w.mesh)
    return ModelShards([xm @ wm + bm for xm, wm, bm in
                        zip(xs, w.parts, b.parts)], w.mesh)
