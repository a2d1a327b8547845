"""The system under test: the port's configuration, model and train state,
built from a configuration file and the benchmark's own inputs.

Only this module and the cells import the port
(``tencent_recommendation_2025_tpu_torch``). Weights and tables are the
benchmark's: made on the device from the seed, in a few large calls
(:func:`make_params`), then handed to the program and, untouched copies, to
the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

import numpy as np
import torch

from . import traffic as TF


def port_config(cj: Mapping, batch: int):
    """The port's ``Config``: the preset with every value of the
    configuration file's ``model`` and ``train`` groups and the cell's
    global batch, on the default mesh (one device, or every process of a
    process group on data)."""
    from tencent_recommendation_2025_tpu_torch.config import (MeshConfig,
                                                              PRESETS)

    cfg = PRESETS[cj["preset"]]()
    model = dict(cj["model"])
    train = {k: tuple(v) if isinstance(v, list) else v
             for k, v in cj["train"].items()}
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, **model),
        train=dataclasses.replace(cfg.train, batch_size=batch, **train),
        features=dataclasses.replace(
            cfg.features, mm_emb_ids=tuple(cj["data"]["mm_emb_ids"]),
            array_cap=cj["data"]["array_cap"]),
        mesh=MeshConfig())
    return cfg


def feature_vocab(cj: Mapping) -> Dict[str, int]:
    v = cj["data"]["feature_vocab"]
    return {f: v for f in (*TF.ITEM_SPARSE, *TF.USER_SPARSE,
                           *TF.USER_ARRAY)}


def port_model(cj: Mapping, cfg):
    """The port's ``SeqRecModel`` of the configuration."""
    from tencent_recommendation_2025_tpu_torch.data.featurizer import \
        FusedVocab
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel

    d = cj["data"]
    schema = FeatureSchema(vocab=feature_vocab(cj),
                           mm_emb_ids=tuple(d["mm_emb_ids"]),
                           array_cap=d["array_cap"])
    return SeqRecModel(cfg=cfg.model, schema=schema,
                       fused=FusedVocab.build(schema),
                       usernum=d["usernum"], itemnum=d["itemnum"])


def model_info(cj: Mapping) -> Dict:
    """What the traffic generator needs of a configuration."""
    d = cj["data"]
    return {"maxlen": cj["model"]["maxlen"], "itemnum": d["itemnum"],
            "usernum": d["usernum"], "vocab": feature_vocab(cj),
            "array_cap": d["array_cap"]}


def param_spec(cj: Mapping, item_rows: int):
    """[(path, shape, init)] of the model's parameters, with the
    program's names; ``item_rows``: the item table's rows as the program
    holds it (padded at packed scale). init: "emb" (xavier normal, row 0
    and rows past the items zero), "xavier", "zeros", "ones", "rab"."""
    from ..reference.model import feature_offsets

    m, d = cj["model"], cj["data"]
    D, NB, H = m["hidden_units"], m["num_blocks"], m["num_heads"]
    from .bounds import swiglu_hidden, tower_dims

    F = swiglu_hidden(D, m["ffn_hidden_mult"], m["ffn_multiple_of"])
    userdim, itemdim = tower_dims(D, [32 for _ in d["mm_emb_ids"]])
    spec = [("item_emb", (item_rows, D), "emb"),
            ("user_emb", (d["usernum"] + 1, D), "emb"),
            ("pos_emb", (2 * m["maxlen"] + 1, D), "emb"),
            ("fused_feat", (feature_offsets(d["feature_vocab"])[1], D),
             "emb"),
            ("itemdnn/w", (itemdim, D), "xavier"),
            ("itemdnn/b", (D,), "zeros"),
            ("userdnn/w", (userdim, D), "xavier"),
            ("userdnn/b", (D,), "zeros")]
    for fid in d["mm_emb_ids"]:
        spec += [(f"mm_proj/{fid}/w", (32, D), "xavier"),
                 (f"mm_proj/{fid}/b", (D,), "zeros")]
    spec += [("blocks/attn_ln/scale", (NB, D), "ones"),
             ("blocks/attn_ln/bias", (NB, D), "zeros"),
             ("blocks/ffn_ln/scale", (NB, D), "ones"),
             ("blocks/ffn_ln/bias", (NB, D), "zeros"),
             ("blocks/ffn/w13", (NB, D, 2 * F), "xavier"),
             ("blocks/ffn/w2", (NB, F, D), "xavier"),
             ("blocks/hstu/uvqk/w", (NB, D, 4 * D), "xavier"),
             ("blocks/hstu/uvqk/b", (NB, 4 * D), "zeros"),
             ("blocks/hstu/out/w", (NB, D, D), "xavier"),
             ("blocks/hstu/out/b", (NB, D), "zeros"),
             ("blocks/hstu/attn_ln/scale", (NB, D), "ones"),
             ("blocks/hstu/attn_ln/bias", (NB, D), "zeros"),
             ("blocks/hstu/rab", (NB, H, m["hstu_rel_pos_buckets"]), "rab"),
             ("last_ln/scale", (D,), "ones"),
             ("last_ln/bias", (D,), "zeros")]
    return spec


#: leaves this large are drawn in a call of their own
_OWN_CALL = 1 << 26


def make_params(cj: Mapping, seed: int, device, item_rows: int
                ) -> Dict[str, torch.Tensor]:
    """Parameters (path -> tensor) drawn on ``device`` from ``seed``: one
    draw for all small random leaves, one for each large table. Xavier
    normal std sqrt(2 / (fan_in + fan_out)), fan_in the product of a
    block's leading dims; table rows 0 and past the real rows zero;
    ``rab`` N(0, 0.02^2)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63) ^ 0x5EED)
    real = {"item_emb": cj["data"]["itemnum"] + 1}
    spec = param_spec(cj, item_rows)
    small = [s for s in spec if s[2] != "zeros" and s[2] != "ones"
             and math.prod(s[1]) < _OWN_CALL]
    flat = torch.randn(sum(math.prod(s[1]) for s in small), generator=g,
                       device=device)
    out, at = {}, 0
    for path, shape, init in spec:
        n = math.prod(shape)
        if init == "zeros":
            out[path] = torch.zeros(shape, device=device)
            continue
        if init == "ones":
            out[path] = torch.ones(shape, device=device)
            continue
        if n < _OWN_CALL:
            t = flat[at:at + n].view(shape).clone()
            at += n
        else:
            t = torch.randn(shape, generator=g, device=device)
        if init == "rab":
            t.mul_(0.02)
        else:
            per = shape[1:] if len(shape) == 3 else shape
            rows = real.get(path, per[0])
            fan_in = rows if init == "emb" else per[0]
            t.mul_(math.sqrt(2.0 / (fan_in + per[-1])))
            if init == "emb":
                t[0] = 0.0
                t[rows:] = 0.0
        out[path] = t
    return out


def nest(flat: Mapping[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, t in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return out


def item_rows(cfg, itemnum: int) -> int:
    """The item table's rows as the program holds it."""
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST

    if cfg.model.pack_big_tables and ST.is_packed_scale(
            itemnum + 1, cfg.model.hidden_units):
        return ST.padded_table_rows(itemnum + 1)
    return itemnum + 1


def train_state(cfg, params: Mapping[str, torch.Tensor]):
    """The program's fresh ``TrainState`` over the given tensors (as
    ``trainer.init_state`` builds one, without its copy): dense leaves
    take gradients, the row-sparse tables their row optimizer."""
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    sparse = set(cfg.train.sparse_tables)
    for path, t in params.items():
        if path.split("/")[0] not in sparse:
            t.requires_grad_(True)
    tree = nest(params)
    tables = {n: ST.init_table_opt(tree[n], cfg.train.table_optimizer,
                                   cfg.train.table_moments_dtype)
              for n in cfg.train.sparse_tables}
    return TR.TrainState(tree, TR.make_optimizer(cfg, tree), 0, tables)


def static_tables(cj: Mapping, seed: int, device, host_sparse: bool):
    """The static per-item tables: ``sparse`` [I+1, 14] int32 (the
    features of :func:`traffic.item_sparse`, computed on the device in
    chunks), ``array`` [I+1, 0, cap] and ``mm`` {fid: [I+1, 32] f32}
    drawn on the device (row 0 zero). ``host_sparse``: the sparse table
    on the host too, for the program's host-side tower dedup. Returns an
    ``ItemFeatureTables`` (device tensors; the sparse one numpy where it
    is on the host) and the device tensors."""
    from tencent_recommendation_2025_tpu_torch.data.featurizer import \
        ItemFeatureTables

    d = cj["data"]
    V = d["itemnum"] + 1
    vocab = feature_vocab(cj)
    sparse = torch.empty((V, len(TF.ITEM_SPARSE)), dtype=torch.int32,
                         device=device)
    chunk = 1 << 22
    for lo in range(0, V, chunk):
        ids = torch.arange(lo, min(lo + chunk, V), device=device)
        sparse[lo:lo + len(ids)] = TF.item_sparse(ids, seed, vocab, torch)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63) ^ 0x3A3A)
    mm = {}
    for fid in d["mm_emb_ids"]:
        t = torch.randn((V, 32), generator=g, device=device)
        t[0] = 0.0
        mm[fid] = t
    array = torch.zeros((V, 0, d["array_cap"]), dtype=torch.int32,
                        device=device)
    if host_sparse:
        host = np.empty((V, len(TF.ITEM_SPARSE)), np.int32)
        for lo in range(0, V, chunk):
            host[lo:lo + chunk] = sparse[lo:lo + chunk].cpu().numpy()
        sparse, array = host, array.cpu().numpy()
    return ItemFeatureTables(sparse=sparse, array=array, mm=mm,
                             mm_present={}), {"mm": mm}
