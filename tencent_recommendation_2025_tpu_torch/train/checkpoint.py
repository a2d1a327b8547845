"""Checkpoints, inference half: find, load and write model parameters.

Counterpart of ``tencent_recommendation_2025_tpu/train/checkpoint.py``, with
its directory contract: ``global_step{N}.valid_loss={v}/`` holding one
``.npy`` per leaf, ``manifest.json`` (leaf tree paths, files, shapes,
dtypes) and ``meta.json`` (step, loss and the model config). Parameters sit
under the ``0/`` subtree, where a train state keeps them. Loading checks
the saved model config against the model's, as the JAX package does.
Optimizer state and training resume belong to the training slice.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
from pathlib import Path
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from ..bridge import _flatten, params_from_jax

MANIFEST_FILE = "manifest.json"
META_FILE = "meta.json"

# config keys that change only storage layout, not the trained function
_LAYOUT_KEYS = ("pack_big_tables",)


def _config_dict(model_config) -> Optional[dict]:
    if model_config is None:
        return None
    if dataclasses.is_dataclass(model_config):
        return dataclasses.asdict(model_config)
    return dict(model_config)


def _check_config(meta: dict, model_config) -> None:
    want = _config_dict(model_config)
    have = meta.get("model_config")
    if want is None or have is None:
        return
    skew = {k: (have.get(k), want.get(k))
            for k in set(have) | set(want)
            if have.get(k) != want.get(k) and k not in _LAYOUT_KEYS}
    if skew:
        detail = ", ".join(f"{k}: ckpt={a!r} vs model={b!r}"
                           for k, (a, b) in sorted(skew.items()))
        raise ValueError(
            f"checkpoint was trained with a different model config — {detail}")


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    """The newest complete checkpoint by the global_step in its dir name."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best, best_step = None, -1
    for d in ckpt_dir.iterdir():
        if d.name.endswith(".tmp"):
            continue
        m = re.match(r"global_step(\d+)", d.name)
        if m and (d / MANIFEST_FILE).exists():
            step = int(m.group(1))
            if step > best_step:
                best, best_step = d, step
    return best


def _leaf_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_params(ckpt_dir, params: Mapping, global_step: int = 0,
                valid_loss: float = 0.0, model_config=None) -> Path:
    """Write ``params`` as a checkpoint the loaders of both packages' layout
    read (``0/...`` leaf paths, manifest, ``meta.json`` with the model
    config). Staged in ``.tmp`` and renamed, so a crash is never picked
    up."""
    out = Path(ckpt_dir) / \
        f"global_step{global_step}.valid_loss={valid_loss:.4f}"
    tmp = out.with_name(out.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    entries = []
    for i, (path, leaf) in enumerate(_flatten(params).items()):
        arr, dtype = _leaf_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        entries.append({"path": f"0/{path}", "file": fname,
                        "shape": list(arr.shape), "dtype": dtype})
    (tmp / MANIFEST_FILE).write_text(json.dumps({"leaves": entries}))
    meta = {"global_step": global_step, "valid_loss": valid_loss}
    cfgd = _config_dict(model_config)
    if cfgd is not None:
        meta["model_config"] = cfgd
    (tmp / META_FILE).write_text(json.dumps(meta))
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)
    return out


def load_params(path, model=None, device="cpu") -> Tuple[dict, dict]:
    """(params, meta) from a checkpoint directory written by either package.
    With ``model`` (a SeqRecModel) the saved model config must match its
    config, and a packed item table keeps its ``itemnum + 1`` rows."""
    path = Path(path)
    meta = {}
    if (path / META_FILE).exists():
        meta = json.loads((path / META_FILE).read_text())
    if not (path / MANIFEST_FILE).exists():
        raise ValueError(f"{path} holds no {MANIFEST_FILE}: the legacy "
                         "single-blob checkpoint layout is not supported")
    if model is not None:
        _check_config(meta, model.cfg)
    params = params_from_jax(path, device=device,
                             itemnum=model.itemnum if model is not None
                             else None)
    return params, meta
