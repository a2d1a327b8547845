"""Checkpoints: find, write and load parameters and train states.

Counterpart of ``tencent_recommendation_2025_tpu/train/checkpoint.py``, with
its directory contract: ``global_step{N}.valid_loss={v}/`` holding one
``.npy`` per leaf, ``manifest.json`` (leaf tree paths, files, shapes,
dtypes) and ``meta.json`` (step, loss, epoch and the model config).
Parameters sit under the ``0/`` subtree, where a train state keeps them, so
either package's reader finds them. A train state written by the port keeps
its AdamW moments under ``1/<param path>/{exp_avg,exp_avg_sq}``, a
sparse-trained table's row-optimizer state under ``1/tables/<table>/<key>``
(``mu``, ``nu`` or ``acc``) and its step as ``2``, with ``"state_format":
"torch"`` in the meta. A table at packed scale is saved as the port holds
it, [Vp, D] with its pad rows. Loading checks the saved model config
against the model's, as the JAX package does. Reading a JAX-written
optimizer state is not ported yet (ROADMAP Queue 1, Resilience).
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


def _write(ckpt_dir, leaves: Mapping[str, torch.Tensor], meta: dict,
           global_step: int, valid_loss: float) -> Path:
    """One checkpoint directory of ``leaves`` (tree path -> tensor), staged
    in ``.tmp`` and renamed, so a crash is never picked up."""
    out = Path(ckpt_dir) / \
        f"global_step{global_step}.valid_loss={valid_loss:.4f}"
    tmp = out.with_name(out.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    entries = []
    for i, (path, leaf) in enumerate(leaves.items()):
        arr, dtype = _leaf_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        entries.append({"path": path, "file": fname,
                        "shape": list(arr.shape), "dtype": dtype})
    (tmp / MANIFEST_FILE).write_text(json.dumps({"leaves": entries}))
    (tmp / META_FILE).write_text(json.dumps(meta))
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)
    return out


def _meta(global_step, valid_loss, model_config, extra=None) -> dict:
    meta = {"global_step": global_step, "valid_loss": valid_loss}
    meta.update(extra or {})
    cfgd = _config_dict(model_config)
    if cfgd is not None:
        meta["model_config"] = cfgd
    return meta


def save_params(ckpt_dir, params: Mapping, global_step: int = 0,
                valid_loss: float = 0.0, model_config=None) -> Path:
    """Write ``params`` as a checkpoint the loaders of both packages' layout
    read (``0/...`` leaf paths, manifest, ``meta.json`` with the model
    config)."""
    leaves = {f"0/{p}": t for p, t in _flatten(params).items()}
    return _write(ckpt_dir, leaves,
                  _meta(global_step, valid_loss, model_config),
                  global_step, valid_loss)


def save_checkpoint(ckpt_dir, state, global_step: int,
                    valid_loss: float = 0.0, extra_meta: Optional[dict] = None,
                    model_config=None) -> Path:
    """Write a train state (``train.trainer.TrainState``): its parameters
    under ``0/`` as :func:`save_params` does, the AdamW moments and the
    tables' row-optimizer state under ``1/``, the step as ``2``."""
    params = _flatten(state.params)
    leaves = {f"0/{p}": t for p, t in params.items()}
    for p, t in params.items():
        st = state.opt.state.get(t, {})
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                leaves[f"1/{p}/{k}"] = st[k]
    for name, opt in state.tables.items():
        for k, t in opt.items():
            leaves[f"1/tables/{name}/{k}"] = t
    leaves["2"] = torch.tensor(state.step, dtype=torch.int64)
    meta = _meta(global_step, valid_loss, model_config,
                 dict(extra_meta or {}, state_format="torch"))
    return _write(ckpt_dir, leaves, meta, global_step, valid_loss)


def load_checkpoint(path, model, cfg, device="cpu"):
    """(train state, meta) from a checkpoint the port wrote with
    :func:`save_checkpoint` (``path`` a checkpoint directory, or a
    directory holding them: the newest is taken)."""
    from .trainer import dense_leaves, init_state

    path = Path(path)
    if not (path / MANIFEST_FILE).exists():
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        path = found
    params, meta = load_params(path, model, device=device)
    if meta.get("state_format") != "torch":
        raise NotImplementedError(
            "reading the optimizer state of a JAX-written checkpoint is not "
            "ported yet: ROADMAP Queue 1, Resilience")
    state = init_state(model, cfg, params=params, device=device)
    leaves = dict(_state_leaves(path, device))
    step = int(leaves["2"])
    opt_state = {}
    for i, (p, _) in enumerate(dense_leaves(state.params, cfg)):
        if f"1/{p}/exp_avg" in leaves:
            opt_state[i] = {"step": torch.tensor(float(step)),
                            "exp_avg": leaves[f"1/{p}/exp_avg"],
                            "exp_avg_sq": leaves[f"1/{p}/exp_avg_sq"]}
    sd = state.opt.state_dict()
    sd["state"] = opt_state
    state.opt.load_state_dict(sd)
    for name, opt in state.tables.items():
        for k in opt:
            opt[k] = leaves[f"1/tables/{name}/{k}"]
    state.step = step
    return state, meta


def _state_leaves(path, device="cpu"):
    """(tree path, tensor on ``device``) of every leaf of a port-written
    checkpoint outside the parameters: the optimizer states and the
    step."""
    manifest = json.loads((Path(path) / MANIFEST_FILE).read_text())
    for e in manifest["leaves"]:
        if not e["path"].startswith("0/"):
            t = torch.from_numpy(np.load(Path(path) / e["file"]))
            if e["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            yield e["path"], t.to(device)


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
