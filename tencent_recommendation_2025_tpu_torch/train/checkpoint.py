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
it, [Vp, D] with its pad rows. A directory is staged as ``.tmp`` and
renamed, so a crash mid-write is never picked up;
:func:`save_checkpoint_async` copies the state at once and writes on a
thread. Loading checks the saved model config and the parameter tree
against the model's, as the JAX package does, and reads a train state the
JAX trainer wrote too (its optax state, ``bridge.opt_state_from_jax``).
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import threading
from pathlib import Path
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from ..bridge import _flatten, opt_state_from_jax, params_from_jax

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
           global_step: int, valid_loss: float,
           _fault_after_files: Optional[int] = None) -> Path:
    """One checkpoint directory of ``leaves`` (tree path -> tensor), staged
    in ``.tmp`` and renamed, so a crash is never picked up.
    ``_fault_after_files``, a test hook, raises after that many leaf
    files, as a crash mid-write would stop."""
    out = Path(ckpt_dir) / \
        f"global_step{global_step}.valid_loss={valid_loss:.4f}"
    tmp = out.with_name(out.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    entries = []
    for i, (path, leaf) in enumerate(leaves.items()):
        if _fault_after_files is not None and i >= _fault_after_files:
            raise RuntimeError("injected checkpoint fault (test hook)")
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


def _state_tensors(state) -> dict:
    """{tree path: tensor} of a train state (``train.trainer.TrainState``):
    its parameters under ``0/``, the AdamW moments and the tables'
    row-optimizer state under ``1/``, the step as ``2``. The tensors are
    the state's own."""
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
    return leaves


def save_checkpoint(ckpt_dir, state, global_step: int,
                    valid_loss: float = 0.0, extra_meta: Optional[dict] = None,
                    model_config=None,
                    _fault_after_files: Optional[int] = None) -> Path:
    """Write a train state (``train.trainer.TrainState``): its parameters
    under ``0/`` as :func:`save_params` does, the AdamW moments and the
    tables' row-optimizer state under ``1/``, the step as ``2``.
    ``_fault_after_files`` is :func:`_write`'s test hook."""
    meta = _meta(global_step, valid_loss, model_config,
                 dict(extra_meta or {}, state_format="torch"))
    return _write(ckpt_dir, _state_tensors(state), meta, global_step,
                  valid_loss, _fault_after_files)


class AsyncSaveHandle:
    """Handle of a save in flight; ``result()`` joins it and returns its
    directory, or raises the error the save met."""

    def __init__(self, thread: threading.Thread):
        self._thread = thread
        self.path: Optional[Path] = None
        self.error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None) -> Path:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint save still running")
        if self.error is not None:
            raise self.error
        return self.path


def save_checkpoint_async(ckpt_dir, state, global_step: int,
                          valid_loss: float = 0.0,
                          extra_meta: Optional[dict] = None,
                          model_config=None) -> AsyncSaveHandle:
    """:func:`save_checkpoint` with the files written on a daemon thread, so
    that the next steps overlap the disk. The state is copied to host
    memory now: the train step updates it in place, and a CPU tensor's
    ``.numpy()`` would be a view of what the next step overwrites, so every
    leaf is cloned, the AdamW moments and the tables' state too. One
    process only, as the JAX package's: several processes save
    synchronously."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "save_checkpoint_async is single-process only: use "
            "save_checkpoint (sync) in multi-process runs")
    snapshot = {p: t.detach().to("cpu", copy=True)
                for p, t in _state_tensors(state).items()}
    meta = _meta(global_step, valid_loss, model_config,
                 dict(extra_meta or {}, state_format="torch"))
    handle: AsyncSaveHandle

    def run():
        try:
            handle.path = _write(ckpt_dir, snapshot, meta, global_step,
                                 valid_loss)
        except BaseException as e:   # raised by result()
            handle.error = e

    t = threading.Thread(target=run, daemon=True)
    handle = AsyncSaveHandle(t)
    t.start()
    return handle


def _check_structure(params: Mapping, model) -> None:
    """The checkpoint's parameter tree against the one ``model`` builds:
    the same leaf paths, and the same shapes outside the tables' rows (a
    probe of the model with one user and one item draws the tree)."""
    probe = dataclasses.replace(model, usernum=1, itemnum=1)
    want = {p: tuple(t.shape) for p, t in _flatten(
        probe.init(torch.Generator().manual_seed(0))).items()}
    have = {p: tuple(t.shape) for p, t in _flatten(params).items()}
    if want.keys() != have.keys():
        raise ValueError(
            "checkpoint parameter structure mismatch — missing in ckpt: "
            f"{sorted(want.keys() - have.keys())[:5]}, unexpected: "
            f"{sorted(have.keys() - want.keys())[:5]} (model definition "
            "changed between save and load)")
    for p, shape in want.items():
        if p not in ("item_emb", "user_emb") and have[p] != shape:
            raise ValueError(f"checkpoint leaf {p!r} shape {have[p]} != "
                             f"model shape {shape} — architecture config "
                             "skew")


def load_checkpoint(path, model, cfg, device="cpu"):
    """(train state, meta) from a train state either package wrote (``path``
    a checkpoint directory, or a directory holding them: the newest is
    taken). The saved model config and parameter tree must match
    ``model``'s. A JAX-written state's optax AdamW moments, schedule count
    and row-optimizer state map onto the port's
    (``bridge.opt_state_from_jax``); its packed item table keeps its Vp
    rows where the port trains it at packed scale."""
    from .trainer import dense_leaves, init_state, packed_item_table

    path = Path(path)
    if not (path / MANIFEST_FILE).exists():
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        path = found
    meta = json.loads((path / META_FILE).read_text()) \
        if (path / META_FILE).exists() else {}
    _check_config(meta, model.cfg)
    params = params_from_jax(path, device=device, itemnum=None
                             if packed_item_table(cfg, model.itemnum)
                             else model.itemnum)
    _check_structure(params, model)
    state = init_state(model, cfg, params=params, device=device)
    dense = [p for p, _ in dense_leaves(state.params, cfg)]
    if meta.get("state_format") == "torch":
        leaves = dict(_state_leaves(path, device))
        step = count = int(leaves["2"])
        moments = {p: (leaves[f"1/{p}/exp_avg"], leaves[f"1/{p}/exp_avg_sq"])
                   for p in dense if f"1/{p}/exp_avg" in leaves}
        tables = {name: {k: leaves[f"1/tables/{name}/{k}"] for k in opt}
                  for name, opt in state.tables.items()}
    else:
        js = opt_state_from_jax(path, device, dim=cfg.model.hidden_units)
        step, count = js["step"], js["count"]
        if set(js["exp_avg"]) != set(dense):
            raise ValueError(
                "checkpoint optimizer structure mismatch — the JAX state's "
                f"moments cover {len(js['exp_avg'])} leaves, the port's "
                f"dense leaves are {len(dense)}")
        if js["schedule_count"] not in (None, step):
            raise ValueError(
                f"the JAX schedule's count {js['schedule_count']} != the "
                f"train state's step {step}: the port's learning rate "
                "reads the step")
        moments = {p: (js["exp_avg"][p], js["exp_avg_sq"][p]) for p in dense}
        tables = js["tables"]
    opt_state = {i: {"step": torch.tensor(float(count)),
                     "exp_avg": moments[p][0], "exp_avg_sq": moments[p][1]}
                 for i, p in enumerate(dense) if p in moments}
    sd = state.opt.state_dict()
    sd["state"] = opt_state
    state.opt.load_state_dict(sd)
    for name, opt in state.tables.items():
        for k in opt:
            got = tables[name][k]
            if got.shape != opt[k].shape:
                raise ValueError(f"table {name!r} optimizer state {k!r} "
                                 f"shape {tuple(got.shape)} != the port's "
                                 f"{tuple(opt[k].shape)}")
            opt[k] = got.to(opt[k].dtype)
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
