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
it, [Vp, D] with its pad rows. A train state whose tables are row-sharded
on a mesh (``TrainState.layout``) writes each table leaf (the table, its
AdamW moments, its row state) per shard, in the JAX package's manifest
format: a ``"shards"`` entry listing one ``leaf_{i:05d}.{a}-{b}_{c}-{d}.npy``
file per row extent, the shard-pad rows kept; on a process mesh the process
owning an extent (the lowest rank holding it) writes it and rank 0 the
rest, a tensor-parallel leaf whole (gathered over the model group). Leaves are listed in the JAX package's tree order, so its loader
reads the directory into a template of the same tree. A directory is staged
as ``.tmp`` and renamed, so a crash mid-write is never picked up;
:func:`save_checkpoint_async` copies the state at once and writes on a
thread. Loading checks the saved model config and the parameter tree
against the model's, as the JAX package does, and reads a train state the
JAX trainer wrote too (its optax state, ``bridge.opt_state_from_jax``).
The learned tables' rows follow the JAX loader's rules
(:func:`convert_rows`): a table, its AdamW moments or its row-optimizer
state whose row count differs from the model's by shard or pack padding
(all-zero surplus rows) is cut or zero-extended to it; trained surplus
rows, or any other row count, raise. Loaded onto a mesh, a table leaf is
read for this process's row extent only (memory-mapped files, sliced), in
whatever shards it was saved. The JAX package's legacy single-blob layout
(``state.msgpack``, which ``flax.serialization.to_bytes`` wrote from the
list of the JAX train state's leaves) loads too, positionally, in that
state's leaf order (parameters, optax state, step), by a reader of the
msgpack subset flax writes
(:func:`read_msgpack`: neither ``msgpack`` nor ``flax`` is needed).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
import shutil
import struct
import threading
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..bridge import (_flatten, _load_entry, _nest, _to_numpy, _to_torch,
                      jax_opt_state, opt_state_from_jax, params_from_jax,
                      params_from_leaves)

MANIFEST_FILE = "manifest.json"
META_FILE = "meta.json"
CKPT_FILE = "state.msgpack"          # the JAX package's legacy layout

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


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def _table_of(path: str) -> Optional[str]:
    """The row-sharded table a leaf path belongs to (its parameter, the
    AdamW moments ``1/<table>/...`` of the port, optax's ``.../mu/<table>``
    of the JAX package, the row state ``1/tables/<table>/<key>``), or
    None."""
    from ..parallel.sharded_embedding import SHARDED_TABLES

    parts = path.split("/")
    if parts[0] == "0":
        return parts[1] if len(parts) == 2 and parts[1] in SHARDED_TABLES \
            else None
    if parts[0] != "1" or len(parts) < 2:
        return None
    if parts[1] == "tables":
        return parts[2]
    for p in (parts[1], parts[-1]):
        if p in SHARDED_TABLES:
            return p
    return None


def _write(ckpt_dir, leaves: Mapping[str, torch.Tensor], meta: dict,
           global_step: int, valid_loss: float,
           _fault_after_files: Optional[int] = None, layout=None,
           mesh=None) -> Path:
    """One checkpoint directory of ``leaves`` (tree path -> tensor), staged
    in ``.tmp`` and renamed, so a crash is never picked up.
    ``_fault_after_files``, a test hook, raises after that many files of
    this process, as a crash mid-write would stop.

    With a ``layout`` (``TrainState.layout``) each table leaf is written
    per row extent (the JAX manifest's ``"shards"``): on a local mesh the
    leaf is the padded table and every extent is written here; on a
    process mesh (``mesh``) it is this process's block, written by the
    lowest rank holding it (seq index 0), and rank 0 alone writes the
    other leaves, the manifest and the meta, then renames, each phase
    behind a barrier. The directory's name is rank 0's."""
    import torch.distributed as dist

    proc = mesh is not None and mesh.process
    rank0 = not proc or dist.get_rank() == 0
    if proc:
        named = [global_step, valid_loss, meta]
        dist.broadcast_object_list(named, src=0)
        global_step, valid_loss, meta = named
    out = Path(ckpt_dir) / \
        f"global_step{global_step}.valid_loss={valid_loss:.4f}"
    tmp = out.with_name(out.name + ".tmp")
    if rank0:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    if proc:
        dist.barrier()
    written = 0

    def put(fname, t):
        nonlocal written
        if _fault_after_files is not None and written >= _fault_after_files:
            raise RuntimeError("injected checkpoint fault (test hook)")
        np.save(tmp / fname, _leaf_numpy(t)[0])
        written += 1

    entries = []
    for i, (path, leaf) in enumerate(leaves.items()):
        entry = {"path": path, "dtype": _dtype_name(leaf)}
        if layout is None or _table_of(path) is None:
            entry.update(file=f"leaf_{i:05d}.npy", shape=list(leaf.shape))
            if rank0:
                put(entry["file"], leaf)
            entries.append(entry)
            continue
        S = layout[1]
        if proc:
            rps = leaf.shape[0]
            mine = {layout[2]: leaf} if mesh.seq_index == 0 else {}
        else:
            rps = leaf.shape[0] // S
            mine = dict(enumerate(leaf.chunk(S)))
        rest = [[0, d] for d in leaf.shape[1:]]
        shards = []
        for s in range(S):
            index = [[s * rps, (s + 1) * rps]] + rest
            fname = f"leaf_{i:05d}." + "_".join(f"{a}-{b}" for a, b
                                                in index) + ".npy"
            if s in mine:
                put(fname, mine[s])
            shards.append({"file": fname, "index": index})
        entry.update(shape=[rps * S] + list(leaf.shape[1:]), shards=shards)
        entries.append(entry)
    if proc:
        dist.barrier()
    if rank0:
        (tmp / MANIFEST_FILE).write_text(json.dumps({"leaves": entries}))
        (tmp / META_FILE).write_text(json.dumps(meta))
        if out.exists():
            shutil.rmtree(out)
        tmp.rename(out)
    if proc:
        dist.barrier()
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
    # the JAX package's leaf order: nested dict keys sorted level by level
    return dict(sorted(leaves.items(), key=lambda kv: kv[0].split("/")))


def save_checkpoint(ckpt_dir, state, global_step: int,
                    valid_loss: float = 0.0, extra_meta: Optional[dict] = None,
                    model_config=None,
                    _fault_after_files: Optional[int] = None,
                    mesh=None) -> Path:
    """Write a train state (``train.trainer.TrainState``): its parameters
    under ``0/`` as :func:`save_params` does, the AdamW moments and the
    tables' row-optimizer state under ``1/``, the step as ``2``; the tables
    of a state row-sharded on a mesh per shard (every process of a process
    ``mesh`` calls it), its tensor-parallel leaves whole (gathered over the
    model group, written by rank 0), and on a pipe mesh its stacked block
    leaves whole (gathered over the pipe group). ``_fault_after_files`` is
    :func:`_write`'s test hook."""
    meta = _meta(global_step, valid_loss, model_config,
                 dict(extra_meta or {}, state_format="torch"))
    from ..parallel.train import split_axes

    leaves = _state_tensors(state)
    split = split_axes(state.layout)
    if split:
        leaves = _whole_model_leaves(state, leaves, mesh, split)
    return _write(ckpt_dir, leaves, meta, global_step, valid_loss,
                  _fault_after_files, state.layout, mesh)


def _whole_model_leaves(state, leaves: dict, mesh, split: dict) -> dict:
    """``leaves`` with the split leaves of a process mesh's state (``split``:
    ``parallel.train.split_axes``) gathered whole: every tensor-parallel
    parameter and its AdamW moments over the model group, every stacked
    block leaf and its moments over the pipe group (every process calls
    it; rank 0 writes them)."""
    from ..parallel.mesh import gather_pipe
    from ..parallel.partition import join_model, model_dims

    out = dict(leaves)

    def moments(p):
        return [k for k in (f"0/{p}", f"1/{p}/exp_avg", f"1/{p}/exp_avg_sq")
                if k in out]

    if "model" in split:
        for p, dim in model_dims(state.params).items():
            for key in moments(p):
                out[key] = join_model(mesh, out[key], p, dim)
    if "pipe" in split:
        for p in _flatten(state.params):
            if p.startswith("blocks/"):
                for key in moments(p):
                    out[key] = gather_pipe(out[key], mesh)
    return out


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
                          model_config=None, mesh=None) -> AsyncSaveHandle:
    """:func:`save_checkpoint` with the files written on a daemon thread, so
    that the next steps overlap the disk. The state is copied to host
    memory now: the train step updates it in place, and a CPU tensor's
    ``.numpy()`` would be a view of what the next step overwrites, so every
    leaf is cloned, the AdamW moments and the tables' state too. One
    process only, as the JAX package's: several processes save
    synchronously. A local mesh's row-sharded tables are written per
    shard, as :func:`save_checkpoint` writes them (``mesh`` is taken for
    the same signature)."""
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
                                 valid_loss, layout=state.layout)
        except BaseException as e:   # raised by result()
            handle.error = e

    t = threading.Thread(target=run, daemon=True)
    handle = AsyncSaveHandle(t)
    t.start()
    return handle


def _repad_rows(t: torch.Tensor, rows: int, path: str) -> torch.Tensor:
    """``t`` cut or zero-extended to ``rows`` leading rows. Cutting needs
    the dropped rows to be all zero (shard and pack padding is zero and
    never read): a trained row raises. Extending warns, since new rows of
    a grown vocabulary would restore as zeros, not as a fresh init."""
    n = min(t.shape[0], rows)
    if t.shape[0] > n and bool(t[n:].any()):
        raise ValueError(
            f"checkpoint leaf {path!r} has {t.shape[0]} rows but the model "
            f"expects {rows}, and the surplus rows are NOT all zero — this "
            "is trained data, not shard padding (vocab/itemnum skew between "
            "save and load?); refusing to truncate")
    if rows > t.shape[0]:
        logging.getLogger(__name__).warning(
            "checkpoint leaf %r: zero-extending %d -> %d rows (shard-pad "
            "re-pad; if the model's vocab actually grew, the new rows "
            "restore as zeros, not fresh init)", path, t.shape[0], rows)
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    out[:n] = t[:n]
    return out


def convert_rows(t: torch.Tensor, shape, path: str = "?"
                 ) -> Optional[torch.Tensor]:
    """A learned table's leaf (a [V, D] table or moment, a [V] row
    accumulator, or a JAX-packed [V / R, 8, 128] one, unpacked first) at
    the model's ``shape``, by the JAX loader's rules (``_convert_layout``,
    ``_repad_rows``): the same rows as they are; rows that differ by under
    32, or by the padding of a table at packed scale (``ops.sparse_table.
    padded_table_rows``, the port's Vp), cut (surplus rows all zero, else
    ``ValueError``) or zero-extended. None for any other shape: the caller
    raises its shape error."""
    from ..ops.sparse_table import padded_table_rows

    shape = tuple(shape)
    if t.dim() == 3 and tuple(t.shape[1:]) == (8, 128) and len(shape) == 2 \
            and shape[1] <= 128 and 128 % shape[1] == 0:
        t = t.reshape(-1, shape[1])
    if tuple(t.shape) == shape:
        return t
    if t.dim() != len(shape) or tuple(t.shape[1:]) != shape[1:]:
        return None
    have, want = t.shape[0], shape[0]
    lo, hi = min(have, want), max(have, want)
    if hi - lo < 32 or hi == padded_table_rows(lo):
        return _repad_rows(t, want, path)
    return None


def _fit_rows(t: torch.Tensor, rows: int, path: str) -> torch.Tensor:
    """:func:`convert_rows` to ``rows`` leading rows, raising where the
    rows cannot convert."""
    out = convert_rows(t, (rows,) + tuple(t.shape[1:]), path)
    if out is None:
        raise ValueError(
            f"checkpoint leaf {path!r} shape {tuple(t.shape)} does not fit "
            f"the model's {rows} rows — vocabulary skew (itemnum/usernum "
            "differ between save and load) or architecture config skew")
    return out


def table_rows(model, packed: bool) -> Dict[str, int]:
    """The rows of each learned table in ``model``: ``user_emb`` usernum +
    1, ``item_emb`` itemnum + 1, or its Vp rows where ``packed`` (the port
    trains it at packed scale), ``fused_feat`` the fused vocabulary's."""
    from ..ops.sparse_table import padded_table_rows

    items = model.itemnum + 1
    return {"item_emb": padded_table_rows(items) if packed else items,
            "user_emb": model.usernum + 1,
            "fused_feat": model.fused.total_rows}


def _fit_tables(params: dict, rows: Mapping[str, int]) -> dict:
    """``params`` with each learned table at its model rows
    (:func:`_fit_rows`)."""
    return {k: _fit_rows(v, rows[k], k) if k in rows else v
            for k, v in params.items()}


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
        # the tables' rows are the vocabulary's and the layout's
        skip = 1 if p in ("item_emb", "user_emb", "fused_feat") else 0
        if have[p][skip:] != shape[skip:]:
            raise ValueError(f"checkpoint leaf {p!r} shape {have[p]} != "
                             f"model shape {shape} — architecture config "
                             "skew")


def _source_rows(path: Path, e: dict, dim: int):
    """(row count, rows(a, b)) of a table's manifest entry viewed as rows
    (a packed [G, 8, 128] leaf as [G * 1024 / dim, dim]), whole or per
    shard: ``rows`` reads [a, b) from the memory-mapped files, so only
    those rows come off the disk."""
    def view(arr):
        if arr.ndim == 3 and tuple(arr.shape[1:]) == (8, 128):
            return arr.reshape(-1, dim)
        return arr

    def load(fname):
        return view(_to_numpy(np.load(path / fname, mmap_mode="r"),
                              e["dtype"]))

    if "shards" not in e:
        arr = load(e["file"])
        return arr.shape[0], lambda a, b: np.array(arr[a:b])
    scale = 1024 // dim if len(e["shape"]) == 3 else 1
    parts = sorted((sh["index"][0][0] * scale, sh["index"][0][1] * scale,
                    sh["file"]) for sh in e["shards"])
    first = load(parts[0][2])

    def rows(a, b):
        out = np.zeros((b - a,) + first.shape[1:], first.dtype)
        for lo, hi, fname in parts:
            if lo < b and hi > a:
                x, y = max(a, lo), min(b, hi)
                out[x - a:y - a] = load(fname)[x - lo:y - lo]
        return out

    return parts[-1][1], rows


def _read_block(path: Path, e: dict, want: int, lo: int, hi: int, dim: int
                ) -> np.ndarray:
    """Rows [lo, hi) of a table leaf at the model's ``want`` rows (zeros
    past them), read from the disk alone, by the rows rules of
    :func:`convert_rows`; the block holding the last real row checks that
    the saved rows past ``want`` are zero."""
    from ..ops.sparse_table import padded_table_rows

    src, rows = _source_rows(path, e, dim)
    a, b = min(src, want), max(src, want)
    if not (b - a < 32 or b == padded_table_rows(a)):
        raise ValueError(
            f"checkpoint leaf {e['path']!r} of {src} rows does not fit the "
            f"model's {want} rows — vocabulary skew (itemnum/usernum differ "
            "between save and load) or architecture config skew")
    if src > want and lo < want <= hi and rows(want, src).any():
        raise ValueError(
            f"checkpoint leaf {e['path']!r} has {src} rows but the model "
            f"expects {want}, and the surplus rows are NOT all zero — this "
            "is trained data, not shard padding (vocab/itemnum skew between "
            "save and load?); refusing to truncate")
    n = max(0, min(hi, want, src) - lo)
    head = rows(lo, lo + n)
    out = np.zeros((hi - lo,) + head.shape[1:], head.dtype)
    out[:n] = head
    return out


def _mesh_reader(path: Path, mesh, rows: Mapping[str, int], dim: int,
                 device):
    """``read(tree path, manifest entry) -> tensor`` for a load onto
    ``mesh``: a table leaf's rows of this process (the whole padded table
    on a local mesh) at the model's rows padded to the table shards,
    every other leaf whole."""
    from ..parallel.train import layout

    lay = layout(mesh)
    S = lay[1]

    def read(p, e):
        bf16 = e["dtype"] == "bfloat16"
        name = _table_of(p)
        if name not in rows:
            return _to_torch(_load_entry(path, e), bf16, device)
        rps = -(-rows[name] // S)
        lo, hi = (lay[2] * rps, (lay[2] + 1) * rps) \
            if lay[0] == "process" else (0, rps * S)
        return _to_torch(_read_block(path, e, rows[name], lo, hi, dim),
                         bf16, device)

    return read


def read_msgpack(blob: bytes):
    """The object of a msgpack blob, in the subset that
    ``flax.serialization.msgpack_serialize`` writes: maps (dicts), arrays
    (lists), strings, ints, floats, nil and booleans, bin, and flax's ext
    types, an ndarray (code 1, itself a msgpack array of the shape, the
    dtype's name and the row-major bytes) and a numpy scalar (code 3, the
    same as a 0-d array), each returned as (numpy array, is_bf16): a
    bfloat16 array as its uint16 bits (``bridge._to_torch`` views them).
    An array over flax's chunk size is a map of its flat chunks
    (:func:`_unchunk`)."""
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(blob):
            raise ValueError("truncated msgpack blob")
        pos += n
        return blob[pos - n:pos]

    def uint(n):
        return int.from_bytes(take(n), "big")

    def ext(code, n):
        data = take(n)
        if code not in (1, 3):
            raise ValueError(f"msgpack ext type {code} is not flax's ndarray")
        shape, dtype, buf = read_msgpack(data)
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        bf16 = dtype == "bfloat16"
        arr = np.frombuffer(buf, np.uint16 if bf16 else np.dtype(dtype))
        return arr.reshape(tuple(shape)), bf16

    def obj():
        t = take(1)[0]
        if t <= 0x7F or t >= 0xE0:               # fixint
            return t if t <= 0x7F else t - 0x100
        if t <= 0x8F:                            # fixmap
            return {obj(): obj() for _ in range(t & 0x0F)}
        if t <= 0x9F:                            # fixarray
            return [obj() for _ in range(t & 0x0F)]
        if t <= 0xBF:                            # fixstr
            return take(t & 0x1F).decode()
        if t in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[t]
        if 0xC4 <= t <= 0xC6:                    # bin 8/16/32
            return bytes(take(uint(1 << (t - 0xC4))))
        if 0xC7 <= t <= 0xC9:                    # ext 8/16/32
            n = uint(1 << (t - 0xC7))
            return ext(int.from_bytes(take(1), "big", signed=True), n)
        if t in (0xCA, 0xCB):
            return struct.unpack(">f" if t == 0xCA else ">d",
                                 take(4 if t == 0xCA else 8))[0]
        if 0xCC <= t <= 0xCF:                    # uint 8-64
            return uint(1 << (t - 0xCC))
        if 0xD0 <= t <= 0xD3:                    # int 8-64
            return int.from_bytes(take(1 << (t - 0xD0)), "big", signed=True)
        if 0xD4 <= t <= 0xD8:                    # fixext 1-16
            code = int.from_bytes(take(1), "big", signed=True)
            return ext(code, 1 << (t - 0xD4))
        if 0xD9 <= t <= 0xDB:                    # str 8/16/32
            return take(uint(1 << (t - 0xD9))).decode()
        if t in (0xDC, 0xDD):                    # array 16/32
            return [obj() for _ in range(uint(2 << (t - 0xDC)))]
        if t in (0xDE, 0xDF):                    # map 16/32
            return {obj(): obj() for _ in range(uint(2 << (t - 0xDE)))}
        raise ValueError(f"msgpack type byte {t:#x} is not one flax writes")

    out = obj()
    if pos != len(blob):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _unchunk(leaf):
    """A leaf of a flax blob as (numpy array, is_bf16): an array over
    flax's chunk size is a map ``{"__msgpack_chunked_array__": True,
    "shape": {"0": ..}, "chunks": {"0": flat chunk, ..}}``, joined here; a
    python int or float (a scalar leaf) as a 0-d array."""
    if isinstance(leaf, dict) and leaf.get("__msgpack_chunked_array__"):
        shape = tuple(leaf["shape"][str(i)] for i in range(len(leaf["shape"])))
        chunks = [leaf["chunks"][str(i)] for i in range(len(leaf["chunks"]))]
        return (np.concatenate([c[0].reshape(-1) for c in chunks])
                .reshape(shape), chunks[0][1])
    if isinstance(leaf, tuple):
        return leaf
    if isinstance(leaf, (bool, int, float)):
        return np.asarray(leaf), False
    raise ValueError(f"a leaf of the blob is a {type(leaf).__name__}, not "
                     "an array")


def _jax_state_shapes(state, cfg, tables) -> Dict[str, Tuple[tuple, bool]]:
    """{tree path: (shape, is a table leaf)} of the train state the JAX
    trainer builds for this model and config (its ``init_state(model,
    make_optimizer(cfg), seed, cfg)``), in its leaf order: the parameters
    under ``0/``; optax's adam / adamw state over every parameter (``1/``),
    or over the dense ones (``1/dense/``) beside the sparse tables' row
    state (``1/tables/<table>/<key>``): its count, ``mu`` and ``nu``, and
    where the learning rate is not constant the schedule's count
    (``<i>/count``, after adamw's stateless decayed weights); the step
    ``2``. The shapes are those of ``state`` (a fresh port state); the
    leaves of the learned ``tables`` are marked, as their rows may differ
    by the JAX package's padding or packing (:func:`convert_rows`)."""
    from .trainer import dense_leaves

    t = cfg.train
    params = _flatten(state.params)
    out = {f"0/{p}": (tuple(v.shape), p.split("/")[0] in tables)
           for p, v in params.items()}
    pre = "1/dense/" if t.sparse_tables else "1/"
    out[pre + "0/count"] = ((), False)
    for p, _ in dense_leaves(state.params, cfg):
        for k in ("mu", "nu"):
            out[f"{pre}0/{k}/{p}"] = out[f"0/{p}"]
    if not (t.lr_schedule == "constant" and t.lr_warmup_steps == 0):
        out[f"{pre}{2 if t.weight_decay > 0 else 1}/count"] = ((), False)
    for name, opt in state.tables.items():
        for k, v in opt.items():
            out[f"1/tables/{name}/{k}"] = (tuple(v.shape), True)
    out["2"] = ((), False)
    # the JAX leaf order: dict keys sorted, tuple positions in order
    return dict(sorted(out.items(), key=lambda kv: kv[0].split("/")))


def _legacy_blob(path: Path) -> Optional[Path]:
    """The legacy single-blob file ``path`` names (the file, or a
    directory's ``state.msgpack`` where it holds no manifest), else
    None."""
    if path.is_file():
        return path
    if not (path / MANIFEST_FILE).exists() and (path / CKPT_FILE).exists():
        return path / CKPT_FILE
    return None


def _legacy_state(blob_file: Path, template, cfg, rows, device):
    """(params, JAX optimizer state) of a legacy blob: its leaves taken
    positionally in the JAX train state's leaf order (``template``:
    :func:`_jax_state_shapes`), the parameters' tables at the model's
    ``rows``, the optimizer leaves mapped as a JAX-written manifest's are
    (``bridge.jax_opt_state``). A leaf count or a leaf shape that differs
    raises ``ValueError``, as the JAX loader's guards do (a table leaf's
    when its rows are fitted: :func:`_fit_rows`)."""
    tree = read_msgpack(blob_file.read_bytes())
    if not isinstance(tree, dict) or set(tree) != {str(i) for i in
                                                   range(len(tree))}:
        raise ValueError(f"{blob_file} is not a positional list of leaves "
                         "(flax.serialization.to_bytes of a leaf list)")
    if len(tree) != len(template):
        raise ValueError(f"checkpoint holds {len(tree)} leaves, the model's "
                         f"JAX train state {len(template)} — a different "
                         "architecture or optimizer config")
    flat = {}
    for i, (p, (shape, table)) in enumerate(template.items()):
        arr, bf16 = _unchunk(tree[str(i)])
        if tuple(arr.shape) != shape and not table:   # tables: when fitted
            raise ValueError(
                f"checkpoint leaf {i} ({p}) shape {tuple(arr.shape)} != model "
                f"shape {shape} — the checkpoint was trained with a "
                "different architecture config (check hidden_units/"
                "num_blocks/num_heads/maxlen)")
        flat[p] = (np.array(arr), bf16)
    params = _fit_tables(params_from_leaves(
        {p[2:]: v for p, v in flat.items() if p.startswith("0/")}, device),
        rows)

    def load(p, packed):
        arr, bf16 = flat[p]
        return _to_torch(arr.reshape(-1, cfg.model.hidden_units) if packed
                         else arr, bf16, device)

    js = jax_opt_state({p: list(a.shape) for p, (a, _) in flat.items()
                        if not p.startswith("0/")}, load,
                       lambda p: int(flat[p][0]), blob_file)
    return params, js


def load_checkpoint(path, model, cfg, device="cpu", mesh=None):
    """(train state, meta) from a train state either package wrote (``path``
    a checkpoint directory, or a directory holding them: the newest is
    taken). The saved model config and parameter tree must match
    ``model``'s. A JAX-written state's optax AdamW moments, schedule count
    and row-optimizer state map onto the port's
    (``bridge.opt_state_from_jax``). The tables, their moments and their
    row-optimizer state take the model's rows (:func:`convert_rows`): the
    item table's Vp where the port trains it at packed scale. With a
    ``mesh`` of several table shards the state comes in the mesh's layout
    (``parallel.train``): each table leaf read for this process's rows
    only, from whatever shards or whole file it was saved in; on a process
    mesh with a model axis each tensor-parallel leaf and its moments are
    read whole (a JAX checkpoint's per-shard column extents assembled) and
    cut to this process's slice (``parallel.train.land_model``), and on a
    process mesh with a pipe axis each stacked block leaf and its moments
    to the stage's blocks (``parallel.train.land_pipe``).

    The legacy single-blob layout (``path`` a ``state.msgpack`` file, or a
    directory holding one and no manifest) loads positionally, as the JAX
    loader does: the leaves in the order of the JAX trainer's train state
    for this model and config (:func:`_jax_state_shapes`: its parameters,
    optax state and step), each of the template's shape (``ValueError``
    otherwise), the optax state mapped as a JAX-written manifest's; onto a
    ``mesh`` through ``parallel.train.shard_existing_state``."""
    from ..parallel.train import layout, shard_existing_state
    from .trainer import init_state, packed_item_table

    path = Path(path)
    blob = _legacy_blob(path)
    if blob is None and not (path / MANIFEST_FILE).exists():
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        path = found
    meta = json.loads((path / META_FILE).read_text()) \
        if path.is_dir() and (path / META_FILE).exists() else {}
    _check_config(meta, model.cfg)
    rows = table_rows(model, packed_item_table(cfg, model.itemnum))
    if blob is not None:
        params, js = _legacy_state(blob, _jax_state_shapes(
            init_state(model, cfg), cfg, rows), cfg, rows, device)
        state = _assemble(model, cfg, device, params, None, None, js)
        if mesh is not None:
            shard_existing_state(mesh, state)
        return state, meta
    lay = None if mesh is None else layout(mesh)
    read = None
    if lay is None:
        params = _fit_tables(params_from_jax(path, device=device), rows)
    else:
        read = _mesh_reader(path, mesh, rows, cfg.model.hidden_units,
                            device)
        entries = json.loads((path / MANIFEST_FILE).read_text())["leaves"]
        params = _nest({e["path"][2:]: read(e["path"], e) for e in entries
                        if e["path"].startswith("0/")})
    leaves = dict(_state_leaves(path, device, read)) \
        if meta.get("state_format") == "torch" else None
    js = None if leaves is not None else opt_state_from_jax(
        path, device, dim=cfg.model.hidden_units, read=read)
    state = _assemble(model, cfg, device, params, leaves, lay, js)
    if lay is not None:
        from ..parallel.train import land_model, land_pipe

        land_model(state, mesh)
        land_pipe(state, mesh)
    return state, meta


def _assemble(model, cfg, device, params, leaves, lay, js):
    """The train state of ``params`` and the optimizer state of a
    port-format checkpoint's ``leaves`` ({tree path: tensor}: the AdamW
    moments under ``1/<param>/``, the tables' row state under
    ``1/tables/``, the step as ``2``), or where ``leaves`` is None of a
    JAX-written one (``js``: ``bridge.opt_state_from_jax``); the tables at
    the model's rows unless ``lay`` (a mesh's layout) holds them."""
    from .trainer import dense_leaves, init_state, packed_item_table

    rows = table_rows(model, packed_item_table(cfg, model.itemnum))
    _check_structure(params, model)
    state = init_state(model, cfg, params=params, device=device)
    state.layout = lay
    dense = [p for p, _ in dense_leaves(state.params, cfg)]
    if leaves is not None:
        step = count = int(leaves["2"])
        moments = {p: (leaves[f"1/{p}/exp_avg"], leaves[f"1/{p}/exp_avg_sq"])
                   for p in dense if f"1/{p}/exp_avg" in leaves}
        tables = {name: {k: leaves[f"1/tables/{name}/{k}"] for k in opt}
                  for name, opt in state.tables.items()}
    else:
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
    moments = {p: tuple(_fit_rows(m, rows[p], f"1/{p}") for m in ms)
               if p in rows and lay is None else ms
               for p, ms in moments.items()}
    opt_state = {i: {"step": torch.tensor(float(count)),
                     "exp_avg": moments[p][0], "exp_avg_sq": moments[p][1]}
                 for i, p in enumerate(dense) if p in moments}
    sd = state.opt.state_dict()
    sd["state"] = opt_state
    state.opt.load_state_dict(sd)
    for name, opt in state.tables.items():
        for k in opt:
            got = tables[name][k]
            if got.dim() == opt[k].dim() and got.shape[1:] == opt[k].shape[1:]:
                got = _fit_rows(got, opt[k].shape[0],
                                f"1/tables/{name}/{k}")
            if got.shape != opt[k].shape:
                raise ValueError(f"table {name!r} optimizer state {k!r} "
                                 f"shape {tuple(got.shape)} != the port's "
                                 f"{tuple(opt[k].shape)}")
            opt[k] = got.to(opt[k].dtype)
    state.step = step
    return state


def _state_leaves(path, device="cpu", read=None):
    """(tree path, tensor on ``device``) of every leaf of a port-written
    checkpoint outside the parameters: the optimizer states and the step
    (through ``read(tree path, entry)`` where given: :func:`_mesh_reader`).
    """
    path = Path(path)
    manifest = json.loads((path / MANIFEST_FILE).read_text())
    for e in manifest["leaves"]:
        if not e["path"].startswith("0/"):
            yield e["path"], read(e["path"], e) if read is not None else \
                _to_torch(_load_entry(path, e), e["dtype"] == "bfloat16",
                          device)


def load_params(path, model=None, device="cpu") -> Tuple[dict, dict]:
    """(params, meta) from a checkpoint directory written by either package.
    With ``model`` (a SeqRecModel) the saved model config and parameter
    tree must match its own, and the tables take its rows
    (:func:`convert_rows`): ``item_emb`` its ``itemnum + 1`` addressable
    rows (a packed table's pad rows cut), ``user_emb`` ``usernum + 1``."""
    path = Path(path)
    meta = {}
    if (path / META_FILE).exists():
        meta = json.loads((path / META_FILE).read_text())
    if not (path / MANIFEST_FILE).exists():
        raise ValueError(f"{path} holds no {MANIFEST_FILE}: the legacy "
                         "single-blob checkpoint layout is not supported")
    params = params_from_jax(path, device=device)
    if model is not None:
        _check_config(meta, model.cfg)
        params = _fit_tables(params, table_rows(model, packed=False))
        _check_structure(params, model)
    return params, meta
