"""Native (C++) data prep: seq.jsonl -> packed train arrays on disk.

Counterpart of ``tencent_recommendation_2025_tpu/data/native_pack.py``.
``native/dataprep/dataprep_tool.cc`` is the threaded counterpart of the
python :class:`~.cached_dataset.PackedCache` pack: it parses one user per
jsonl line in parallel and writes the fixed sample fields (reference
semantics, ``model/BaseLine/dataset.py:96-169``) as raw int32 arrays plus a
CSR of each user's seen-item set. The on-disk layout makes the cache
reusable across runs.

The python side builds the tool on first use (:func:`tool_path`, into
``build/native/`` of the checkout; ``native/`` is never written), writes
the schema manifest, runs the tool and loads its output into a
:class:`PackedCache` with memmapped fields, so training code downstream is
the same either way.
"""

from __future__ import annotations

import json
import os
import shlex
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from . import schema as S
from .cached_dataset import PackedCache, SeenCSR
from .dataset import TrainSampler

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dataprep" / "dataprep_tool.cc"
TOOL = _ROOT / "build" / "native" / "dataprep_tool"
#: native/dataprep/Makefile's defaults (``CXX ?=``, ``CXXFLAGS ?=``): the
#: environment overrides them as it does make's
CXX = "g++"
CXXFLAGS = "-O3 -std=c++17 -march=native -pthread -Wall"


def tool_path(build: bool = True) -> Optional[Path]:
    """The dataprep binary, compiled from ``native/dataprep/
    dataprep_tool.cc`` into ``build/native/dataprep_tool`` on first use;
    None where it cannot be built. The compiler writes a name of its own
    process and the binary is renamed into place, so processes that build
    it at once (and the JAX package's ``make`` in ``native/dataprep/``)
    never see half a file."""
    if TOOL.exists():
        return TOOL
    cxx = os.environ.get("CXX", CXX)
    if not build or not SOURCE.exists() or shutil.which(cxx) is None:
        return None
    TOOL.parent.mkdir(parents=True, exist_ok=True)
    tmp = TOOL.with_name(f"{TOOL.name}.{os.getpid()}.tmp")
    flags = shlex.split(os.environ.get("CXXFLAGS", CXXFLAGS))
    try:
        subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, TOOL)
    except (subprocess.CalledProcessError, OSError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return TOOL


def write_schema_manifest(schema, path: Path) -> None:
    path.write_text(json.dumps({
        "user_sparse": list(S.USER_SPARSE_IDS),
        "item_sparse": list(S.ITEM_SPARSE_IDS),
        "user_array": list(S.USER_ARRAY_IDS),
        "item_array": list(S.ITEM_ARRAY_IDS),
        "array_cap": schema.array_cap,
    }))


def run_native_pack(seq_jsonl: Path, out_dir: Path, schema, maxlen: int,
                    threads: int = 16) -> Path:
    """Run the C++ tool; returns ``out_dir``. Raises if the tool cannot be
    built."""
    exe = tool_path()
    if exe is None:
        raise RuntimeError(f"dataprep_tool could not be built from {SOURCE}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    manifest = out_dir / "schema.json"
    write_schema_manifest(schema, manifest)
    subprocess.run([str(exe), "--seq", str(seq_jsonl), "--schema",
                    str(manifest), "--out", str(out_dir), "--maxlen",
                    str(maxlen), "--threads", str(threads)], check=True,
                   capture_output=True)
    return out_dir


def _memmap(path: Path) -> np.ndarray:
    # memmap, not fromfile: batches slice out only their rows, so the host
    # never pages in the whole field arrays; mmap refuses empty files
    # (zero-width feature blocks)
    if path.stat().st_size == 0:
        return np.zeros(0, np.int32)
    return np.memmap(path, dtype=np.int32, mode="r")


def load_native_cache(cache_dir: Path, sampler: TrainSampler) -> PackedCache:
    """A dataprep_tool output directory as a :class:`PackedCache`: memmapped
    fields, the seen sets from a per-user-sorted sidecar of the tool's CSR
    values (written once), negatives drawn per epoch as usual. Raises where
    a row carries more user tokens than ``MAX_USER_TOKENS_PER_ROW``."""
    from ..config import MAX_USER_TOKENS_PER_ROW

    cache_dir = Path(cache_dir)
    meta = json.loads((cache_dir / "meta.json").read_text())
    U, L, cap = meta["num_users"], meta["L"], meta["array_cap"]
    nis, nia = meta["nis"], meta["nia"]
    nus, nua = meta["nus"], meta["nua"]
    if L != sampler.maxlen + 1:
        raise ValueError(f"cache L={L} != sampler maxlen+1="
                         f"{sampler.maxlen + 1}")
    shapes = {
        "seq": (L,), "pos": (L,), "token_type": (L,),
        "next_token_type": (L,), "next_action_type": (L,),
        "seq_item_sparse": (L, nis), "seq_item_array": (L, nia, cap),
        "seq_user_sparse": (L, nus), "seq_user_array": (L, nua, cap),
        "pos_item_sparse": (L, nis), "pos_item_array": (L, nia, cap),
    }
    self = PackedCache.__new__(PackedCache)
    self.sampler = sampler
    self.fields = {name: _memmap(cache_dir / f"{name}.bin").reshape(
        (U, *shape)) for name, shape in shapes.items()}

    offs = np.fromfile(cache_dir / "seen_offsets.bin", dtype=np.int64)
    vals = _memmap(cache_dir / "seen_values.bin")
    if len(offs) != U + 1 or offs[-1] != len(vals):
        raise ValueError(f"{cache_dir}: seen-set offsets do not match its "
                         f"{U} users and {len(vals)} values")
    # binary-search membership needs each user's segment sorted: sort once
    # into a sidecar (one vectorised lexsort)
    sorted_path = cache_dir / "seen_values_sorted.bin"
    if not sorted_path.exists() or \
            sorted_path.stat().st_size != vals.nbytes:
        vs = np.asarray(vals)
        rows = np.repeat(np.arange(U), np.diff(offs))
        tmp = sorted_path.with_suffix(".tmp")
        vs[np.lexsort((vs, rows))].tofile(tmp)
        os.replace(tmp, sorted_path)
    # the user tower reads MAX_USER_TOKENS_PER_ROW positions a row: a row
    # with more must fail here, over every row (64K rows at a time)
    tt = self.fields["token_type"]
    worst = 0
    for o in range(0, U, 65536):
        chunk = np.asarray(tt[o:o + 65536])
        if len(chunk):
            worst = max(worst, int((chunk == 2).sum(axis=1).max()))
    if worst > MAX_USER_TOKENS_PER_ROW:
        raise ValueError(
            f"native cache rows carry {worst} user tokens > "
            f"MAX_USER_TOKENS_PER_ROW={MAX_USER_TOKENS_PER_ROW}; raise the "
            "config cap")
    self.seen_sets = SeenCSR(_memmap(sorted_path), offs)
    self.neg_ok = sampler._neg_ok.copy()
    self.itemnum = sampler.itemnum
    return self


def build_packed_cache_native(sampler: TrainSampler, cache_dir: Path,
                              threads: int = 16) -> PackedCache:
    """Pack with the C++ tool and load as a :class:`PackedCache`. A
    ``cache_dir`` whose meta.json matches the sampler (window, users, array
    cap) is loaded as it is; anything else is packed again."""
    cache_dir = Path(cache_dir)
    meta_path = cache_dir / "meta.json"
    if meta_path.exists():
        try:
            meta = json.loads(meta_path.read_text())
            if meta.get("L") == sampler.maxlen + 1 and \
                    meta.get("num_users") == len(sampler) and \
                    meta.get("array_cap") == sampler.schema.array_cap:
                return load_native_cache(cache_dir, sampler)
        except (ValueError, OSError):
            pass  # unreadable or partial: pack again below
    run_native_pack(sampler.data.seq.jsonl_path, cache_dir, sampler.schema,
                    sampler.maxlen, threads=threads)
    return load_native_cache(cache_dir, sampler)
