"""L0 binary formats: ``.fbin`` / ``.u64bin`` codecs and ANN result files.

Byte-level contracts match the reference so artifacts interoperate with the
competition tooling:

- ``.fbin``  : two little-endian uint32 (rows, cols) then a float32 raster
  (reference ``model/BaseLine/dataset.py:421-434`` ``save_emb``).
- ``.u64bin``: same header then uint64 payload (ids are written through the
  same ``save_emb``; the ANN result file ``id100.u64bin`` uses header
  (num_queries, top_k) then uint64 ids — reference ``infer.py:51-65``).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

PathLike = Union[str, Path]
_HEADER = struct.Struct("<II")


def save_emb(emb: np.ndarray, save_path: PathLike) -> None:
    """Write a 2-D array with the (rows, cols) uint32 header.

    dtype is preserved as-is (float32 for embeddings, uint64 for id columns),
    mirroring the reference's ``emb.tofile`` behavior.
    """
    emb = np.ascontiguousarray(emb)
    assert emb.ndim == 2, f"save_emb expects 2-D, got {emb.shape}"
    with open(Path(save_path), "wb") as f:
        f.write(_HEADER.pack(emb.shape[0], emb.shape[1]))
        emb.tofile(f)


def load_fbin(path: PathLike, mmap: bool = False) -> np.ndarray:
    """Read a float32 ``.fbin`` written by :func:`save_emb`; ``mmap``: a
    read-only memory map, whose rows are read when sliced (a process that
    serves a shard of the corpus reads its rows only)."""
    with open(Path(path), "rb") as f:
        rows, cols = _HEADER.unpack(f.read(8))
        if mmap:
            return np.memmap(f, dtype=np.float32, mode="r",
                             offset=_HEADER.size, shape=(rows, cols))
        data = np.fromfile(f, dtype=np.float32, count=rows * cols)
    return data.reshape(rows, cols)


def load_u64bin(path: PathLike) -> np.ndarray:
    """Read a uint64 ``.u64bin`` (id columns) written by :func:`save_emb`."""
    with open(Path(path), "rb") as f:
        rows, cols = _HEADER.unpack(f.read(8))
        data = np.fromfile(f, dtype=np.uint64, count=rows * cols)
    return data.reshape(rows, cols)


def save_result_ids(ids: np.ndarray, path: PathLike) -> None:
    """Write an ANN result file: header (num_queries, top_k) + uint64 ids."""
    ids = np.ascontiguousarray(ids, dtype=np.uint64)
    assert ids.ndim == 2
    with open(Path(path), "wb") as f:
        f.write(_HEADER.pack(ids.shape[0], ids.shape[1]))
        ids.tofile(f)


def read_result_ids(path: PathLike) -> np.ndarray:
    """Read the ANN tool's result ids (reference ``infer.py:51-65``)."""
    with open(Path(path), "rb") as f:
        num_queries, top_k = _HEADER.unpack(f.read(8))
        ids = np.fromfile(f, dtype=np.uint64, count=num_queries * top_k)
    return ids.reshape(num_queries, top_k)
