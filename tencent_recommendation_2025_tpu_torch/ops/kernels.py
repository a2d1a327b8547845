"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, ``build/torch_kernels/lib<name>-<hash>.so`` at the root
of the checkout, and loads with ``ctypes``. The file name carries a hash of
the source, so an edited kernel rebuilds and a built one is reused. The
build happens at first use (never at import: the CPU-only tests import every
module); :func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

#: kernel name -> its source under csrc/
SOURCES = {"fused_block": "fused_block.cu",
           "fused_block_bwd": "fused_block_bwd.cu",
           "flash_attention": "flash_attention.cu",
           "hstu_attention": "hstu_attention.cu",
           "sparse_table": "sparse_table.cu",
           "ring_pair": "ring_pair.cu",
           "mips_topk": "mips_topk.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "compiled from csrc/ at first use")
    return found


def library_path(name: str) -> Path:
    """The built library of ``name``: its file name carries a hash of the
    source and of every shared header under csrc/."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel source that is not built yet, one ``nvcc``
    process per source, all started together. Returns, per source built,
    its wall seconds and the ``-Xptxas -v`` report (registers, shared
    memory, spills). Raises with the compiler's output if a build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def _demangle(name: str) -> str:
    """A kernel's name and template arguments from its mangled name
    (``flash_fwd_wgmma_kernel<64>``); the mangled name where it is not a
    nested template name."""
    rest = name[3:] if name.startswith("_ZN") else ""
    base = None
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        base, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    if base is None:
        return name
    args = []
    if rest.startswith("I"):
        rest = rest[1:]
        while rest and rest[0] != "E":
            lit = re.match(r"L[a-z](\d+)E", rest)
            num = re.match(r"\d+", rest)
            if lit:
                args.append(lit.group(1))
                rest = rest[lit.end():]
            elif num:
                n = int(num.group())
                args.append(rest[num.end():num.end() + n].strip("_"))
                rest = rest[num.end() + n:]
            else:
                args.append({"f": "float", "i": "int", "b": "bool"}.get(
                    rest[0], rest[0]))
                rest = rest[1:]
    return base + (f"<{', '.join(args)}>" if args else "")


def ptxas_report(log: str) -> List[dict]:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its name, registers and
    spill stores and loads (bytes)."""
    out: List[dict] = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if entry:
            out.append({"kernel": _demangle(entry.group(1)),
                        "registers": None, "spill_stores": 0,
                        "spill_loads": 0})
        elif out and spill:
            out[-1]["spill_stores"] = int(spill.group(1))
            out[-1]["spill_loads"] = int(spill.group(2))
        elif out and regs:
            out[-1]["registers"] = int(regs.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]
