"""System diagnostics at start-up: the host, PyTorch and the cards.

Counterpart of ``tencent_recommendation_2025_tpu/utils/sysinfo.py``:
:func:`print_system_info` keeps its keys for the host (platform, python,
cpu_count, memory through psutil where it is installed) and prints
PyTorch's in place of JAX's (``torch_version``, ``cuda``, ``device_count``,
``devices``); :func:`parse_data_path_structure` is the same report.
"""

from __future__ import annotations

import os
import platform
from pathlib import Path


def format_file_size(num_bytes: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if num_bytes < 1024.0:
            return f"{num_bytes:.1f}{unit}"
        num_bytes /= 1024.0
    return f"{num_bytes:.1f}PB"


def print_system_info() -> dict:
    """Print and return the host's and PyTorch's facts: ``cuda`` is the CUDA
    release PyTorch was built for (None in a CPU build), ``devices`` each
    card's name."""
    info = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count(),
    }
    try:
        import psutil

        vm = psutil.virtual_memory()
        info["memory_total"] = format_file_size(vm.total)
        info["memory_available"] = format_file_size(vm.available)
    except Exception:
        pass
    import torch

    info["torch_version"] = torch.__version__
    info["cuda"] = torch.version.cuda
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info["device_count"] = n
    info["devices"] = [torch.cuda.get_device_name(i) for i in range(n)]
    for k, v in info.items():
        print(f"  {k}: {v}")
    return info


def parse_data_path_structure(data_path, max_depth: int = 2) -> str:
    """Directory tree + sizes report (O1 ``parse_data_path_structure``)."""
    lines = []
    root = Path(data_path)
    if not root.exists():
        return f"{data_path} (missing)"

    def walk(d: Path, depth: int):
        if depth > max_depth:
            return
        for p in sorted(d.iterdir()):
            indent = "  " * depth
            if p.is_dir():
                lines.append(f"{indent}{p.name}/")
                walk(p, depth + 1)
            else:
                lines.append(f"{indent}{p.name} "
                             f"({format_file_size(p.stat().st_size)})")

    lines.append(str(root))
    walk(root, 1)
    return "\n".join(lines)
