"""Cells of ``BENCHMARK.json`` and of ``held_out.json`` cut to a size the
CPU runs in a second, for the benchmark's own tests (the widths, depth,
window, tables and corpus shrunk; the traffic's shape, the code paths and
the limits kept)."""

from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import cells, manifest  # noqa: E402


def bench():
    """``BENCHMARK.json`` with the held-out cells, configurations and
    metrics of ``portbench/held_out.json`` added."""
    out = manifest.load()
    held = json.loads((ROOT / "portbench" / "held_out.json").read_text())
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        out[k] = out[k] + held[k]
    return out


def cell(workload: str, dtype=None, chips=None) -> manifest.Cell:
    """``workload`` at the tests' size; ``chips``: run on that many
    processes instead of the cell's own cards."""
    c = manifest.cell(workload, bench())
    cj = copy.deepcopy(c.config)
    cj["model"].update(hidden_units=16, num_blocks=2, maxlen=63)
    if dtype:
        cj["model"]["dtype"] = dtype
    cj["data"].update(itemnum=500, usernum=50, feature_vocab=20)
    tr = dict(c.traffic, rows_per_chip=4, history_events=[10, 60],
              batches=4)
    if tr["kind"] == "serve":
        tr.update(corpus_rows=5000, checked_requests=3)
    return manifest.Cell(c.name, chips or c.chips, cj, tr, c.end_to_end,
                         c.per_layer, c.limits)


def run(c: manifest.Cell, seed: int = 2 ** 31 + 17):
    """(correct, numbers) of one run of ``c`` on the CPU: a training cell's
    window takes the steps already prefetched, a serving cell's a second."""
    from portbench.bench import judge as J

    seconds = 1 if c.traffic["kind"] == "serve" else 0
    _, numbers, _, _ = cells.judged(c, seed, seconds, False, time.time(),
                                    device="cpu")
    return J.judge(numbers, c.limits)[0], numbers
