"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``;
- an end-to-end metric: ``end_to_end/<name>.py``; a per-layer metric:
  ``metrics/<name>.py``. Each defines ``read(run) -> float | None`` over
  the finished run's record (:class:`portbench.bench.record.Run`); None
  leaves the metric out of the line;
- the limits of a cell's correctness numbers: ``limits/<workload>.json``.

A later change adds a cell, a mix or a metric by adding such files and
their entries, never by editing these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, float]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> Dict:
    return _json(root / "BENCHMARK.json")


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, bench: Optional[Dict] = None,
         root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic, metrics (those that apply to it) and limits."""
    bench = bench if bench is not None else load(root)
    w = {c["name"]: c for c in bench["workloads"]}.get(workload)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    lim = HERE / "limits" / f"{workload}.json"
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_json(root / conf["file"]),
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        limits=_json(lim) if lim.exists() else {})


def reader(kind: str, name: str):
    """The ``read`` function of metric ``name`` (``kind``: "end_to_end" or
    "metrics")."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[Dict], kind: str, run) -> Dict[str, Dict]:
    """{name: {"value", "unit"}} of the metrics whose reader finds
    something to read in ``run``."""
    out = {}
    for m in metrics:
        v = reader(kind, m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
