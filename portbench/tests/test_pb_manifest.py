"""BENCHMARK.json against the contract's shape, and the by-name discovery
of each cell's configuration, traffic, metric readers and limits, for the
cells of BENCHMARK.json and the held-out ones of ``held_out.json``."""

import json
import re

import pytest

from tiny import ROOT, bench
from portbench.bench import manifest

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
ALL = bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
HELD = [w["name"] for w in ALL["workloads"] if w["name"] not in CELLS]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("b", [BENCH, ALL], ids=["benchmark", "held_out"])
def test_names_units_and_bounds(b):
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    moves = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in moves for m in b["per_layer"])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def test_held_out_cells_stay_out():
    assert HELD and not set(HELD) & set(CELLS)
    with pytest.raises(KeyError):
        manifest.cell(HELD[0])


@pytest.mark.parametrize("workload", CELLS + HELD)
def test_cell_found_by_name(workload):
    c = manifest.cell(workload, ALL)
    w = {x["name"]: x for x in ALL["workloads"]}[workload]
    conf = {x["name"]: x for x in ALL["configs"]}[w["config"]]
    assert c.config["name"] == w["config"]
    assert sorted(c.config["reduced"]) == sorted(conf["reduced"])
    assert c.traffic["kind"] in ("train", "serve")
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert c.limits, "every cell has the limits of its correctness numbers"


@pytest.mark.parametrize("kind,metric", [
    ("end_to_end", m["name"]) for m in ALL["end_to_end"]] + [
    ("metrics", m["name"]) for m in ALL["per_layer"]])
def test_every_metric_has_a_reader(kind, metric):
    assert callable(manifest.reader(kind, metric))
