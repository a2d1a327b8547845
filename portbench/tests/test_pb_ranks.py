"""A training cell on four cards, at the tests' size on the CPU: four
processes joined by gloo through the launcher, the port's process mesh
(data 4) over them, the row-sparse table row-sharded. The plain path comes
out correct; with the exchange between the cards left out, the state left
unchanged or half of each batch left out it does not."""

import sys
import time

import pytest

from tiny import ROOT
from portbench.bench import launch

CELLS = ["sparse100m.train", "flagship.train"]


def _run(workload, fault=""):
    cmd = [sys.executable, str(ROOT / "portbench" / "tests" / "ranks.py"),
           "--workload", workload] + (["--fault", fault] if fault else [])
    return launch.launch(cmd, 4, time.time(), limit=240)


@pytest.mark.parametrize("workload", CELLS)
def test_plain_path_passes_on_four_processes(workload):
    result = _run(workload)
    assert result is not None
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4
    assert result["attempted"] > 0


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["exchange", "frozen", "half_batch"])
def test_broken_step_on_four_processes_is_not_correct(workload, fault):
    result = _run(workload, fault)
    assert result is not None
    assert not result["correct"], result["checks"]
