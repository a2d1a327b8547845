"""On a card: one short run of each cell through the command, correct and
with the contract's keys. Skips where the cell's cards are not present."""

import json
import subprocess
import sys

import pytest

from tiny import ROOT
from test_pb_manifest import CELLS


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(workload):
    import torch

    from portbench.bench import manifest

    chips = manifest.cell(workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
