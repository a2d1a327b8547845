"""One process of a training cell run on four processes (a data mesh of 4,
as a four-card cell runs) at the tests' size, on the CPU (gloo), with a
fault planted in the program if asked:

    python3 portbench/tests/ranks.py --workload <name> [--fault <name>]

started as each rank by ``portbench.bench.launch.launch``. Faults:
``exchange`` (the dense gradients are not summed over the processes),
``frozen`` (every step returns the parameters as it found them),
``half_batch`` (the loss over the first half of each process's rows)."""

import argparse
import sys

import pytest

import tiny
from portbench.bench import launch
from test_pb_correct import _frozen_step, _half_batch


def _exchange(monkeypatch):
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    monkeypatch.setattr(TR, "_all_reduce_flat", lambda *a, **k: None)


FAULTS = {"exchange": _exchange, "frozen": _frozen_step,
          "half_batch": _half_batch}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", default="")
    args = p.parse_args()
    with pytest.MonkeyPatch.context() as mp:
        if args.fault:
            FAULTS[args.fault](mp)
        return launch.rank(tiny.cell(args.workload, dtype="float32",
                                     chips=4),
                           2 ** 31 + 23, 0, False, device="cpu")


if __name__ == "__main__":
    sys.exit(main())
