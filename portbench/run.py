#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads, warms up and checks (set-up), measures for ``--seconds``, judges
what the timed path produced against the plain reference, and prints as
its last line one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; last in it, and on
standard error, each number compared beside its limit. A cell on
several cards runs one process a card (``bench/launch.py``) and prints
rank 0's result once all have ended well. Exits non-zero without a result
when no card or too few cards are present, when a process of the run
fails, and when JAX or the JAX package is loaded in this process or in
one of the run's.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# one process with few threads: the port's host work is numpy on its own
# prefetch thread and kernel launches; no CPU thread pool does its work
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.bench import manifest

    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    from portbench.bench import cells

    if cell.chips == 1:
        result = cells.run(cell, args.seed, args.seconds, bool(args.trace),
                           T0)
    else:
        from portbench.bench import launch

        result = launch.run(cell, args.seed, args.seconds, bool(args.trace),
                            T0)
        if result is None:
            return 4
    bad = cells.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    return cells.emit(result)


if __name__ == "__main__":
    sys.exit(main())
