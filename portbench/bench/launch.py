"""A cell on several cards: one process a card, each running the cell
(:func:`rank`), joined by ``torch.distributed`` with a TCP rendezvous on a
free port of this machine (nothing written to disk for it).

The launching process (``run.py``) starts them with the environment that
``torch.distributed`` reads (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) and the run's start time, waits for all,
ends all as soon as one fails, and takes rank 0's result once every one
has ended well. Each process is

    python3 -m portbench.bench.launch --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
#: the longest that the processes of one run may take (a first run builds)
LIMIT_S = 1150.0
#: the run's start time, handed to its processes
T0_VAR = "PORTBENCH_T0"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs: List[subprocess.Popen]) -> None:
    """End every process still running, and wait for each."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    end = time.time() + 15.0
    for p in procs:
        try:
            p.wait(max(0.1, end - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _term(signum, frame):
    raise SystemExit(128 + signum)


def launch(cmd: List[str], n: int, t0: float, limit: float = LIMIT_S
           ) -> Optional[Dict]:
    """Run ``cmd`` as ranks 0 .. n-1 of one process group; rank 0's last
    line of standard output (a JSON object) once all have ended with 0,
    else None. Their standard error, and the others' standard output, go
    to this process's standard error."""
    port = free_port()
    path = os.pathsep.join(filter(None, [str(ROOT),
                                         os.environ.get("PYTHONPATH")]))
    procs, lines = [], []
    prev = signal.signal(signal.SIGTERM, _term)
    try:
        for r in range(n):
            # the harness's own gloo group on the loopback device, which a
            # machine without a network has too
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), PYTHONPATH=path,
                       GLOO_SOCKET_IFNAME=os.environ.get(
                           "GLOO_SOCKET_IFNAME", "lo"),
                       **{T0_VAR: repr(t0)})
            procs.append(subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
                stdout=subprocess.PIPE if r == 0 else sys.stderr))
        reader = threading.Thread(
            target=lambda: lines.extend(
                procs[0].stdout.read().decode().splitlines()), daemon=True)
        reader.start()
        end = time.time() + limit
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc == 0 for rc in rcs) or time.time() > end or any(
                    rc not in (None, 0) for rc in rcs):
                break
            time.sleep(0.2)
    finally:
        _stop(procs)
        signal.signal(signal.SIGTERM, prev)
    reader.join(30.0)
    rcs = [p.returncode for p in procs]
    if any(rcs) or not lines:
        print(f"portbench: the {n} processes ended with {rcs}",
              file=sys.stderr)
        return None
    return json.loads(lines[-1])


def run(cell, seed: int, seconds: int, trace: bool, t0: float
        ) -> Optional[Dict]:
    """The result of one run of ``cell`` on ``cell.chips`` cards."""
    cmd = [sys.executable, "-m", "portbench.bench.launch", "--workload",
           cell.name, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(int(trace))]
    return launch(cmd, cell.chips, t0)


def rank(cell, seed: int, seconds: int, trace: bool, device="cuda") -> int:
    """This process's part of a run of ``cell``: join the group, run the
    cell, and on rank 0 print the result as the last line."""
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        initialize_distributed

    from . import cells
    from . import record as R

    R.TAG = f"[{os.environ['RANK']}]"
    initialize_distributed(device)
    if device == "cuda":
        import torch

        # this process's card by index: the prefetch thread, which puts the
        # batches on the device, does not share the main thread's current
        # device
        device = torch.device("cuda", torch.cuda.current_device())
    result = cells.run(cell, seed, seconds, trace,
                       float(os.environ[T0_VAR]), device)
    bad = cells.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    if result is not None:
        print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from . import manifest

    return rank(manifest.cell(args.workload), args.seed, args.seconds,
                bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
