"""One run of a cell, judged and reduced to the contract's result line."""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Dict, Optional

from . import judge as J
from . import manifest
from . import record as R

#: top-level module names that may not be loaded (the JAX package's name
#: is a prefix of the port's: names compare whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "tencent_recommendation_2025_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(device="cuda") -> Dict:
    """The card's name and power limit as ``nvidia-smi`` reads them (a run
    on the CPU, as the tests make: the CPU)."""
    import torch

    if str(device) == "cpu":
        return {"platform": "cpu", "kind": "cpu"}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        lim = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.split("\n")[0].strip()
        out["power_limit"] = lim
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "unknown"
    return out


def breakdown(t: R.Trace) -> Dict:
    """The traced stretch's ten heaviest device operations and its idle
    time by the host span it fell in, seconds."""
    top = sorted(t.kernels_ms.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(t.idle_by_span_s.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:200], v / 1e3] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def judged(cell, seed: int, seconds: int, trace: bool, t0: float,
           device="cuda"):
    """(Run, numbers, peak bytes, notes on a failed check) of one run;
    None on every process but rank 0 of several."""
    if cell.traffic["kind"] == "train":
        from . import train_cell

        got = train_cell.run_cell(cell, seed, seconds, trace, t0,
                                  device=device)
        if got is None:
            return None
        run, prog, ref, peak = got
        numbers = J.train_numbers(prog, ref)
        return run, numbers, peak, {
            "numbers": numbers, "loss": [prog["loss"], ref["loss"]],
            **J.worst_leaves(prog, ref)}
    from . import serve_cell

    run, numbers, peak = serve_cell.run_cell(cell, seed, seconds, trace, t0,
                                             device=device)
    return run, numbers, peak, {"numbers": numbers}


def run(cell, seed: int, seconds: int, trace: bool, t0: float,
        device="cuda") -> Optional[Dict]:
    """The result of one run (None on every process but rank 0)."""
    got = judged(cell, seed, seconds, trace, t0, device)
    if got is None:
        return None
    run, numbers, peak, notes = got
    correct, checks = J.judge(numbers, cell.limits)
    kind, name = ("metrics", cell.per_layer) if trace else \
        ("end_to_end", cell.end_to_end)
    dev = dict(card(device), count=cell.chips, memory_peak_bytes=int(peak))
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.traced_s
    out = {"correct": bool(correct), "attempted": run.units * run.rows,
           "failed": 0,
           "metrics": manifest.read_metrics(name, kind, run),
           "device": dev}
    if run.trace is not None:
        out["breakdown"] = breakdown(run.trace)
    out["notes"] = notes
    out["checks"] = checks
    return out


def emit(result: Dict) -> int:
    """Print the checks on standard error, then the result line last."""
    notes = result.pop("notes", {})
    print(("portbench: not correct; " if not result["correct"] else
           "portbench: ") + json.dumps(notes), file=sys.stderr)
    for line in J.summary_line(result["checks"]):
        print("check " + line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
