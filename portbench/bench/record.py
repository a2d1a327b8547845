"""What a finished run knows, for the metric readers.

``Run`` holds the host clock's readings of the window (every run) and,
with ``--trace 1``, the host timers around the program's entries and the
:class:`Trace` of a profiled stretch early in the window.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

#: span names the benchmark records around the program's entries
SPAN_PREFIX = "pb."


@dataclasses.dataclass
class Trace:
    """The card's profiled stretch of ``units`` steps or requests."""
    units: int
    traced_s: float
    busy_s: float
    collective_s: float         # busy with the collectives' kernels
    kernels_ms: Dict[str, float]
    spans_ms: Dict[str, float]
    idle_by_span_s: Dict[str, float]


@dataclasses.dataclass
class Run:
    kind: str                   # "train" or "serve"
    chips: int
    config: Dict
    traffic: Dict
    rows: int = 0               # rows of a step or request (global batch)
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0              # steps or requests in the window
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    host_s: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    trace: Optional[Trace] = None
    dedup: bool = False
    # the profiled stretch, its reduction included, and its steps or
    # requests: rates of a traced run leave them out
    traced_wall_s: float = 0.0
    traced_units: int = 0


#: this process's rank among several, in its log lines
TAG = ""


def log(t0: float, what: str) -> None:
    """A set-up or check phase's time since the run began, on stderr."""
    import sys

    print(f"portbench{TAG}: {time.time() - t0:8.2f} s  {what}",
          file=sys.stderr, flush=True)


def sync() -> None:
    """Wait for the card (nothing on a machine without one)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reset_peak() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def peak_bytes() -> int:
    import torch

    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0


def free() -> None:
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def profile_stretch():
    """A started ``torch.profiler`` (CPU and CUDA activities) and the
    host clock at its start, after the card has drained."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof, time.perf_counter()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _annotation(e) -> bool:
    """A device-timeline copy of a host range (``record_function``), not
    an operation of the card."""
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name.startswith(SPAN_PREFIX) or e.name.startswith("Optimizer.")


def _covered(busy, lo: float, hi: float) -> float:
    """The part of [lo, hi] that the merged ``busy`` intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in busy
               if e > lo and s < hi)


def _collective(name: str) -> bool:
    """A kernel of the collectives between cards (NCCL's)."""
    return "nccl" in name.lower()


def finish_stretch(prof, t0: float, units: int) -> Trace:
    """Stop ``prof`` after the card drains and reduce its events: device ms
    by operation name; the device time under each benchmark span (the
    card's busy time with its own work, collectives left out, inside the
    span's range on the device timeline); the union of the card's busy
    intervals, and of those of its collectives; and the idle gaps between
    them by the innermost benchmark span the host was in at the gap's
    middle."""
    from torch.autograd import DeviceType

    sync()
    traced_s = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    kernels = collections.Counter()
    dev, coll, host, ranges = [], [], [], []
    for e in prof.events():
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if _annotation(e):
                if e.name.startswith(SPAN_PREFIX):
                    ranges.append((lo, hi, e.name))
                continue
            kernels[e.name] += (hi - lo) / 1e3
            (coll if _collective(e.name) else dev).append((lo, hi))
        elif e.name.startswith(SPAN_PREFIX):
            host.append((lo, hi, e.name))
    own, coll = _merge(dev), _merge(coll)
    busy = _merge(own + coll)
    spans = collections.Counter()
    for lo, hi, name in ranges:
        spans[name] += _covered(own, lo, hi) / 1e3
    idle = collections.Counter()
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
        idle[min(inside)[1] if inside else "loop"] += (b - a) / 1e6
    return Trace(units=units, traced_s=traced_s,
                 busy_s=sum(e - s for s, e in busy) / 1e6,
                 collective_s=sum(e - s for s, e in coll) / 1e6,
                 kernels_ms=dict(kernels), spans_ms=dict(spans),
                 idle_by_span_s=dict(idle))


def traced(run: Run, fn) -> Optional[float]:
    """``fn(trace)`` of a traced run (None untraced)."""
    return None if run.trace is None else fn(run.trace)


def kernel_ms(trace: Trace, names) -> float:
    """Device ms of the kernels whose name holds any of ``names``."""
    return sum(v for k, v in trace.kernels_ms.items()
               if any(n in k for n in names))
