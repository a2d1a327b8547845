#!/usr/bin/env python3
"""Device time and idle gaps of a ``torch.profiler`` trace, by host span.

    python3 scripts/trace_spans.py TRACE.json [--units N]
    python3 scripts/trace_spans.py --cell flagship.serve --seed N \\
        --out DIR [--requests 2]

The first form reads a Chrome trace that ``torch.profiler`` wrote
(``cli.train --profile_steps``, ``utils.debug.profile_trace``, any
``export_chrome_trace``). The second records one: it builds a serving cell
of ``portbench`` on the card, runs its warm-up requests, then ``--requests``
more under ``utils.debug.profile_trace`` into ``DIR/trace.json`` (inside the
benchmark's own ``pb.*`` ranges, as ``portbench/bench/serve_cell.py``
sends them), and reads that.

The spans are the host ranges whose names start with ``rec.`` (the
port's, ``utils/tracing.py``) or ``pb.`` (the benchmark's). Each
device operation (kernel, copy, set) is tied by its correlation id to the
runtime call that launched it, and so to every span open on the launching
thread at the launch; a launch from a thread that opens no span (autograd's
backward thread) goes by its time to the spans of the main thread: of the
threads that open spans, the one with the most launches. Printed as JSON, each figure over ``--units`` (the requests or
steps the trace holds):

- ``busy_ms``, ``idle_ms``: the union of the card's operations, and the
  gaps between its first and last;
- by span, ``device_ms``: the union of its operations' device intervals;
  ``lane_ms``: where the span has a device-lane copy (a user annotation's),
  the busy time inside that copy's range, as ``portbench``'s ``spans_ms``
  reads it; ``idle_ms``: the gaps whose middle the launching thread spent
  (the main thread) with this span innermost; ``idle_within_ms``: those it spent anywhere
  inside it; ``calls``;
- ``idle_outside_ms``: the gaps outside every span;
- ``counters``: the trace's ``rec.counters`` (the port's counters' change
  while it was recorded), where it has them.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: the name prefixes of the spans
PREFIXES = ("rec.", "pb.")
#: device-lane categories of the card's own work
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
#: host categories of a launch (a CUDA runtime call, or a driver call for
#: a kernel launched through the driver API, as Triton's are)
LAUNCH = ("cuda_runtime", "cuda_driver")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(merged) -> float:
    return sum(e - s for s, e in merged)


def _open_spans(spans, points):
    """For each of ``points`` (sorted times), the spans of one thread open
    there, outermost first. Spans of one thread nest (they are scopes)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append([s for s in stack if s[1] >= t])
    return out


def summarize(trace, units: float = 1.0):
    """The figures listed in the module's docstring, of a loaded trace."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    launches, devops, lanes = {}, [], collections.defaultdict(list)
    spans = collections.defaultdict(list)       # thread -> [(lo, hi, name)]
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in LAUNCH and corr is not None:
            launches[corr] = (e["tid"], lo)
        elif cat in DEVICE:
            devops.append((lo, hi, corr))
        elif cat == "gpu_user_annotation":
            if name.startswith(PREFIXES):
                lanes[name].append((lo, hi))
        elif name.startswith(PREFIXES):
            spans[e["tid"]].append((lo, hi, name))
    busy = _merge([(lo, hi) for lo, hi, _ in devops])
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
    main = collections.Counter(t for t, _ in launches.values()
                               if t in spans).most_common(1)
    main = main[0][0] if main else None

    by_thread = collections.defaultdict(list)
    for lo, hi, corr in devops:
        if corr in launches:
            tid, t = launches[corr]
            by_thread[tid].append((t, (lo, hi)))
    under = collections.defaultdict(list)
    for tid, got in by_thread.items():
        got.sort(key=lambda x: x[0])
        own = spans[tid] if tid in spans else spans.get(main, [])
        for (_, iv), open_ in zip(got, _open_spans(
                own, [t for t, _ in got])):
            for s in open_:
                under[s[2]].append(iv)

    idle, within, outside = collections.Counter(), collections.Counter(), 0.0
    mids = [(a + b) / 2 for a, b in gaps]
    for (a, b), open_ in zip(gaps, _open_spans(spans.get(main, []), mids)):
        if not open_:
            outside += b - a
            continue
        idle[open_[-1][2]] += b - a
        for name in {s[2] for s in open_}:
            within[name] += b - a

    def ms(us):
        return us / 1e3 / units

    calls = collections.Counter(n for ss in spans.values() for *_, n in ss)
    table = {}
    for name in sorted(calls):
        row = {"device_ms": ms(_length(_merge(under.get(name, [])))),
               "idle_ms": ms(idle[name]), "idle_within_ms": ms(within[name]),
               "calls": calls[name] / units}
        if name in lanes:
            row["lane_ms"] = ms(sum(
                max(0.0, min(e, hi) - max(s, lo))
                for lo, hi in lanes[name] for s, e in busy
                if e > lo and s < hi))
        table[name] = row
    return {"units": units, "busy_ms": ms(_length(busy)),
            "idle_ms": ms(sum(b - a for a, b in gaps)),
            "idle_outside_ms": ms(outside),
            "unlinked_ops": sum(c not in launches for *_, c in devops),
            "spans": table,
            "counters": trace.get("rec.counters", {})}


def record_cell(cell_name: str, seed: int, out: Path, requests: int) -> Path:
    """``out/trace.json`` of ``requests`` requests of a serving cell, after
    its warm-up."""
    sys.path.insert(0, str(ROOT))
    from torch.profiler import record_function

    from portbench.bench import manifest, program as PG, record as R
    from portbench.bench import serve_cell as SC, traffic as TF
    from tencent_recommendation_2025_tpu_torch.retrieval.mips import \
        topk_mips
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR
    from tencent_recommendation_2025_tpu_torch.utils.debug import \
        profile_trace

    device = "cuda"
    cell = manifest.cell(cell_name)
    cj, tr = cell.config, cell.traffic
    B, k = tr["rows_per_chip"], tr["top_k"]
    cfg = PG.port_config(cj, B)
    model = PG.port_model(cj, cfg)
    batches = TF.make_batches(tr, PG.model_info(cj), seed, B, train=False)
    _, dev = PG.static_tables(cj, seed, device, host_sparse=False)
    tree = PG.nest(PG.make_params(cj, seed, device,
                                  PG.item_rows(cfg, cj["data"]["itemnum"])))
    corpus = SC.make_corpus(seed, tr["corpus_rows"],
                            cj["model"]["hidden_units"], device)

    def request(b):
        with record_function("pb.put"):
            bd = TR.put_batch(b, device)
        with record_function("pb.predict"):
            q = model.predict(tree, bd, dev["mm"])
        with record_function("pb.mips"):
            s, i = topk_mips(q, corpus, k)
        with record_function("pb.fetch"):
            return s.cpu(), i.cpu()

    n = tr["warmup_requests"]
    for j in range(n):
        request(batches[j % len(batches)])
    R.sync()
    with profile_trace(str(out)):
        for j in range(n, n + requests):
            request(batches[j % len(batches)])
    return out / "trace.json"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trace", nargs="?", help="a trace.json to read")
    p.add_argument("--units", type=float, default=None,
                   help="requests or steps in the trace (figures per unit; "
                        "--cell: --requests)")
    p.add_argument("--cell", help="record a serving cell of portbench")
    p.add_argument("--seed", type=int, default=2 ** 31 + 7)
    p.add_argument("--requests", type=int, default=2)
    p.add_argument("--out", default="build/trace_spans")
    a = p.parse_args(argv)
    if (a.trace is None) == (a.cell is None):
        p.error("give a trace.json or --cell")
    path = Path(a.trace) if a.trace else record_cell(
        a.cell, a.seed, Path(a.out), a.requests)
    units = a.units or (a.requests if a.cell else 1.0)
    got = summarize(json.loads(path.read_text()), units)
    print(json.dumps(got, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
