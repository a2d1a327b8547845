#!/usr/bin/env python3
"""Readings that set a cell's correctness limits, on the card, at the
cell's own size, in one process:

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2]

- ``program``: one run of the cell a seed (a short window), its numbers
  against the reference (the lower reading is the largest over the seeds);
- ``control``: the reference put in the program's place, computing in the
  precision below the configuration's bf16 (every matrix product on
  float8 e4m3 operands; serving's top-k on TF32), against the reference;
- faults planted in the reference put in the program's place (training):
  ``half_batch`` (the first half of each batch, the mean over it),
  ``frozen`` (the state left unchanged) and, on several cards,
  ``exchange`` (no exchange between the cards: rank 0's rows alone, the
  mean over them).

A cell on several cards takes its program readings from its own runs
(``run.py``); its control and faults, the reference at the cell's global
batch, run here on one card.

Prints one JSON line a reading; the limits go to ``limits/<workload>.json``
by the rule in PERF.md.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def emit(workload, who, seed, numbers, **more):
    print(json.dumps({"workload": workload, "who": who, "seed": seed,
                      **numbers, **more}), flush=True)


def train_controls(cell, seed, device):
    from portbench.bench import judge as J
    from portbench.bench import record as R
    from portbench.bench.train_cell import Inputs, reference_steps

    x = Inputs(cell, seed, device, time.time())
    cj, cfg = cell.config, x.cfg
    batches, init = x.batches[:x.checked], x.init
    dev, uni, table = x.dev, x.uni, x.table
    del x
    R.free()
    ref = reference_steps(cj, cfg, seed, init, batches, dev, uni, table,
                          device)
    B = cfg.train.batch_size
    faults = [("control", {"fp8": True}), ("half_batch", {"rows": B // 2}),
              ("frozen", {"frozen": True})]
    if cell.chips > 1:
        faults.append(("exchange", {"rows": B // cell.chips}))
    out = {}
    for who, kw in faults:
        got = reference_steps(cj, cfg, seed, init, batches, dev, uni, table,
                              device, **kw)
        out[who] = J.train_numbers(got, ref)
    return out


def serve_controls(cell, seed, device):
    import torch

    from portbench.bench import program as PG
    from portbench.bench import traffic as TF
    from portbench.bench.serve_cell import (exact_topk, make_corpus,
                                            reference_queries, serve_check)

    cj, tr = cell.config, cell.traffic
    B, k = tr["rows_per_chip"], tr["top_k"]
    cfg = PG.port_config(cj, B)
    batches = TF.make_batches(tr, PG.model_info(cj), seed, B, train=False)
    batches = batches[:tr["checked_requests"]]
    _, dev = PG.static_tables(cj, seed, device, host_sparse=False)
    params = PG.make_params(cj, seed, device,
                            PG.item_rows(cfg, cj["data"]["itemnum"]))
    corpus = make_corpus(seed, tr["corpus_rows"],
                         cj["model"]["hidden_units"], device)
    rq = reference_queries(cj, seed, params, batches, dev, device)
    cq = reference_queries(cj, seed, params, batches, dev, device, fp8=True)
    torch.backends.cuda.matmul.allow_tf32 = True
    scores, ids = exact_topk(cq, corpus, k)
    return {"control": serve_check(cq, rq, ids, scores, corpus, k)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from portbench.bench import cells
    from portbench.bench import judge as J
    from portbench.bench import manifest
    from portbench.bench import record as R
    from portbench.bench import train_cell

    cell = manifest.cell(args.workload)
    for s in filter(None, args.seeds.split(",")):
        if cell.traffic["kind"] == "train":
            _, prog, ref, _ = train_cell.run_cell(
                cell, int(s), args.seconds, False, time.time(), args.device)
            gmed = statistics.median(ref["grad"].values())
            emit(args.workload, "program", int(s), J.train_numbers(prog, ref),
                 leaves={k: abs(prog["grad"][k] - r) / max(r, gmed)
                         for k, r in ref["grad"].items()})
        else:
            _, numbers, _, _ = cells.judged(cell, int(s), args.seconds, False,
                                            time.time(), args.device)
            emit(args.workload, "program", int(s), numbers)
        R.free()
    for s in filter(None, args.control_seeds.split(",")):
        fn = train_controls if cell.traffic["kind"] == "train" \
            else serve_controls
        for who, numbers in fn(cell, int(s), args.device).items():
            emit(args.workload, who, int(s), numbers)
        R.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
