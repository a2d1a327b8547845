#!/usr/bin/env python3
"""The retrieval tiers of two checkouts, timed in turns on one card.

    python3 scripts/retrieval_ab.py --other build/parent

Each side runs in a process of its own (its checkout first on the path):
the seeded 10M x 64 corpus and 1024 queries of ``chip_smoke.py``'s
retrieval phase drawn on the card, ``topk_mips`` (exact), ``topk_mips_approx``
and ``topk_mips_int8`` each timed by the host clock around one
synchronised call after a warm-up on the first 100,000 rows, the ids
written to ``build/retrieval_ab/``. The sides run in the order
other, this, this, other; the script prints each run's times and whether
every run's ids equal the first run's, tier by tier.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "retrieval_ab"
N, D, Q, K, SEED = 10_000_000, 64, 1024, 10, 70

_SIDE = """
import json, sys, time
import numpy as np
import torch
from tencent_recommendation_2025_tpu_torch.retrieval import mips as M

gen = torch.Generator(device="cuda").manual_seed({seed})
corpus = torch.randn(({n}, {d}), generator=gen, device="cuda")
queries = torch.randn(({q}, {d}), generator=gen, device="cuda")
codes, scales = M.quantize_corpus_int8(corpus.cpu().numpy(), "cuda")
out = {{}}
for name, fn, args in (("exact", M.topk_mips, (corpus,)),
                       ("approx", M.topk_mips_approx, (corpus,)),
                       ("int8", M.topk_mips_int8, (codes, scales))):
    fn(queries, *(a[:100_000] for a in args), k={k})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ids = fn(queries, *args, k={k})
    torch.cuda.synchronize()
    out[name] = (time.perf_counter() - t0) * 1e3
    np.save("{out}/" + sys.argv[1] + "_" + name + ".npy", ids.cpu().numpy())
print(json.dumps(out))
"""


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--other", required=True,
                   help="root of the other checkout")
    args = p.parse_args()
    other = Path(args.other).resolve()
    OUT.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    code = _SIDE.format(seed=SEED, n=N, d=D, q=Q, k=K, out=OUT)
    runs = []
    for i, (side, root) in enumerate((("other", other), ("this", ROOT),
                                      ("this", ROOT), ("other", other))):
        tag = f"{i}_{side}"
        res = subprocess.run([sys.executable, "-c", code, tag], cwd=root,
                             env=dict(os.environ, PYTHONPATH=str(root)),
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(f"{tag} FAIL:\n{res.stderr[-3000:]}", file=sys.stderr)
            return 1
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append((tag, ms))
        print(f"{tag} ({root}): " + ", ".join(
            f"{k} {v:.1f} ms ({Q / v * 1e3:.0f} queries/s)"
            for k, v in ms.items()), flush=True)
    import numpy as np

    for tier in ("exact", "approx", "int8"):
        first = np.load(OUT / f"{runs[0][0]}_{tier}.npy")
        same = [bool(np.array_equal(first, np.load(OUT / f"{t}_{tier}.npy")))
                for t, _ in runs]
        print(f"{tier}: ids equal to run {runs[0][0]}'s: {same}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
