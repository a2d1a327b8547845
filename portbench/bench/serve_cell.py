"""A serving cell: one client in a closed loop sends a batch of test users,
the port encodes it (``SeqRecModel.predict``) and takes the exact top-k
of a corpus that stays on the card (``retrieval.mips.topk_mips``, the
exact path of ``run_ann``), and the ids and scores come back to the host.
A request's latency runs from its host batch to its ids on the host.

After the window a sample of its requests, drawn from the seed, is judged:
the reference encodes the same users in float32 and scores the program's
queries against the whole corpus exactly.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from . import judge as J
from . import program as PG
from . import record as R
from . import traffic as TF

#: corpus rows scored at a time by the exact check
_CHECK_BLOCK = 1 << 20


def make_corpus(seed: int, rows: int, dim: int, device) -> torch.Tensor:
    """The candidate corpus [rows, dim] f32, drawn on the device (the
    item tower's output over the catalogue, an offline job)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63) ^ 0xC0C0)
    return torch.randn((rows, dim), generator=g, device=device)


def exact_topk(q: torch.Tensor, corpus: torch.Tensor, k: int):
    """(scores, ids) of the exact top ``k`` of f32 products, in blocks."""
    best_s = torch.full((q.shape[0], k), -float("inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.long, device=q.device)
    for lo in range(0, corpus.shape[0], _CHECK_BLOCK):
        s = q @ corpus[lo:lo + _CHECK_BLOCK].T
        top = torch.topk(s, k, dim=1)
        cat_s = torch.cat([best_s, top.values], 1)
        cat_i = torch.cat([best_i, top.indices + lo], 1)
        sel = torch.topk(cat_s, k, dim=1).indices
        best_s, best_i = cat_s.gather(1, sel), cat_i.gather(1, sel)
    return best_s, best_i


def serve_check(queries, ref_queries, ids, scores, corpus, k) -> Dict:
    """The serving numbers of answers (``queries``, ``ids``, ``scores``)
    against the exact products of those queries and ``ref_queries``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = queries.float()
    exact = (q.double()[:, None, :]
             * corpus[ids].double()).sum(-1).float()
    kth = exact_topk(q, corpus, k)[0][:, -1]
    rms = corpus.pow(2).sum(-1).mean().sqrt()
    scale = q.norm(dim=-1) * rms
    return J.serve_numbers(q, ref_queries.float(), ids, scores.float(),
                           exact, kth, scale)


def reference_queries(cj, seed: int, params, batches: List[Dict], dev,
                      device, fp8: bool = False) -> torch.Tensor:
    """The reference's query vectors of host ``batches``."""
    from ..reference.model import Numerics, Reference

    torch.backends.cuda.matmul.allow_tf32 = False
    vocab = PG.feature_vocab(cj)
    mm = dev["mm"][cj["data"]["mm_emb_ids"][0]]
    ref = Reference(cj, mm=lambda ids: mm[ids],
                    feats=lambda ids: TF.item_sparse(ids, seed, vocab, torch),
                    nm=Numerics(fp8=fp8))
    out = []
    for b in batches:
        bt = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        for lo in range(0, bt["seq"].shape[0], 16):
            out.append(ref.queries(params, {k: v[lo:lo + 16]
                                            for k, v in bt.items()}))
    return torch.cat(out)


def run_cell(cell, seed: int, seconds: int, trace: bool, t0: float,
             device="cuda"):
    """(Run, serving numbers, device memory peak) of one run."""
    from tencent_recommendation_2025_tpu_torch.retrieval.mips import \
        topk_mips
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cj, tr = cell.config, cell.traffic
    B, k = tr["rows_per_chip"], tr["top_k"]
    cfg = PG.port_config(cj, B)
    model = PG.port_model(cj, cfg)
    run = R.Run(kind="serve", chips=1, config=cj, traffic=tr, rows=B)
    R.log(t0, "port imported")
    batches = TF.make_batches(tr, PG.model_info(cj), seed, B, train=False)
    _, dev = PG.static_tables(cj, seed, device, host_sparse=False)
    params = PG.make_params(cj, seed, device,
                            PG.item_rows(cfg, cj["data"]["itemnum"]))
    tree = PG.nest(params)
    corpus = make_corpus(seed, tr["corpus_rows"],
                         cj["model"]["hidden_units"], device)
    R.log(t0, "batches, tables, weights, corpus")

    def request(b):
        with record_function("pb.put"):
            bd = TR.put_batch(b, device)
        with record_function("pb.predict"):
            q = model.predict(tree, bd, dev["mm"])
        with record_function("pb.mips"):
            s, i = topk_mips(q, corpus, k)
        with record_function("pb.fetch"):
            return q, s.cpu(), i.cpu()

    for j in range(tr["warmup_requests"]):
        request(batches[j % len(batches)])
    R.sync()
    R.log(t0, f"{tr['warmup_requests']} warm-up requests")
    R.reset_peak()
    answers, prof = [], None
    t_w = time.time()
    deadline = t_w + seconds
    while time.time() < deadline:
        j = len(answers)
        if trace and j == tr["traced_from"]:
            t_prof = time.time()
            prof = R.profile_stretch()
        t = time.perf_counter()
        answers.append(request(batches[j % len(batches)]))
        run.latencies_ms.append((time.perf_counter() - t) * 1e3)
        if prof is not None and (j + 1 == tr["traced_from"]
                                 + tr["traced_requests"]
                                 or time.time() >= deadline):
            n = j + 1 - tr["traced_from"]
            run.trace = R.finish_stretch(*prof, n)
            prof = None
            wall = time.time() - t_prof
            run.traced_wall_s += wall
            run.traced_units += n
            deadline += wall       # the untraced part keeps its length
    t_end = time.time()
    peak = R.peak_bytes()
    run.setup_s, run.window_s, run.units = t_w - t0, t_end - t_w, \
        len(answers)
    lat = run.latencies_ms
    R.log(t0, f"window: {len(lat)} requests in {run.window_s:.2f} s, "
          f"first {', '.join(f'{x:.1f}' for x in lat[:8])} ms, median "
          f"{sorted(lat)[len(lat) // 2]:.1f}, max {max(lat):.1f}")

    # the sample judged: requests drawn from the seed
    rng = np.random.default_rng([int(seed) % (1 << 63), 13])
    pick = sorted(rng.choice(len(answers), min(tr["checked_requests"],
                                               len(answers)), replace=False))
    q = torch.cat([answers[j][0] for j in pick])
    scores = torch.cat([answers[j][1] for j in pick]).to(device)
    ids = torch.cat([answers[j][2] for j in pick]).to(device)
    del answers
    R.free()
    rq = reference_queries(cj, seed, params,
                           [batches[j % len(batches)] for j in pick], dev,
                           device)
    numbers = serve_check(q, rq, ids, scores, corpus, k)
    R.log(t0, "reference")
    return run, numbers, peak
