"""The comparison that decides ``correct``, at a size the CPU holds, with
each cell's own limits: the port's plain path passes; the control (the
reference in the program's place, one precision below the configuration)
fails; so does a run whose timed path is broken underneath."""

import time

import pytest
import torch

import tiny
from portbench.bench import judge as J

TRAIN = ["flagship.train", "sparse100m.train"]


@pytest.mark.parametrize("workload", TRAIN + ["flagship.serve"])
def test_plain_path_passes(workload):
    ok, numbers = tiny.run(tiny.cell(workload, dtype="float32"))
    assert ok, numbers


@pytest.mark.parametrize("workload", TRAIN)
def test_train_control_fails(workload):
    from portbench.bench.train_cell import Inputs, reference_steps

    c = tiny.cell(workload)
    x = Inputs(c, 2 ** 31 + 5, "cpu", time.time())
    args = (c.config, x.cfg, 2 ** 31 + 5, x.init, x.batches[:x.checked],
            x.dev, x.uni, x.table, "cpu")
    ref = reference_steps(*args)
    control = reference_steps(*args, fp8=True)
    ok, _ = J.judge(J.train_numbers(control, ref), c.limits)
    assert not ok


def test_serve_control_fails():
    from portbench.bench import program as PG
    from portbench.bench import traffic as TF
    from portbench.bench.serve_cell import (exact_topk, make_corpus,
                                            reference_queries, serve_check)

    c = tiny.cell("flagship.serve")
    cj, tr, seed = c.config, c.traffic, 2 ** 31 + 5
    batches = TF.make_batches(tr, PG.model_info(cj), seed, 4, False)[:3]
    _, dev = PG.static_tables(cj, seed, "cpu", host_sparse=False)
    params = PG.make_params(cj, seed, "cpu", cj["data"]["itemnum"] + 1)
    corpus = make_corpus(seed, tr["corpus_rows"], 16, "cpu")
    rq = reference_queries(cj, seed, params, batches, dev, "cpu")
    cq = reference_queries(cj, seed, params, batches, dev, "cpu", fp8=True)
    scores, ids = exact_topk(cq, corpus, 10)
    ok, _ = J.judge(serve_check(cq, rq, ids, scores, corpus, 10), c.limits)
    assert not ok


def _frozen_step(monkeypatch):
    """Every step returns the parameters as it found them."""
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    make = TR.make_train_step

    def broken(model, cfg, mesh=None):
        step = make(model, cfg, mesh)

        def s(state, *a):
            keep = {k: p.detach().clone() for k, p in
                    TR.param_leaves(state.params)}
            out = step(state, *a)
            with torch.no_grad():
                for k, p in TR.param_leaves(state.params):
                    p.copy_(keep[k])
            return out

        return s

    monkeypatch.setattr(TR, "make_train_step", broken)


def _half_batch(monkeypatch):
    """The loss over the first half of the batch's rows, its mean."""
    from tencent_recommendation_2025_tpu_torch.ops import losses as LS

    bce = LS.reference_bce_loss

    def broken(pos, neg, mask, count=None):
        h = pos.shape[0] // 2
        return bce(pos[:h], neg[:h], mask[:h])

    monkeypatch.setattr(LS, "reference_bce_loss", broken)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_frozen_step, _half_batch])
def test_broken_train_step_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    ok, numbers = tiny.run(tiny.cell(workload, dtype="float32"))
    assert not ok, numbers


def test_altered_answer_is_not_correct(monkeypatch):
    from tencent_recommendation_2025_tpu_torch.retrieval import mips

    topk = mips.topk_mips

    def broken(q, corpus, k=10, **kw):
        s, i = topk(q, corpus, k, **kw)
        i = i.clone()
        i[:, -1] = (i[:, -1] + 1) % corpus.shape[0]
        return s, i

    monkeypatch.setattr(mips, "topk_mips", broken)
    ok, numbers = tiny.run(tiny.cell("flagship.serve", dtype="float32"))
    assert not ok, numbers
