"""The port's spans and counters (tencent_recommendation_2025_tpu_torch/
utils/tracing.py), on the CPU: the shared null context with no profiler;
spans that are no user annotations; a request's batch index in its span;
under ``torch.profiler`` the exact scan's spans a block, the towers' and
blocks' spans of ``predict``, the put's span and byte count; the rows a tie
at the k-th place scans again (and 0 without a tie); outputs bitwise equal
with the profiler on and off; the dedup prep's counters; and
``train_loop --profile_steps``'s trace holding the step's spans inside
``rec.train.step`` and the counters' change."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tencent_recommendation_2025_tpu_torch.config import (Config, ModelConfig,
                                                          TrainConfig)
from tencent_recommendation_2025_tpu_torch.data.dataset import TrainSampler
from tencent_recommendation_2025_tpu_torch.data.featurizer import (
    FusedVocab, build_item_tables)
from tencent_recommendation_2025_tpu_torch.data.pipeline import (
    TrainLoader, train_val_split)
from tencent_recommendation_2025_tpu_torch.data.readers import TencentGRData
from tencent_recommendation_2025_tpu_torch.data.schema import FeatureSchema
from tencent_recommendation_2025_tpu_torch.models.baseline import SeqRecModel
from tencent_recommendation_2025_tpu_torch.retrieval.mips import (
    retrieve_topk, topk_mips)
from tencent_recommendation_2025_tpu_torch.train import trainer as TTR
from tencent_recommendation_2025_tpu_torch.utils import tracing as TRC

torch.set_num_threads(2)

#: the scan's block: a corpus of 3 blocks
BLOCK = 16


@pytest.fixture(scope="module")
def world(synth_dir):
    cfg = Config(model=ModelConfig(hidden_units=32, num_blocks=2, num_heads=2,
                                   maxlen=20, dtype="float32"),
                 train=TrainConfig(batch_size=8, num_epochs=1))
    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    tr, _ = train_val_split(len(sampler), 0.1, 0)
    loader = TrainLoader(sampler, tr, cfg.train.batch_size, seed=0)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    state = TTR.init_state(model, cfg, device="cpu")
    return dict(cfg=cfg, model=model, loader=loader, tables=tables,
                params=state.params, mm=TTR.device_tables(tables, "cpu")["mm"],
                batch=next(iter(loader.epoch(0))))


def _corpus(seed=0, Q=4, D=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((Q, D), generator=g),
            torch.randn((3 * BLOCK, D), generator=g))


def _spans(prof):
    """[(name, start, end)] of the host spans ``rec.*``, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith(TRC.SPAN_PREFIX)),
                  key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_span_is_a_shared_null_context_without_profiler():
    a, b = TRC.span("mips.score"), TRC.span("request", {"batch": 1})
    assert a is b is TRC._NULL
    with a:
        pass


def test_spans_are_not_user_annotations():
    """An operator's own range around a call into the port keeps every
    kernel: the spans are of the ops' scope."""
    q, corpus = _corpus()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("op.call"):
            topk_mips(q, corpus, k=5, block_n=BLOCK)
    ev = [e for e in prof.events() if e.name.startswith(TRC.SPAN_PREFIX)]
    assert ev and not any(e.is_user_annotation for e in ev)
    assert [e.is_user_annotation for e in prof.events()
            if e.name == "op.call"] == [True]


def test_request_spans_carry_the_batch_index(tmp_path):
    """``retrieve_topk`` opens one ``rec.request`` a query batch, its index
    in the span's arguments where the profiler records shapes."""
    q, corpus = _corpus(3, Q=5)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        retrieve_topk(q.numpy(), corpus.numpy(), np.arange(len(corpus)),
                      k=3, query_batch=2, device="cpu")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    req = sorted((e for e in events if e.get("name") == "rec.request"),
                 key=lambda e: e["ts"])
    assert [e["args"]["batch"] for e in req] == [0, 1, 2]
    tops = [e for e in events if e.get("name") == "rec.topk_mips"]
    assert len(tops) == 3 and all(
        any(r["ts"] <= t["ts"] and t["ts"] + t["dur"] <= r["ts"] + r["dur"]
            for r in req) for t in tops)


def test_exact_scan_spans_each_block():
    q, corpus = _corpus()
    _, spans = _profiled(lambda: topk_mips(q, corpus, k=5, block_n=BLOCK))
    outer = [s for s in spans if s[0] == "rec.topk_mips"]
    assert len(outer) == 1
    for name in ("rec.mips.score", "rec.mips.select"):
        got = [s for s in spans if s[0] == name]
        assert len(got) == 3, name
        assert all(_inside(s, outer[0]) for s in got)
    res = [s for s in spans if s[0] == "rec.mips.resolve"]
    assert len(res) == 1 and _inside(res[0], outer[0])
    # a block's product before its selection
    order = [s[0] for s in spans if s[0].startswith("rec.mips.s")]
    assert order == ["rec.mips.score", "rec.mips.select"] * 3


def test_predict_spans_towers_then_blocks(world):
    bd = TTR.put_batch(world["batch"], "cpu")
    _, spans = _profiled(lambda: world["model"].predict(
        world["params"], bd, world["mm"]))
    names = [s[0] for s in spans]
    assert names == ["rec.towers", "rec.blocks"]
    assert spans[0][2] <= spans[1][1]


def _nbytes(batch):
    return sum(_nbytes(v) if isinstance(v, dict) else np.asarray(v).nbytes
               for v in batch.values())


def test_put_batch_spans_once_and_counts_its_bytes(world):
    batch = dict(world["batch"], plans={"a": np.arange(6, dtype=np.int32),
                                        "b": {"c": np.ones((2, 3))}})
    before = TRC.counters().get("put.bytes", 0)
    out, spans = _profiled(lambda: TTR.put_batch(batch, "cpu"))
    assert [s[0] for s in spans] == ["rec.put_batch"]
    assert TRC.counters()["put.bytes"] - before == _nbytes(batch)
    assert torch.equal(out["plans"]["b"]["c"], torch.ones((2, 3),
                                                          dtype=torch.double))


def test_tie_at_the_kth_place_counts_the_rows_scanned_again():
    """Queries 0 and 1 score 12 corpus rows equal at the top, spread over
    the 3 blocks, so that a block's k-th and k + 1-th scores tie; query 2
    meets no tie. Two rows are scanned again."""
    q, corpus = _corpus(1, Q=3, D=4)
    corpus[:, 0] = torch.linspace(-1.0, 1.0, corpus.shape[0])
    corpus[::4, 0] = 5.0                       # rows 0, 4, ..., 44
    q[0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    q[1] = torch.tensor([2.0, 0.0, 0.0, 0.0])
    q[2] = torch.tensor([0.0, 1.0, 0.0, 0.0])
    before = TRC.counters()
    s, i = topk_mips(q, corpus, k=10, block_n=BLOCK)
    after = TRC.counters()
    assert after["mips.rescanned_rows"] \
        - before.get("mips.rescanned_rows", 0) == 2
    assert after["mips.queries"] - before.get("mips.queries", 0) == 3
    # the tied rows' lowest indices, as lax.top_k keeps them
    assert i[0].tolist() == list(range(0, 40, 4))
    assert torch.equal(i[0], i[1])


@pytest.mark.parametrize("what", ["topk_mips", "predict"])
def test_outputs_equal_with_profiler_on_and_off(world, what):
    if what == "topk_mips":
        q, corpus = _corpus(2)

        def fn():
            return topk_mips(q, corpus, k=5, block_n=BLOCK)
    else:
        bd = TTR.put_batch(world["batch"], "cpu")

        def fn():
            return (world["model"].predict(world["params"], bd, world["mm"]),)
    off = fn()
    on, spans = _profiled(fn)
    assert spans
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("blocks", [1, 3])
def test_scan_without_tie_counts_zero_rescanned_rows(blocks):
    """Every call counts its rescanned rows, 0 included (a corpus of one
    block takes no probes), so that a reader tells a run without ties from
    a program that lost the count."""
    q, corpus = _corpus(4)
    TRC.count("mips.rescanned_rows", 0)
    before = TRC.counters()
    topk_mips(q, corpus[:blocks * BLOCK], k=5, block_n=BLOCK)
    after = TRC.counters()
    assert after["mips.rescanned_rows"] == before["mips.rescanned_rows"]
    assert after["mips.queries"] - before.get("mips.queries", 0) == len(q)


def test_host_preps_count_unique_and_touched_rows(world):
    cfg = world["cfg"]
    cfg_d = cfg.replace(train=TrainConfig(batch_size=8, tower_dedup=True))
    cfg_s = cfg.replace(train=TrainConfig(batch_size=8,
                                          sparse_tables=("item_emb",)))
    itemnum = world["model"].itemnum
    b = world["batch"]
    before = TRC.counters()
    TTR.augment_batch_dedup(b, cfg_d, world["tables"], itemnum)
    out = TTR.augment_batch_sparse(b, cfg_s, itemnum, (0, 1))
    got = {k: v - before.get(k, 0) for k, v in TRC.counters().items()}
    seq = np.where(np.asarray(b["token_type"]) == 1, b["seq"], 0)
    pos, neg = np.asarray(b["pos"]), np.asarray(b["neg"])
    assert got["dedup.batches"] == 1
    assert got["dedup.unique_rows"] == len(np.unique(np.concatenate(
        [seq.reshape(-1), pos[:, -1], neg.reshape(-1)])))
    # the touched rows are the device's count (``Performance/touched_rows``)
    # of the rows the sparse prep ships, not a host counter
    assert not any(k.startswith("sparse.") for k in got)
    assert np.count_nonzero(out["touched_uids"] <= itemnum) == len(np.unique(
        np.concatenate([seq.reshape(-1), pos.reshape(-1), neg.reshape(-1)])))


def test_profile_steps_trace_holds_the_step_spans(world, tmp_path):
    """``train_loop(profile_steps=...)`` writes ``trace.json`` whose
    ``rec.train.step`` holds the step's forward, backward and dense
    update, and whose ``rec.counters`` holds the counters' change over the
    traced steps (the puts' bytes: how many of the prefetched puts fall
    inside the window varies)."""
    prof = tmp_path / "profile"
    TTR.train_loop(world["model"], world["cfg"], world["loader"], None,
                   world["tables"], profile_steps=2, profile_dir=str(prof),
                   profile_start=1, verbose=False, device="cpu")
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["rec.counters"]["put.bytes"] >= 0
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]

    def ranges(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e["name"] == name]

    steps = ranges("rec.train.step")
    assert steps
    for name in ("rec.step.forward", "rec.step.backward",
                 "rec.step.dense_update"):
        got = ranges(name)
        assert got, name
        assert all(any(s <= lo and hi <= e for s, e in steps)
                   for lo, hi in got), name


def test_profile_trace_writes_the_counters_change(tmp_path):
    """The trace's ``rec.counters`` holds what was counted while the
    profiler ran, not the totals before it."""
    from tencent_recommendation_2025_tpu_torch.utils.debug import \
        profile_trace

    TRC.count("test.trace", 2)
    with profile_trace(str(tmp_path)):
        TRC.count("test.trace", 5)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["rec.counters"]["test.trace"] == 5


def test_count_from_many_threads_loses_no_update():
    """The host preps count from the loader's worker threads."""
    import sys
    import threading

    n, per = 16, 2000
    before = TRC.counters().get("test.threads", 0)
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            TRC.count("test.threads", 1) for _ in range(per)])
            for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(was)
    assert TRC.counters()["test.threads"] - before == n * per
