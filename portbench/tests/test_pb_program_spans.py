"""The traced stretch's reduction beside the program's own spans and
counters (``rec.*``, the port's ``utils/tracing.py``): ``finish_stretch``
over synthetic events reads every field the same with and without the
program's spans, which are host ranges of the ops' scope; and the metric
that reads the program's counters, on a traced CPU run of the serving cell
and where the program has no counters."""

import dataclasses
import sys
import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import tiny
from portbench.bench import cells, manifest
from portbench.bench import record as R

PROGRAM = "tencent_recommendation_2025_tpu_torch.utils.tracing"


def _ev(name, lo, hi, dev=False, annot=False, thread=1):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=lo, end=hi),
        device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        is_user_annotation=annot, thread=thread)


class _Prof:
    def __init__(self, events):
        self._events = events

    def __exit__(self, *a):
        pass

    def events(self):
        return self._events


#: two requests: the benchmark's spans on the host and their device-lane
#: copies, the card's kernels with gaps between them
BENCH = [
    _ev("pb.predict", 0, 400), _ev("pb.mips", 400, 1000),
    _ev("pb.predict", 1000, 1400), _ev("pb.mips", 1400, 2000),
    _ev("pb.predict", 100, 380, dev=True, annot=True),
    _ev("pb.mips", 420, 990, dev=True, annot=True),
    _ev("pb.predict", 1100, 1380, dev=True, annot=True),
    _ev("pb.mips", 1420, 1990, dev=True, annot=True),
    _ev("attn_ffn_wgmma_kernel", 100, 380, dev=True),
    _ev("sm80_xmma_gemm", 420, 600, dev=True),
    _ev("gatherTopK", 640, 990, dev=True),
    _ev("attn_ffn_wgmma_kernel", 1100, 1380, dev=True),
    _ev("sm80_xmma_gemm", 1420, 1600, dev=True),
    _ev("gatherTopK", 1650, 1990, dev=True),
]

#: the program's spans inside them (host only: no device-lane copy), one
#: on another thread
PROGRAM_SPANS = [
    _ev("rec.towers", 10, 90), _ev("rec.blocks", 95, 390),
    _ev("rec.topk_mips", 405, 995), _ev("rec.mips.score", 410, 610),
    _ev("rec.mips.select", 611, 990), _ev("rec.towers", 1010, 1090),
    _ev("rec.blocks", 1095, 1390), _ev("rec.topk_mips", 1405, 1995),
    _ev("rec.mips.score", 1410, 1610), _ev("rec.mips.select", 1611, 1990),
    _ev("rec.train.prep", 0, 2000, thread=2),
]


def _trace(events):
    return R.finish_stretch(_Prof(events), time.perf_counter(), 2)


def test_program_spans_leave_every_field_as_it_was():
    without, with_ = _trace(BENCH), _trace(BENCH + PROGRAM_SPANS)
    for f in dataclasses.fields(R.Trace):
        if f.name != "traced_s":
            assert getattr(with_, f.name) == getattr(without, f.name), f.name
    assert without.spans_ms == pytest.approx(
        {"pb.predict": 0.56, "pb.mips": 1.05})
    assert not any(k.startswith("rec.") for k in with_.kernels_ms)
    assert set(with_.idle_by_span_s) == {"pb.mips", "pb.predict"}


def _run():
    return R.Run(kind="serve", chips=1, config={}, traffic={},
                 trace=_trace(BENCH))


def test_rescan_share_reads_the_program_counters(monkeypatch):
    """A number where the program counted its queries and rescans (0
    included); None where the rescan count is missing, so that a lost
    count never reads as the best value."""
    from tencent_recommendation_2025_tpu_torch.utils import tracing

    read = manifest.reader("metrics", "mips.rescan_share")
    monkeypatch.setattr(tracing, "_counts",
                        {"mips.queries": 4096, "mips.rescanned_rows": 3})
    assert read(_run()) == pytest.approx(100.0 * 3 / 4096)
    monkeypatch.setattr(tracing, "_counts",
                        {"mips.queries": 8, "mips.rescanned_rows": 0})
    assert read(_run()) == 0.0
    monkeypatch.setattr(tracing, "_counts", {"mips.queries": 8})
    assert read(_run()) is None
    monkeypatch.setattr(tracing, "_counts", {})
    assert read(_run()) is None


def test_rescan_share_is_silent_without_the_program_counters(monkeypatch):
    """A program without ``utils/tracing.py`` (an older checkout): the
    metric leaves the line, and raises nothing."""
    import tencent_recommendation_2025_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, PROGRAM, None)
    monkeypatch.delattr(utils, "tracing")
    assert manifest.reader("metrics", "mips.rescan_share")(_run()) is None


def test_traced_serving_run_reports_the_rescan_share():
    """One thread, as ``run.py`` runs: the window reaches its traced
    stretch on a busy host too."""
    import torch

    c = tiny.cell("flagship.serve")
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cells.run(c, 2 ** 31 + 23, 2, True, time.time(), device="cpu")
    finally:
        torch.set_num_threads(was)
    assert out["correct"]
    share = out["metrics"]["mips.rescan_share"]
    assert share["unit"] == "%" and 0.0 <= share["value"] <= 100.0
