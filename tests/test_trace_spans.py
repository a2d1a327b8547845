"""``scripts/trace_spans.py``: a trace's device time and idle gaps by host
span, on a synthetic Chrome trace whose figures are counted by hand, and
on a CPU trace of the exact scan written by ``utils.debug.profile_trace``."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from tencent_recommendation_2025_tpu_torch.retrieval.mips import topk_mips
from tencent_recommendation_2025_tpu_torch.utils.debug import profile_trace

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "trace_spans.py"
_spec = importlib.util.spec_from_file_location("trace_spans", _PATH)
TS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TS)


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


#: the main thread (1) in pb.mips > rec.topk_mips > score, then select;
#: a prep thread (2) that launches a copy; a thread with no span (3, as
#: autograd's backward thread) launching inside select's time; one launch
#: outside every span; one device operation whose launch the trace lacks
SYNTHETIC = {"rec.counters": {"mips.queries": 8}, "traceEvents": [
    _x("pb.mips", "user_annotation", 0, 1000),
    _x("rec.topk_mips", "cpu_op", 10, 980),
    _x("rec.mips.score", "cpu_op", 20, 280),
    _x("rec.mips.select", "cpu_op", 300, 300),
    _x("rec.train.prep", "cpu_op", 0, 1000, tid=2),
    _x("cudaLaunchKernel", "cuda_runtime", 50, 5, corr=1),
    _x("cudaLaunchKernel", "cuda_runtime", 350, 5, corr=2),
    _x("cuLaunchKernel", "cuda_driver", 700, 5, corr=3),
    _x("cudaMemcpyAsync", "cuda_runtime", 100, 5, tid=2, corr=4),
    _x("cudaLaunchKernel", "cuda_runtime", 1100, 5, corr=5),
    _x("cudaLaunchKernel", "cuda_runtime", 350, 5, tid=3, corr=6),
    _x("gemm", "kernel", 100, 100, tid=7, corr=1),
    _x("topk", "kernel", 250, 150, tid=7, corr=2),
    _x("triton_k", "kernel", 500, 20, tid=7, corr=3),
    _x("Memcpy HtoD", "gpu_memcpy", 600, 50, tid=8, corr=4),
    _x("fill", "kernel", 1500, 10, tid=7, corr=5),
    _x("orphan", "kernel", 1500, 5, tid=7, corr=99),
    _x("wgrad", "kernel", 1600, 50, tid=7, corr=6),
    _x("pb.mips", "gpu_user_annotation", 90, 610, tid=7),
    {"ph": "s", "name": "ac2g", "id": 1, "ts": 50},
]}


def test_synthetic_trace_by_span():
    got = TS.summarize(SYNTHETIC, units=2)
    ms = 1e-3 / 2                              # a us of the trace, per unit
    assert got["busy_ms"] == pytest.approx(380 * ms)
    assert got["idle_ms"] == pytest.approx((50 + 100 + 80 + 850 + 90) * ms)
    assert got["idle_outside_ms"] == pytest.approx((850 + 90) * ms)
    assert got["unlinked_ops"] == 1
    assert got["counters"] == {"mips.queries": 8}
    sp = got["spans"]
    assert sp["rec.mips.score"]["device_ms"] == pytest.approx(100 * ms)
    # select's own kernel and the span-less thread's, by its launch time
    assert sp["rec.mips.select"]["device_ms"] == pytest.approx(200 * ms)
    assert sp["rec.topk_mips"]["device_ms"] == pytest.approx(320 * ms)
    assert sp["pb.mips"]["device_ms"] == pytest.approx(320 * ms)
    assert sp["rec.train.prep"]["device_ms"] == pytest.approx(50 * ms)
    # the benchmark's reading: the busy time inside the device-lane copy
    assert sp["pb.mips"]["lane_ms"] == pytest.approx(320 * ms)
    assert "lane_ms" not in sp["rec.topk_mips"]
    # gaps by the main thread's innermost span; a prep span takes none
    assert sp["rec.mips.score"]["idle_ms"] == pytest.approx(50 * ms)
    assert sp["rec.mips.select"]["idle_ms"] == pytest.approx(180 * ms)
    assert sp["rec.topk_mips"]["idle_ms"] == 0
    assert sp["rec.topk_mips"]["idle_within_ms"] == pytest.approx(230 * ms)
    assert sp["pb.mips"]["idle_within_ms"] == pytest.approx(230 * ms)
    assert sp["rec.train.prep"]["idle_within_ms"] == 0
    assert sp["rec.mips.score"]["calls"] == 0.5


def test_backward_thread_goes_by_time_to_the_main_thread():
    """Autograd's thread opens no span and launches more than the main
    thread: its kernels go to the step's backward, whose time they fall in,
    and the gaps go by the main thread's spans."""
    trace = {"traceEvents": [
        _x("rec.step.forward", "cpu_op", 0, 100),
        _x("rec.step.backward", "cpu_op", 100, 400),
        _x("cudaLaunchKernel", "cuda_runtime", 50, 5, corr=1),
        *[_x("cudaLaunchKernel", "cuda_runtime", t, 5, tid=9, corr=c)
          for c, t in ((2, 150), (3, 250), (4, 350))],
        _x("fwd", "kernel", 60, 30, tid=7, corr=1),
        _x("bwd_a", "kernel", 160, 20, tid=7, corr=2),
        _x("bwd_b", "kernel", 260, 20, tid=7, corr=3),
        _x("bwd_c", "kernel", 360, 20, tid=7, corr=4)]}
    sp = TS.summarize(trace)["spans"]
    assert sp["rec.step.backward"]["device_ms"] == pytest.approx(0.06)
    assert sp["rec.step.forward"]["device_ms"] == pytest.approx(0.03)
    assert sp["rec.step.forward"]["idle_ms"] == pytest.approx(0.0)
    assert sp["rec.step.backward"]["idle_ms"] == pytest.approx(0.23)


def test_cpu_trace_of_the_exact_scan(tmp_path, capsys):
    g = torch.Generator().manual_seed(5)
    q, corpus = torch.randn((4, 8), generator=g), \
        torch.randn((48, 8), generator=g)
    with profile_trace(str(tmp_path)):
        topk_mips(q, corpus, k=5, block_n=16)
    assert TS.main([str(tmp_path / "trace.json")]) == 0
    got = json.loads(capsys.readouterr().out)
    sp = got["spans"]
    assert sp["rec.topk_mips"]["calls"] == 1
    assert sp["rec.mips.score"]["calls"] == 3
    assert sp["rec.mips.select"]["calls"] == 3
    assert got["busy_ms"] == 0 and sp["rec.topk_mips"]["device_ms"] == 0
    assert got["counters"]["mips.queries"] == 4
    assert got["counters"]["mips.rescanned_rows"] == 0
