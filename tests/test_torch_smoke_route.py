"""chip_smoke's route checks take the profiled call again while its trace
lacks a kernel the route wants and holds none it forbids (the card's
profiler loses kernel events late in a long process), and judge the last
trace: a trace that shows a forbidden kernel ends the retakes, and a route
whose kernels never show fails after ROUTE_TRACES traces. The profiler runs
on the CPU here; the device times of each trace are given in order."""

import collections

import pytest
import torch

import chip_smoke as CS

WANT = {k: 1.0 for k in CS.ATTN_BWD_WGMMA}
FORBID = {"attn_dq_kernel": 1.0}


def _traces(monkeypatch, traces):
    seq = iter(traces)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(CS, "_device_ms",
                        lambda prof: collections.Counter(next(seq)))


@pytest.mark.parametrize("traces, calls, ok", [
    ([WANT], 1, True),
    ([{}, WANT], 2, True),
    ([{}, {CS.ATTN_BWD_WGMMA[0]: 1.0}, WANT], 3, True),
    ([dict(WANT, **FORBID)], 1, False),
    ([{}, FORBID, WANT], 2, False),
    ([{}] * CS.ROUTE_TRACES, CS.ROUTE_TRACES, False),
])
def test_route_trace_retakes_only_a_trace_that_lost_events(
        monkeypatch, traces, calls, ok):
    _traces(monkeypatch, traces + [WANT])
    made = []
    CS.route_trace("t", lambda: made.append(1), ("attn_bwd",))
    assert len(made) == calls
    # the check judges the trace route_trace stopped at
    assert CS.attn_bwd_route("t", collections.Counter(traces[calls - 1])) \
        == ok


@pytest.mark.parametrize("counts_ok, calls", [(True, 1), (False, 4)])
def test_route_trace_retakes_a_trace_with_too_few_launches(
        monkeypatch, counts_ok, calls):
    _traces(monkeypatch, [WANT] * CS.ROUTE_TRACES)
    made = []
    CS.route_trace("t", lambda: made.append(1), ("attn_bwd",),
                   launches_ok=lambda counts: counts_ok)
    assert len(made) == calls


def test_route_names_match_the_route_checks():
    want, forbid = CS.route_names("fused", train=False)
    assert want == CS.PRE_WGMMA[:1] + CS.POST_WGMMA[:1]
    assert CS.wgmma_route("t", collections.Counter(dict.fromkeys(want, 1.0)),
                          train=False)
    assert not CS.wgmma_route("t", collections.Counter(
        dict.fromkeys(want + forbid[:1], 1.0)), train=False)
    want, forbid = CS.route_names("hstu")
    assert want == CS.HSTU_WGMMA and forbid == CS.HSTU_FIRST
    assert CS.hstu_route("t", collections.Counter(dict.fromkeys(want, 1.0)))
