"""The harness's arithmetic: tails and rates over every call of a window,
the spread, and the device's idle share as a union of intervals."""

from __future__ import annotations

import statistics

import pytest

from benchmarks import harness as H


def test_nearest_rank_takes_every_value():
    values = [float(v) for v in range(1, 101)]
    assert H.nearest_rank(values, 0.95) == 95.0
    assert H.nearest_rank(values[::-1], 0.95) == 95.0
    assert H.nearest_rank([3.0], 0.95) == 3.0
    # 20 calls: the 19th smallest, one call beyond it
    assert H.nearest_rank(list(range(20)), 0.95) == 18


def test_quartiles_and_phase_means():
    values = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    assert H.quartiles(values) == statistics.quantiles(values, n=4)
    calls = [{"phases": {"compile": 0.3, "other": 0.1}}, {"phases": {"other": 0.3}}]
    assert H.phase_means(calls) == pytest.approx({"compile": 150.0, "other": 200.0})


def test_window_rates_leave_out_the_harness_work(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(H.time, "perf_counter", lambda: clock[0])
    win = H.Window(10.0)
    with win:
        while win.open():
            with win.call("solve", 100):
                clock[0] += 1.0
            with win.hold():
                clock[0] += 0.5
    assert len(win.calls) == 10 and win.window_s == pytest.approx(10.0)
    assert sum(c["work"] for c in win.calls) / win.window_s == pytest.approx(100.0)
    assert H.nearest_rank([c["s"] for c in win.calls], 0.95) == pytest.approx(1.0)


def test_union_counts_overlaps_once():
    assert H.union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert H.union_s([]) == 0.0


def test_gaps_between_intervals():
    assert H.gaps([(1, 2), (1.5, 3), (6, 7)], 0, 10) == [(0, 1), (3, 6), (7, 10)]
    assert H.gaps([(0, 10)], 0, 10) == []


class _Trace(H.DeviceTrace):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops


def _run(ops, calls, lo=0.0, hi=10.0, held=()):
    win = H.Window(hi - lo)
    win.t0, win.t1, win.calls, win.held = lo, hi, calls, list(held)
    win.trace = _Trace(ops)
    return H.Run(win)


def test_idle_share_on_a_synthetic_trace():
    # a kernel and a copy that overlap, and a kernel alone: 3 s busy of 10
    ops = [("k1", 1.0, 2.0), ("Memcpy HtoD", 1.5, 3.0), ("k2", 7.0, 8.0)]
    run = _run(ops, [])
    assert run.busy_s() == pytest.approx(3.0)
    assert run.idle_pct() == pytest.approx(70.0)
    # 2 s of the window were the harness's: 3 s busy of 8
    run = _run(ops, [], held=[(4.0, 6.0)])
    assert run.idle_pct() == pytest.approx(62.5)


def test_roofline_share_over_the_calls_with_a_bound():
    calls = [{"kind": "solve", "t0": 0.0, "t1": 5.0, "phases": {}},
             {"kind": "solve", "t0": 5.0, "t1": 10.0, "phases": {}}]
    ops = [("ffd_scan_grid_kernel", 1.0, 1.004), ("choose_config", 1.004, 1.005),
           ("ffd_scan_grid_kernel", 6.0, 6.002)]
    run = _run(ops, calls)
    run.bounds = {"ffd_scan": {0: 1.0, 1: 1.0}}  # ms
    assert run.roofline_pct("ffd_scan", lambda n: "ffd_scan" in n) == pytest.approx(100 * 2 / 6)
    run.bounds = {}
    assert run.roofline_pct("ffd_scan", lambda n: "ffd_scan" in n) is None


def test_breakdown_names_gaps_by_the_host_span():
    calls = [{"kind": "solve", "t0": 0.0, "t1": 10.0, "phases": {}}]
    trace = _Trace([("k", 1.0, 2.0), ("k", 8.0, 9.0)])
    trace.host = [("solver.partition", 2.0, 8.0), ("solver", 0.0, 10.0)]
    out = trace.breakdown(calls, [], 0.0, 10.0)
    assert out["device_ops"] == [["k", pytest.approx(2.0)]]
    assert out["idle_gaps"][0] == ["solver.partition", pytest.approx(6.0)]
