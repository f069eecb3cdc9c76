"""The window's rate over all its work and time, the spread of runs, and
the traced run's idle share, breakdown and roofline on synthetic traces."""

import statistics
import time

import pytest

from perfbench import run, stats
from perfbench.rooflines import share
from perfbench.trace import CALL, WINDOW, TraceView


class Sleepy:
    """A stand-in cell whose calls take known times."""
    work_per_call = 10

    def __init__(self, waits):
        self.pool = [0, 1]
        self.waits = list(waits)

    def call(self, k):
        time.sleep(self.waits.pop(0) if self.waits else 0.01)
        return {"price": k}


def test_rate_counts_every_call_and_the_whole_window():
    sut = Sleepy([0.05, 0.01, 0.01])
    win = run.measure(sut, 0.068)
    assert win.calls >= 3 and win.failed == 0
    elapsed = win.end - win.start
    assert elapsed >= 0.068
    r = run.Run(setup_s=1.0, window_s=elapsed, work_done=win.calls * 10, work_per_call=10,
                shapes={}, kernel=None, trace=None)
    from perfbench.manifest import Manifest
    from conftest import ROOT
    rate = Manifest(ROOT).reader("options_per_s").read(r)
    assert rate == pytest.approx(win.calls * 10 / elapsed)
    # the slow first call is in it: the rate is not the best call's
    assert rate < 10 / 0.01


def test_p95_is_over_every_call_of_the_window():
    """One slow call of 100 ms, then calls of 10 ms: every call has its
    latency, from its start to its end, and the slow one is in the tail."""
    sut = Sleepy([0.1])
    win = run.measure(sut, 0.25)
    assert win.calls >= 5 and len(win.latencies_ms) == win.calls
    assert win.latencies_ms[0] >= 100 and all(t >= 10 for t in win.latencies_ms)
    assert sum(win.latencies_ms) <= 1e3 * (win.end - win.start)
    from perfbench.manifest import Manifest
    from conftest import ROOT
    r = run.Run(1.0, win.end - win.start, win.calls, 1, {}, None, None,
                latencies_ms=win.latencies_ms)
    p95 = Manifest(ROOT).reader("book_p95_ms").read(r)
    assert p95 == pytest.approx(statistics.quantiles(win.latencies_ms, n=20,
                                                     method="inclusive")[18])
    assert min(win.latencies_ms) < p95 < max(win.latencies_ms)
    r.latencies_ms = [5.0]
    assert Manifest(ROOT).reader("book_p95_ms").read(r) is None


def test_a_call_that_raises_counts_as_failed():
    class Broken(Sleepy):
        def call(self, k):
            raise RuntimeError("boom")
    win = run.measure(Broken([]), 0.01)
    assert win.failed == win.calls >= 1 and win.kept == {}


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / statistics.median(values))


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (8, 12)]
    assert stats.union_length(iv, 0, 10) == 3 + 1 + 2
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    assert stats.gaps([], 0, 4) == [(0, 4)]


def events(kernels, calls=((0, 50), (50, 100)), host=()):
    ev = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0, "dur": 100}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": CALL, "ts": a, "dur": b - a}
           for a, b in calls]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a} for n, a, b in kernels]
    ev += [{"ph": "X", "cat": "cpu_op", "name": n, "ts": a, "dur": b - a} for n, a, b in host]
    return ev


def test_idle_share_on_synthetic_kernels():
    tv = TraceView(events([("k1", 10, 30), ("k2", 20, 40), ("k1", 60, 90)]))
    assert tv.busy_us() == 60 and tv.window_us == 100
    from perfbench.manifest import Manifest
    from conftest import ROOT
    r = run.Run(1.0, 1.0, 1, 1, {}, None, tv)
    assert Manifest(ROOT).reader("device_idle_pct.book").read(r) == pytest.approx(40.0)
    assert Manifest(ROOT).reader("launches_per_call").read(r) == pytest.approx(1.5)
    assert Manifest(ROOT).reader("pricer_busy_ms").read(r) == pytest.approx(30e-3)
    assert [n for n, _ in tv.top_device_ops()] == ["k1", "k2"]
    assert [s for _, s in tv.top_device_ops()] == pytest.approx([50e-6, 20e-6])


def test_busy_inside_a_span_equals_the_plain_union():
    """The sorted, bisected reading against the union over every
    operation, on spans that nest, overlap and straddle the bounds."""
    import random
    rng = random.Random(7)
    kernels = []
    for _ in range(300):
        a = rng.uniform(0, 100)
        kernels.append((rng.choice(["k1", "copy", "set"]), a, a + rng.expovariate(1 / 3)))
    kernels.append(("k1", 5, 95))
    tv = TraceView(events(kernels))
    for _ in range(200):
        lo = rng.uniform(-5, 100)
        hi = lo + rng.uniform(0, 30)
        for without in (None, "k1"):
            plain = stats.union_length([(a, b) for n, a, b in kernels
                                        if without is None or without not in n],
                                       max(lo, 0), min(hi, 100))
            assert tv.busy_us(max(lo, 0), min(hi, 100), without=without) == pytest.approx(plain)


def test_idle_gaps_named_by_the_host_operation_then_open():
    tv = TraceView(events([("k", 10, 30), ("k", 60, 100)],
                          host=[("aten::copy_", 30, 48), ("aten::mul", 52, 58)]))
    # idle 0-10 (mid-point inside the first call only) and 30-60 (mid-point
    # inside the copy)
    assert dict(tv.idle_gaps()) == {"perfbench.call": pytest.approx(10e-6),
                                    "aten::copy_": pytest.approx(30e-6)}


def test_solver_nonkernel_and_roofline_on_a_synthetic_trace():
    name = "void (anonymous namespace)::douglas_march_smem<false, false>(float const*)"
    tv = TraceView(events([(name, 10, 30), ("elementwise", 30, 35), (name, 60, 80)]))
    from perfbench.manifest import Manifest
    from conftest import ROOT
    shapes = {"B": 4096, "nS": 100, "nv": 50, "nT": 100}
    r = run.Run(1.0, 1.0, 1, 1, shapes, "k1", tv)
    # the first call's device time outside K1 is 5 us, the second's none
    assert Manifest(ROOT).reader("solver_nonkernel_ms").read(r) == pytest.approx(2.5e-3)
    out = share(r, "k1")
    assert out["binds"] == "flops" and out["launches"] == 2
    assert out["value"] == pytest.approx(100.0 * out["bound_s"] / 20e-6)
    r.trace = TraceView(events([("elementwise", 10, 30)]))
    assert share(r, "k1") is None
    assert Manifest(ROOT).reader("solver_nonkernel_ms").read(r) is None


def test_trace_without_a_window_is_refused():
    with pytest.raises(ValueError):
        TraceView([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 1}])


def test_sets_summary_gives_each_sets_median_and_spread():
    from perfbench.sets import summary
    mk = lambda vals: [{"metrics": {"options_per_s": {"value": v}}} for v in vals]  # noqa: E731
    a, b = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8], [10.0, 10.0, 10.1, 10.1, 10.0, 10.1]
    s = summary({"A": mk(a), "B": mk(b)})["options_per_s"]
    assert s["A"]["median"] == statistics.median(a)
    assert s["A"]["spread"] == pytest.approx(stats.spread(a))
    assert s["B"]["spread"] < s["A"]["spread"]
