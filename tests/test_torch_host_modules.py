"""The port's copies of the reference's host-side modules give the
reference's numbers: TCA, routing, reconciliation and the execution
algorithms, the Greeks and correlation monitors, model validation,
walk-forward and benchmarks, attribution and diagnostics, data recovery
and data-quality monitoring.

Each scenario mirrors cases of the reference's own tests
(``tests/test_{execution,risk,validation,monitoring,data}.py``) and runs
once with ``pde_tpu``'s modules and once with ``pde_tpu_torch``'s, on the
same inputs (numpy draws from a fixed seed).  The two results must be
equal (floats within 1e-12 relative), and the port's must pass the
reference test's own checks.  ``test_torch_copies.py`` holds the copies'
source to the reference's; this file holds what they return.
"""

import importlib
from datetime import date, datetime, timedelta, timezone

import numpy as np
import pytest

PKGS = ("pde_tpu", "pde_tpu_torch")
NOW = datetime(2026, 3, 20, 15, 0, tzinfo=timezone.utc)


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _same(a, b, path="result"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating, np.ndarray)) and not isinstance(a, bool):
        np.testing.assert_allclose(np.asarray(b, dtype=float), np.asarray(a, dtype=float),
                                   rtol=1e-12, atol=0, err_msg=path)
    else:
        assert a == b, (path, a, b)


def both(scenario, **kw):
    """The scenario's result with the port's modules, after checking it
    equals the reference's."""
    ref, port = (scenario(pkg, **kw) for pkg in PKGS)
    _same(ref, port)
    return port


# ------------------------------------------------------------------ execution

def _order(pkg, qty=100, side="BUY", **kw):
    o = mod(pkg, "execution.order")
    return o.Order(symbol="SPY", side=getattr(o.OrderSide, side), quantity=qty, **kw)


def tca_scenario(pkg):
    o, tca = mod(pkg, "execution.order"), mod(pkg, "execution.tca")
    analyzer = tca.TCAAnalyzer()
    res = analyzer.analyze_order(
        [o.Fill("o1", "SPY", o.OrderSide.BUY, 50, 450.5, commission=1.0),
         o.Fill("o1", "SPY", o.OrderSide.BUY, 50, 450.7, commission=1.0)],
        arrival_price=450.0, market_prices=np.array([450.0, 450.4, 450.8]),
        market_volumes=np.array([100.0, 100.0, 200.0]), close_price=451.0)
    sell = analyzer.analyze_order([o.Fill("o2", "SPY", o.OrderSide.SELL, 100, 449.0)],
                                  arrival_price=450.0)
    rs = [analyzer.analyze_order([o.Fill(f"o{i}", "SPY", o.OrderSide.BUY, 100, 450.0 + i * 0.1)],
                                 arrival_price=450.0) for i in range(3)]
    report = analyzer.aggregate_report(rs)
    return dict(avg=res.avg_fill_price, slippage=dict(res.slippage_bps),
                shortfall=res.implementation_shortfall_bps,
                sell_arrival=sell.slippage_bps["arrival"],
                report={k: v for k, v in report.items() if isinstance(v, (int, float, str))})


def test_tca():
    out = both(tca_scenario)
    assert out["avg"] == pytest.approx(450.6)
    assert out["slippage"]["arrival"] == pytest.approx((450.6 - 450.0) / 450.0 * 1e4)
    assert out["slippage"]["close"] < 0
    assert out["shortfall"] > out["slippage"]["arrival"]
    assert out["sell_arrival"] > 0
    assert out["report"]["n_orders"] == 3 and out["report"]["worst_order"] == "o2"


def routing_scenario(pkg):
    rt = mod(pkg, "execution.routing")
    router = rt.SmartOrderRouter()
    best = router.route(_order(pkg, 1000))
    split = router.route(_order(pkg, 900), rt.RoutingStrategy.SPLIT)
    spray = router.route(_order(pkg, 1000), rt.RoutingStrategy.SPRAY)
    before = router.venues["IEX"].fill_probability
    for _ in range(20):
        router.record_fill_quality("IEX", filled=False, latency_ms=5.0)
    return dict(best=[list(a) for a in best.allocations],
                split=[list(a) for a in split.allocations],
                spray=[list(a) for a in spray.allocations], n_venues=len(router.venues),
                before=before, after=router.venues["IEX"].fill_probability)


def test_routing():
    out = both(routing_scenario)
    assert len(out["best"]) == 1 and out["best"][0][1] == 1000
    assert len(out["split"]) == 3 and sum(q for _, q in out["split"]) == pytest.approx(900)
    assert len(out["spray"]) == out["n_venues"]
    assert out["after"] < out["before"]


def reconciliation_scenario(pkg):
    o, rec = mod(pkg, "execution.order"), mod(pkg, "execution.reconciliation")
    f = o.Fill("o1", "SPY", o.OrderSide.BUY, 100, 450.0)
    ok = rec.FillReconciler().reconcile_fills(
        [f], [{"order_id": "o1", "symbol": "SPY", "quantity": 100, "price": 450.01}])
    price = rec.FillReconciler(price_tolerance_pct=0.0001).reconcile_fills(
        [f], [{"order_id": "o1", "symbol": "SPY", "quantity": 100, "price": 451.0}])
    missing = rec.FillReconciler().reconcile_fills(
        [f], [{"order_id": "oX", "symbol": "SPY", "quantity": 5, "price": 450.0}])
    pos = rec.FillReconciler().reconcile_positions({"SPY": 100, "QQQ": -50},
                                                   {"SPY": 100, "QQQ": 50})
    kinds = lambda r: sorted((d.kind, d.severity.value) for d in r.discrepancies)  # noqa: E731
    return dict(ok=(ok.n_matched, ok.clean), price=(price.clean, kinds(price)),
                missing=kinds(missing), pos=(pos.n_matched, kinds(pos)))


def test_reconciliation():
    out = both(reconciliation_scenario)
    assert out["ok"] == (1, True)
    assert out["price"][0] is False and out["price"][1][0][0] == "price_mismatch"
    assert {k for k, _ in out["missing"]} == {"missing_external", "unknown_external"}
    assert all(s == "critical" for _, s in out["missing"])
    assert out["pos"][0] == 1 and out["pos"][1][0][1] == "critical"


def algorithms_scenario(pkg, native=True):
    alg = mod(pkg, "execution.algorithms")
    twap = alg.TWAPExecutor().create_plan(_order(pkg, 1000), duration_minutes=60, n_slices=10)
    vwap = alg.VWAPExecutor().create_plan(_order(pkg, 10_000))
    ice = alg.IcebergExecutor().create_plan(_order(pkg, 950), display_size=300)
    pov = alg.POVExecutor().create_plan(_order(pkg, 5000), participation_rate=0.1,
                                        expected_volume_per_bucket=10_000)
    start = datetime(2026, 1, 2, 14, 30, tzinfo=timezone.utc)
    plan = alg.TWAPExecutor().create_plan(
        mod(pkg, "execution.order").Order(symbol="SPY", side=mod(pkg, "execution.order")
                                          .OrderSide.BUY, quantity=10_000.0),
        start_time=start, end_time=start + timedelta(hours=1), n_slices=10)
    times = start.timestamp() + np.arange(0.0, 3700.0, 10.0)
    prices = 500.0 * np.exp(np.cumsum(np.random.default_rng(3).normal(0, 1e-4, len(times))))
    nat = mod(pkg, "native")
    was = nat.is_available
    if not native:
        nat.is_available = lambda: False
    try:
        summary = alg.simulate_plan(plan, times, prices)
    finally:
        nat.is_available = was
    return dict(twap_gaps=np.diff([s.scheduled_time.timestamp() for s in twap.slices]),
                twap_total=twap.total_quantity, vwap=[s.quantity for s in vwap.slices],
                iceberg=[s.quantity for s in ice.slices], pov=[s.quantity for s in pov.slices],
                summary=summary, completion=plan.completion_rate)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python_loop"])
def test_execution_algorithms(native):
    from pde_tpu_torch import native as tnative

    if native and not tnative.is_available():
        pytest.skip("native toolchain unavailable")
    out = both(algorithms_scenario, native=native)
    assert np.allclose(out["twap_gaps"], 360.0) and out["twap_total"] == pytest.approx(1000)
    q = np.array(out["vwap"])
    assert q.sum() == pytest.approx(10_000) and q[0] > q[5] and q[-1] > q[5]
    assert out["iceberg"] == [300, 300, 300, 50]
    assert max(out["pov"]) <= 1000 + 1e-9 and sum(out["pov"]) == pytest.approx(5000)
    s = out["summary"]
    assert s["n_filled"] == s["n_slices"] == 10.0 and s["filled_quantity"] == 10_000.0
    assert out["completion"] == 1.0 and abs(s["implementation_shortfall_bps"]) < 100
    assert s["total_commission"] >= 10.0


def test_simulate_plan_native_equals_its_python_loop():
    from pde_tpu_torch import native as tnative

    if not tnative.is_available():
        pytest.skip("native toolchain unavailable")
    a = algorithms_scenario("pde_tpu_torch", native=True)["summary"]
    b = algorithms_scenario("pde_tpu_torch", native=False)["summary"]
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-12), k


# ----------------------------------------------------------------------- risk

def greeks_scenario(pkg):
    gm = mod(pkg, "risk.greeks_monitor")
    mon = gm.GreeksRiskMonitor()
    pos = [gm.OptionPosition(symbol="SPY_C450", underlying="SPY", option_type="call",
                             strike=450.0, expiration=NOW, quantity=10, direction="long",
                             delta=0.5, gamma=0.02, vega=0.3, theta=-0.05,
                             underlying_price=450.0)]
    g = mon.compute_portfolio_greeks(pos)
    needs, actions = mon.check_rehedge_needed(g)
    hedge = mon.compute_hedge_trade(g)
    flat = mon.check_rehedge_needed(gm.PortfolioGreeks(delta=10.0, gamma=1.0, vega=50.0,
                                                       theta=-100.0))[0]
    urgent = mon.check_rehedge_needed(gm.PortfolioGreeks(delta=350.0, gamma=0, vega=0,
                                                         theta=0))[1][0].urgency
    cfg = mon.config
    vega = mon.check_rehedge_needed(gm.PortfolioGreeks(
        delta=0.0, gamma=0.0, vega=500.0, theta=0.0, vega_dollars=cfg.max_vega_dollars * 20))
    greeks = {k: v for k, v in g.to_dict().items() if k != "timestamp"}
    return dict(greeks=greeks, needs=needs,
                actions=[(a.action_type.value, a.urgency) for a in actions],
                hedge=hedge.quantity, flat=flat, urgent=urgent,
                vega=(vega[0], [a.action_type.value for a in vega[1]]))


def test_greeks_monitor():
    out = both(greeks_scenario)
    assert out["greeks"]["delta"] == pytest.approx(0.5 * 10 * 100)
    assert out["needs"] and "hedge_delta" in [a for a, _ in out["actions"]]
    assert out["hedge"] == pytest.approx(-out["greeks"]["delta"])
    assert not out["flat"] and out["urgent"] == "critical"
    assert out["vega"][0] and "reduce_vega" in out["vega"][1]


def correlation_scenario(pkg):
    cm = mod(pkg, "risk.correlation_monitor")
    rng = np.random.default_rng(21)
    common = np.cumsum(rng.normal(0, 0.01, 400))
    p1 = 100 * np.exp(common + rng.normal(0, 0.001, 400))
    p2 = 50 * np.exp(common + rng.normal(0, 0.001, 400))
    q1 = 100 * np.exp(np.cumsum(rng.normal(0, 0.01, 400)))
    q2 = 100 * np.exp(np.cumsum(rng.normal(0, 0.01, 400)))
    mon = cm.CorrelationMonitor()
    good, bad = mon.check_pair_health("A-B", p1, p2), mon.check_pair_health("X-Y", q1, q2)
    short = mon.check_pair_health("S-T", np.array([100.0, 101.0, 100.5]),
                                  np.array([50.0, 50.4, 50.2]))
    rng = np.random.default_rng(7)
    c = np.cumsum(rng.normal(0, 0.01, 300))
    coint = mon.test_cointegration(5.0 + 2.0 * (100 + 30 * c) + rng.normal(0, 0.2, 300),
                                   100 + 30 * c)
    return dict(good=(good.status.value, good.current_correlation,
                      good.cointegration.is_cointegrated),
                bad=bad.status.value, short=short.status.value,
                recs=mon.get_position_recommendations({"X-Y": bad, "S-T": short}),
                hedge_ratio=coint.hedge_ratio)


def test_correlation_monitor():
    out = both(correlation_scenario)
    assert out["good"][0] in ("healthy", "warning") and out["good"][1] > 0.7 and out["good"][2]
    assert out["bad"] in ("critical", "failed")
    assert out["recs"]["X-Y"] in ("close", "close_immediately")
    assert out["short"] == "warning" and out["recs"]["S-T"] == "reduce"
    assert abs(out["hedge_ratio"] - 2.0) < 0.1


# ----------------------------------------------------------------- validation

def model_validation_scenario(pkg):
    mv = mod(pkg, "validation.model_validation")
    heston = mv.HestonModelValidator()
    reports = dict(
        good=heston.validate(data=dict(kappa=2.0, theta=0.04, sigma=0.2, rho=-0.7, v0=0.04,
                                       rmse=0.01, r_squared=0.999)),
        feller=heston.validate(data=dict(kappa=0.5, theta=0.02, sigma=0.9, rho=-0.3, v0=0.04,
                                         rmse=0.01)),
        bad=heston.validate(data=dict(kappa=2.0, theta=0.04, sigma=0.2, rho=-0.7, v0=0.04,
                                      rmse=2.0)),
        sabr=mv.SABRModelValidator().validate(data=dict(alpha=0.2, beta=0.5, rho=-0.3, nu=0.4,
                                                        rmse=0.001)),
        sabr_bad=mv.SABRModelValidator().validate(data=dict(alpha=-1.0, beta=0.5, rho=-0.3,
                                                            nu=0.4, rmse=0.001)),
        ou_bad=mv.OUModelValidator().validate(data=dict(mu=5.0, sigma=0.2,
                                                        half_life_days=400.0)),
        ou_ok=mv.OUModelValidator().validate(data=dict(mu=5.0, sigma=0.2, half_life_days=30.0,
                                                       ljung_box_p=0.8)))
    return {k: (r.passed, r.failed_tests, [(x.check_name, x.status.value) for x in r.results])
            for k, r in reports.items()}


def test_model_validation():
    out = both(model_validation_scenario)
    assert out["good"][:2] == (True, 0)
    assert out["feller"][0] and ("feller_condition", "warning") in out["feller"][2]
    assert not out["bad"][0] and out["sabr"][0] and not out["sabr_bad"][0]
    assert not out["ou_bad"][0] and out["ou_ok"][0]


def walk_forward_scenario(pkg):
    wf = mod(pkg, "validation.walk_forward")
    windows = wf.WalkForwardOptimizer(train_size=100, test_size=50).generate_windows(400)
    anchored = wf.WalkForwardOptimizer(100, 50, scheme="anchored").generate_windows(400)
    data = np.random.default_rng(5).normal(0.0005, 0.01, 500)
    report = wf.WalkForwardOptimizer(train_size=200, test_size=100).run(
        data, lambda x, p: float(np.mean(x) * p["scale"]), [{"scale": 1.0}, {"scale": 2.0}])
    folds = [(train.tolist(), test.tolist())
             for train, test in wf.PurgedKFold(n_splits=5, purge_gap=10).split(500)]
    oos = wf.OutOfSampleValidator(oos_fraction=0.3).validate(
        np.random.default_rng(6).normal(0.001, 0.01, 1000), evaluate=lambda x: float(np.mean(x)))
    span = lambda w: (w.train_start, w.train_end, w.test_start, w.test_end)  # noqa: E731
    return dict(windows=[span(w) for w in windows], anchored=[span(w) for w in anchored],
                n_results=len(report.results), stability=dict(report.param_stability),
                folds=folds, oos={k: v for k, v in oos.items() if isinstance(v, (int, float))})


def test_walk_forward():
    out = both(walk_forward_scenario)
    assert len(out["windows"]) == 6 and all(s == 0 for s, *_ in out["anchored"])
    assert out["n_results"] >= 2 and out["stability"]["scale"] > 0
    for train, test in out["folds"]:
        assert np.min(np.abs(np.subtract.outer(train, test))) > 9
    assert "metric_decay" in out["oos"]


def benchmarks_scenario(pkg):
    bm = mod(pkg, "validation.benchmarks")
    rng = np.random.default_rng(8)
    market = rng.normal(0.0004, 0.01, 750)
    strategy = market * 0.5 + rng.normal(0.0004, 0.004, 750)
    report = bm.BenchmarkComparator(risk_free_rate=0.02).compare(strategy, market)
    market = rng.normal(0.0004, 0.01, 2000)
    ab = bm.AlphaCalculator(risk_free_rate=0.0).calculate(
        0.0002 + 0.8 * market + rng.normal(0, 0.001, 2000), market)
    return dict(names=[b.name for b in report.benchmark_results],
                beats=dict(report.beats_benchmark), alpha=dict(ab),
                rf=bm.RiskFreeBenchmark(0.05).calculate_returns(np.zeros(252)))


def test_benchmarks():
    out = both(benchmarks_scenario)
    assert "Buy-and-Hold" in out["names"] and set(out["beats"]) == set(out["names"])
    assert abs(out["alpha"]["beta"] - 0.8) < 0.02 and out["alpha"]["r_squared"] > 0.9
    assert np.allclose(out["rf"], 0.05 / 252)


# ----------------------------------------------------------------- monitoring

def attribution_scenario(pkg):
    attr = mod(pkg, "monitoring.attribution")
    ra = attr.return_attribution({"A": 0.6, "B": 0.4}, {"A": 0.10, "B": -0.05})
    br = attr.brinson_attribution({"tech": 0.7, "fin": 0.3}, {"tech": 0.5, "fin": 0.5},
                                  {"tech": 0.12, "fin": 0.02}, {"tech": 0.10, "fin": 0.04})
    rc = attr.risk_contribution(np.array([0.6, 0.4]), np.array([[0.04, 0.01], [0.01, 0.09]]),
                                ["A", "B"])
    ta = attr.trade_attribution([{"symbol": "A", "strategy": "mr", "pnl": 100},
                                 {"symbol": "A", "strategy": "mr", "pnl": -50},
                                 {"symbol": "B", "strategy": "vol", "pnl": 30}])
    rng = np.random.default_rng(9)
    mkt = rng.normal(0.0004, 0.01, 500)
    fa = attr.factor_attribution(0.0001 + 0.5 * mkt + rng.normal(0, 0.001, 500),
                                 {"market": mkt})
    eng = attr.PerformanceAttributionEngine().report({"A": 1.0}, {"A": 0.05})
    return dict(ra=ra, br=br, rc=rc, ta=ta, fa=fa,
                eng={k: v for k, v in eng.items() if isinstance(v, (int, float))})


def test_attribution():
    out = both(attribution_scenario)
    assert out["ra"]["A"] == pytest.approx(0.06)
    assert sum(v["total"] for v in out["br"].values()) == pytest.approx(
        0.7 * 0.12 + 0.3 * 0.02 - (0.5 * 0.10 + 0.5 * 0.04))
    w, cov = np.array([0.6, 0.4]), np.array([[0.04, 0.01], [0.01, 0.09]])
    assert sum(out["rc"].values()) == pytest.approx(np.sqrt(w @ cov @ w))
    assert out["ta"]["strategy:mr"]["total_pnl"] == 50
    assert out["ta"]["strategy:mr"]["hit_rate"] == 0.5
    assert abs(out["fa"]["beta_market"] - 0.5) < 0.05 and out["fa"]["r_squared"] > 0.8
    assert out["eng"]["total_return"] == pytest.approx(0.05)


def diagnostics_scenario(pkg):
    diag = mod(pkg, "monitoring.diagnostics")
    rng = np.random.default_rng(10)
    base, same, shifted = (rng.normal(0, 1, 5000), rng.normal(0, 1, 5000),
                           rng.normal(1.0, 1.5, 5000))
    eng = diag.ModelDiagnosticsEngine()
    first = eng.record_calibration("heston", "SPY", rmse=0.01, converged=True,
                                   parameters={"kappa": 2.0})
    second = eng.record_calibration("heston", "SPY", rmse=0.5, converged=False,
                                    parameters={"kappa": 8.0})
    t = diag.ForecastAccuracyTracker()
    for f, r in [(0.2, 0.21), (0.25, 0.24), (0.22, 0.22)]:
        t.record("vol", f, r)
    rng = np.random.default_rng(31)
    bt = rng.normal(0.001, 0.01, 1000)
    good = diag.BacktestLiveComparator().compare(bt, rng.normal(0.0012, 0.01, 200))
    bad = diag.BacktestLiveComparator().compare(bt, rng.normal(-0.002, 0.02, 200))
    numbers = lambda d: {k: v for k, v in d.items()  # noqa: E731
                         if isinstance(v, (bool, int, float, str))}
    return dict(psi=(diag.population_stability_index(base, same),
                     diag.population_stability_index(base, shifted)),
                first=first["status"]["status"], second=second["status"]["status"],
                jumps=sorted(second["parameter_jumps"]), report=sorted(eng.report()),
                forecast=t.metrics("vol"), good=numbers(good), bad=numbers(bad))


def test_diagnostics():
    out = both(diagnostics_scenario)
    assert out["psi"][0] < 0.05 and out["psi"][1] > 0.25
    assert out["first"] == "ok" and out["second"] in ("warning", "critical")
    assert "kappa" in out["jumps"] and "heston:SPY" in out["report"]
    assert out["forecast"]["mae"] < 0.02 and out["forecast"]["n"] == 3
    assert not out["good"]["degraded"] and out["bad"]["degraded"]


# ----------------------------------------------------------------------- data

def recovery_scenario(pkg):
    rec, ref = mod(pkg, "data.recovery"), mod(pkg, "data.reference")
    db = mod(pkg, "database.db").TimeSeriesDB(":memory:")
    cal = ref.TradingCalendar()
    days = cal.trading_days_between(date(2026, 3, 2), date(2026, 3, 31))
    kept = [d for d in days if not (date(2026, 3, 9) <= d <= date(2026, 3, 13))]
    db.insert_market_prices([{"time": datetime.combine(d, datetime.min.time()).isoformat(),
                              "symbol": "SPY", "close": 100.0} for d in kept])
    gaps = rec.GapDetector(db, cal).detect("SPY", date(2026, 3, 2), date(2026, 3, 31))
    pipe = mod(pkg, "data.ingestion").DataIngestionPipeline(
        mod(pkg, "data.providers").SimulatedDataProvider(seed=5), db)
    mgr = rec.BackfillManager(pipe)
    mgr.enqueue(gaps)
    stats = mgr.run()
    closes = [r["close"] for r in db.query_market_prices("SPY")]

    class FakeDB:
        def query_market_prices(self, symbol, start=None, end=None):
            return [{"time": datetime(2026, 8, d).isoformat()} for d in (10, 11, 13)]

    present = rec.GapDetector(FakeDB()).detect("X", date(2026, 8, 10), date(2026, 8, 14))
    p1 = {date(2026, 1, d): 100.0 + d for d in range(1, 6)}
    p2 = dict(p1)
    p2[date(2026, 1, 3)] *= 1.05
    recon = rec.DataReconciler(tolerance_pct=0.01).reconcile(p1, p2)
    return dict(gaps=[(g.start, g.end) for g in gaps],
                stats={k: v for k, v in stats.items() if isinstance(v, (int, float))},
                closes=closes, present=[(g.start, g.end) for g in present],
                recon={k: v for k, v in recon.items() if isinstance(v, (int, float))})


def test_recovery():
    out = both(recovery_scenario)
    assert out["gaps"] == [(date(2026, 3, 9), date(2026, 3, 13))]
    assert out["stats"]["completed"] == 1 and out["stats"]["pending"] == 0
    assert out["present"] == [(date(2026, 8, 12), date(2026, 8, 12)),
                              (date(2026, 8, 14), date(2026, 8, 14))]
    assert out["recon"]["n_mismatches"] == 1
    assert out["recon"]["match_rate"] == pytest.approx(0.8)


def data_monitoring_scenario(pkg):
    dm = mod(pkg, "data.monitoring")
    mon = dm.DataQualityMonitor()
    mon.record_update("FRESH", time=NOW)
    mon.record_update("STALE", time=NOW - timedelta(days=10))
    fresh, stale = mon.check_symbol("FRESH", now=NOW), mon.check_symbol("STALE", now=NOW)
    for _ in range(5):
        mon.record_request("yahoo", ok=False, latency_ms=100)
    return dict(fresh=fresh[0].level.value, stale=stale[0].level.value,
                provider=mon.check_provider("yahoo")[0].level.value,
                overall=mon.report()["overall"])


def test_data_quality_monitor():
    out = both(data_monitoring_scenario)
    assert (out["fresh"], out["stale"], out["provider"]) == ("good", "bad", "bad")
    assert out["overall"] == "bad"
