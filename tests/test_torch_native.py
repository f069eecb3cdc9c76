"""``pde_tpu_torch.native``: the C++ host runtime's 14 functions, each held
against the port's own twin on the CPU in float64 at the tolerances of
``tests/test_native.py``, and against the JAX package's binding of the
same library (the same sources, so equal bit for bit).

The port's library is built from the unedited ``src/cpp`` sources by
``pde_tpu_torch/native/loader.py``; a host without ``g++`` skips, as the
reference's tests do.  A tensor on another device than the CPU (here the
``meta`` device stands for the card) or a float32 tensor is refused.
"""

import numpy as np
import pytest
import torch

from pde_tpu import native as jnative
from pde_tpu_torch import native

pytestmark = pytest.mark.skipif(not native.is_available(), reason="native toolchain unavailable")

CPU64 = dict(device="cpu", dtype=torch.float64)


def t64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def test_abi_and_exports():
    assert native.load().pde_host_abi_version() == 3
    reference = set(jnative.__all__)
    assert reference <= set(native.__all__)
    assert {"is_available", "build", "NativeUnavailable"} <= set(native.__all__)
    for name in native.__all__:
        assert callable(getattr(native, name)) or name == "NativeUnavailable"


def test_bar_aggregation_ohlcv():
    times = np.array([0.0, 10.0, 30.0, 61.0, 62.0])
    prices = np.array([100.0, 102.0, 99.0, 101.0, 103.0])
    sizes = np.array([10.0, 20.0, 30.0, 5.0, 5.0])
    bars = native.aggregate_bars(times, prices, sizes, bar_seconds=60.0)
    assert bars.shape == (2, 6)
    np.testing.assert_allclose(bars[0], [0.0, 100.0, 102.0, 99.0, 99.0, 60.0])
    np.testing.assert_allclose(bars[1], [60.0, 101.0, 103.0, 101.0, 103.0, 10.0])


def test_bar_aggregation_matches_the_port_s_aggregator(rng):
    from datetime import datetime, timezone

    from pde_tpu_torch.data.streaming import BarAggregator, StreamTrade

    n = 500
    times = np.sort(rng.uniform(0, 600, n))
    prices = 100 + np.cumsum(rng.normal(0, 0.1, n))
    sizes = rng.integers(1, 100, n).astype(float)
    fast = native.aggregate_bars(times, prices, sizes, 60.0)
    agg, done = BarAggregator(bar_seconds=60.0), []
    for t, p, s in zip(times, prices, sizes):
        bar = agg.add_trade(StreamTrade("X", float(p), float(s),
                                        time=datetime.fromtimestamp(t, tz=timezone.utc)))
        if bar:
            done.append(bar)
    done.extend(agg.flush())
    assert len(fast) == len(done)
    np.testing.assert_allclose(fast[:, 4], [b.close for b in done], atol=1e-12)
    np.testing.assert_allclose(fast[:, 5], [b.volume for b in done], atol=1e-12)


def test_position_backtest_matches_the_port_s_vectorized(rng):
    from pde_tpu_torch.backtest import vectorized

    prices = 100 * np.exp(np.cumsum(rng.normal(0, 0.01, 800)))
    positions = np.sign(rng.normal(0, 1, 800))
    fast = native.run_position_backtest(prices, positions, cost_per_turnover=0.0005)
    ret, eq = vectorized.equity_from_positions(t64(prices), t64(positions), 0.0005,
                                               device="cpu")
    np.testing.assert_allclose(fast["returns"], ret.numpy(), atol=1e-12)
    np.testing.assert_allclose(fast["equity"], eq.numpy(), atol=1e-10)
    stats = vectorized.backtest_positions(t64(prices), t64(positions), 0.0005, device="cpu")
    assert fast["total_return"] == pytest.approx(float(stats["total_return"]), abs=1e-10)
    assert fast["max_drawdown"] == pytest.approx(float(stats["max_drawdown"]), abs=1e-10)


def test_zscore_positions_match_the_port_s_strategy(rng):
    from pde_tpu_torch.backtest.strategy import MeanReversionStrategy

    prices = 100 + np.cumsum(rng.normal(0, 0.5, 400))
    fast = native.zscore_positions(prices, 20, 2.0, 0.5)
    np.testing.assert_allclose(fast, MeanReversionStrategy.signal_array(prices, 20, 2.0, 0.5),
                               atol=1e-12)


def test_thomas_matches_the_port_s_thomas(rng):
    from pde_tpu_torch.ops import tridiag

    B, n = 5, 40
    lower, upper = rng.uniform(-1, 1, (B, n - 1)), rng.uniform(-1, 1, (B, n - 1))
    diag, rhs = 4 + rng.uniform(0, 1, (B, n)), rng.uniform(-1, 1, (B, n))
    fast = native.thomas_solve(lower, diag, upper, rhs)
    ref = tridiag.thomas(*map(t64, (lower, diag, upper, rhs))).numpy()
    np.testing.assert_allclose(fast, ref, rtol=1e-12)
    one = native.thomas_solve(lower[0], diag[0], upper[0], rhs[0])
    np.testing.assert_allclose(one, ref[0], rtol=1e-12)


def test_ou_mle_matches_the_port_s_fit(rng):
    from pde_tpu_torch.models import ou

    dt, n = 4.0 / 1000, 1000
    a = np.exp(-2.0 * dt)
    sd = 0.4 * np.sqrt((1 - a * a) / (2 * 2.0))
    path = np.empty(n + 1)
    path[0] = 2.0
    for k in range(n):
        path[k + 1] = 6.0 + (path[k] - 6.0) * a + sd * rng.normal()
    fast = native.ou_mle(path, dt)
    ref = ou.fit_mle(t64(path), dt)
    assert fast[0] == pytest.approx(float(ref.params.theta), abs=1e-8)
    assert fast[1] == pytest.approx(float(ref.params.mu), rel=1e-6)
    assert fast[2] == pytest.approx(float(ref.params.sigma), rel=1e-8)


def test_heston_oracle_matches_the_port_s_pricer():
    from pde_tpu_torch.models import heston

    p = heston.HestonParams(*(t64(x) for x in (2.0, 0.04, 0.3, -0.7, 0.04)))
    K = np.linspace(80.0, 120.0, 21)
    T = np.full(21, 0.9)
    T[:3] = 0.0  # the zero-maturity intrinsic branch
    ic = (np.arange(21) % 2).astype(float)
    cpp = native.heston_price_batch(2.0, 0.04, 0.3, -0.7, 0.04, 100.0, 0.05, 0.02, K, T, ic)
    port = heston.price_carr_madan(p, t64(K), t64(T), t64(100.0), 0.05, 0.02,
                                   is_call=torch.as_tensor(ic > 0.5)).numpy()
    np.testing.assert_allclose(cpp, port, atol=1e-10)


def test_sabr_oracle_matches_the_port_s_smile():
    from pde_tpu_torch.models import sabr

    sp = sabr.SABRParams(*(t64(x) for x in (0.25, 0.7, -0.3, 0.45)))
    K = np.linspace(80.0, 120.0, 21)
    np.testing.assert_allclose(native.sabr_vols(0.25, 0.7, -0.3, 0.45, 100.0, 1.25, K),
                               sabr.implied_volatilities(t64(K), t64(100.0), t64(1.25),
                                                         sp).numpy(), atol=1e-12)
    atm = native.sabr_vols(0.25, 0.7, -0.3, 0.45, 100.0, 1.25, np.array([100.0]))
    np.testing.assert_allclose(
        atm[0], float(sabr.implied_volatility(t64(100.0), t64(100.0), t64(1.25), sp)),
        atol=1e-12)
    t0 = native.sabr_vols(0.25, 0.7, -0.3, 0.45, 100.0, 0.0, K[:2])
    np.testing.assert_allclose(
        t0, sabr.implied_volatility(t64(K[:2]), t64(100.0), t64(0.0), sp).numpy(), atol=1e-12)


def test_bs_implied_vol_oracle_matches_the_port_s_newton():
    from pde_tpu_torch.models import black_scholes as bs

    S0, r, q = 100.0, 0.05, 0.02
    K = np.linspace(80.0, 120.0, 17)
    T = np.full(17, 0.75)
    ic = (np.arange(17) % 2).astype(float)
    true_vol = np.linspace(0.15, 0.35, 17)
    call = torch.as_tensor(ic > 0.5)
    prices = bs.price(t64(S0), t64(K), t64(r), t64(q), t64(T), t64(true_vol), call).numpy()
    native_iv = native.bs_implied_vol(prices, S0, K, r, q, T, ic)
    np.testing.assert_allclose(native_iv, true_vol, atol=1e-7)
    port_iv = bs.implied_vol(t64(prices), t64(S0), t64(K), t64(r), t64(q), t64(T),
                             call).numpy()
    np.testing.assert_allclose(native_iv, port_iv, atol=1e-6)


@pytest.mark.parametrize("case", [
    dict(params=dict(sigma=0.25, r=0.05, q=0.01, T=1.0, K=100.0), S0=105.0, native={},
         tol=1e-10),
    dict(params=dict(sigma=0.25, r=0.05, q=0.0, T=1.0, K=100.0, is_call=False, american=True),
         S0=95.0, native=dict(is_call=False, american=True), tol=1e-9),
    dict(params=dict(sigma=0.3, r=0.03, q=0.0, T=0.5, K=90.0, scheme="implicit"), S0=92.0,
         native=dict(crank_nicolson=False), tol=1e-9),
], ids=["european", "american_put", "implicit"])
def test_bs_pde_oracle_matches_the_port_s_solver(case):
    from pde_tpu_torch.solvers import bs_pde

    p = case["params"]
    res = bs_pde.solve(bs_pde.BSPDEParams(**p), case["S0"], **CPU64)
    price, grid, sgrid = native.bs_pde_solve(case["S0"], p["sigma"], p["r"], p["q"], p["T"],
                                             p["K"], **case["native"])
    assert price == pytest.approx(float(res.price), abs=case["tol"])
    if not case["native"]:
        np.testing.assert_allclose(grid, res.prices.numpy(), rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(sgrid, res.spot_grid.numpy(), rtol=1e-12)


@pytest.mark.parametrize("case", [
    dict(params={}, native=(0.05, 0.0, 1.0, 100.0), kw={}),
    dict(params=dict(is_call=False, american=True), native=(0.05, 0.0, 1.0, 100.0),
         kw=dict(is_call=False, american=True)),
    dict(params=dict(q=0.02, T=0.5, K=95.0, is_call=False), native=(0.05, 0.02, 0.5, 95.0),
         kw=dict(is_call=False)),
], ids=["european", "american_put", "dividend_put"])
def test_heston_adi_oracle_matches_the_port_s_march(case):
    from pde_tpu_torch.solvers import heston_adi

    res = heston_adi.solve(heston_adi.HestonPDEParams(**case["params"]), 100.0, **CPU64)
    price, grid = native.heston_adi_solve(2.0, 0.04, 0.3, -0.7, 0.04, *case["native"], 100.0,
                                          **case["kw"])
    assert price == pytest.approx(float(res.price), abs=1e-9)
    if not case["params"]:
        np.testing.assert_allclose(grid, res.prices.numpy(), rtol=1e-6, atol=1e-7)


def test_hjb_marches_match_the_port_s_marches():
    from pde_tpu_torch.solvers import hjb

    p = hjb.HJBParams(backend="device")
    res = hjb.solve(p, **CPU64)
    exercise = np.asarray(hjb._host_grid_and_payoffs(p, [p.problem])[1][0])
    vn = native.hjb_march(p.theta, p.mu, p.sigma, p.r, p.T, p.x_min, p.x_max, exercise,
                          n_time=p.n_time)
    np.testing.assert_allclose(vn, np.asarray(res.value_function), rtol=1e-10, atol=1e-12)

    q = hjb.HJBParams(mu=5.0, sigma=0.1, c_entry=0.002, c_exit=0.002, n_space=96, n_time=24,
                      method="brennan_schwartz")
    _, g = hjb._host_grid_and_payoffs(q, list(hjb.StoppingProblem))
    rev = [hjb._BS_REVERSE[pr] for pr in hjb.StoppingProblem]
    multi = native.hjb_march_bs_multi(q.theta, q.mu, q.sigma, q.r, q.T, q.x_min, q.x_max,
                                      g, rev, n_time=q.n_time)
    for k, pr in enumerate(hjb.StoppingProblem):
        single = native.hjb_march_bs(q.theta, q.mu, q.sigma, q.r, q.T, q.x_min, q.x_max,
                                     g[k], rev[k], n_time=q.n_time)
        _, vd = hjb._march(t64(g[k]), q.theta, q.mu, q.sigma, q.r, q.T, q.x_min, q.x_max,
                           q.n_space, q.n_time, method="brennan_schwartz",
                           bs_reverse=rev[k])
        np.testing.assert_allclose(single, vd.numpy(), rtol=1e-10, atol=1e-12,
                                   err_msg=pr.name)
        assert np.array_equal(multi[k], single), pr.name


def _port_fills(ticks, orders, slippage, impact, adv):
    """The port's event handler driven over the same stream as the
    reference test's ``_python_fills``."""
    from pde_tpu_torch.backtest.events import Direction, MarketEvent, OrderEvent, OrderType
    from pde_tpu_torch.backtest.execution import SimulatedExecutionHandler

    h = SimulatedExecutionHandler(slippage_pct=slippage, market_impact_coeff=impact, adv=adv)
    results, oi = {}, 0
    for t, px in ticks:
        h.update_market_data(MarketEvent(event_type=None, timestamp=t, symbol="X", price=px))
        while oi < len(orders) and orders[oi][0] <= t:
            st, side, typ, lp, sp, q = orders[oi]
            ev = OrderEvent(event_type=None, timestamp=st, symbol="X",
                            direction=Direction.BUY if side > 0 else Direction.SELL,
                            quantity=q,
                            order_type=[OrderType.MARKET, OrderType.LIMIT,
                                        OrderType.STOP][int(typ)],
                            limit_price=lp, stop_price=sp, order_id=str(oi))
            fill = h.execute_order(ev)
            if fill is not None:
                results[oi] = (t, fill.fill_price, fill.commission, fill.slippage)
            oi += 1
        for fill in h.process_pending():
            results[int(fill.order_id)] = (t, fill.fill_price, fill.commission, fill.slippage)
    return results


def test_fill_engine_matches_the_port_s_handler(rng):
    n_ticks, n_orders = 500, 60
    times = np.arange(n_ticks, dtype=float)
    prices = 100.0 * np.exp(np.cumsum(rng.normal(0, 0.003, n_ticks)))
    submit = np.sort(rng.uniform(0, n_ticks * 0.8, n_orders))
    sides = rng.choice([1.0, -1.0], n_orders)
    types = rng.choice([0.0, 1.0, 2.0], n_orders, p=[0.4, 0.3, 0.3])
    limits = prices[0] * (1 + rng.normal(0, 0.01, n_orders))
    stops = prices[0] * (1 + rng.normal(0, 0.01, n_orders))
    qty = rng.integers(1, 500, n_orders).astype(float)
    n_filled, fills = native.simulate_fills(times, prices, submit, sides, types, limits, stops,
                                            qty, slippage_pct=5e-4, market_impact_coeff=0.1,
                                            adv=1e6)
    port = _port_fills(list(zip(times, prices)),
                       list(zip(submit, sides, types, limits, stops, qty)), 5e-4, 0.1, 1e6)
    assert n_filled == len(port)
    for k in range(n_orders):
        if k in port:
            np.testing.assert_allclose(fills[k], port[k], rtol=1e-12, err_msg=f"order {k}")
        else:
            assert np.isnan(fills[k]).all(), f"order {k} filled natively only"


def test_limit_buy_waits_for_price():
    n, fills = native.simulate_fills(np.array([0.0, 1.0, 2.0]), np.array([100.0, 101.0, 98.0]),
                                     [0.0], [1.0], [1.0], [99.0], [0.0], [10.0],
                                     slippage_pct=0.0, market_impact_coeff=0.0)
    assert n == 1
    assert fills[0][0] == 2.0 and fills[0][1] == 98.0


def test_fill_throughput(rng):
    import time

    n_ticks, n_orders = 200_000, 100_000
    times = np.arange(n_ticks, dtype=float)
    prices = 100.0 * np.exp(np.cumsum(rng.normal(0, 0.001, n_ticks)))
    submit = np.sort(rng.uniform(0, n_ticks - 1.0, n_orders))
    sides = rng.choice([1.0, -1.0], n_orders)
    z = np.zeros(n_orders)
    t0 = time.perf_counter()
    n, _ = native.simulate_fills(times, prices, submit, sides, z, z, z, np.full(n_orders, 100.0))
    dt = time.perf_counter() - t0
    assert n == n_orders
    assert n / dt > 1e5, f"only {n / dt:.0f} fills/s"


def test_the_bindings_equal_the_reference_s(rng):
    """The port and the JAX package bind the same C ABI of the same
    sources: equal outputs, bit for bit."""
    B, n = 3, 30
    bands = (rng.uniform(-1, 1, (B, n - 1)), 4 + rng.uniform(0, 1, (B, n)),
             rng.uniform(-1, 1, (B, n - 1)), rng.uniform(-1, 1, (B, n)))
    prices = 100 * np.exp(np.cumsum(rng.normal(0, 0.01, 300)))
    K = np.linspace(80.0, 120.0, 9)
    calls = [
        ("thomas_solve", bands, {}),
        ("zscore_positions", (prices, 20, 2.0, 0.5), {}),
        ("heston_price_batch", (2.0, 0.04, 0.3, -0.7, 0.04, 100.0, 0.05, 0.02, K, 0.5, 1.0),
         {}),
        ("sabr_vols", (0.25, 0.7, -0.3, 0.45, 100.0, 1.25, K), {}),
        ("bs_pde_solve", (100.0, 0.2, 0.05, 0.02, 1.0, 100.0), dict(n_space=64, n_time=20)),
        ("heston_adi_solve", (2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.0, 1.0, 100.0, 100.0),
         dict(n_spot=24, n_vol=12, n_time=10)),
    ]
    for name, args, kw in calls:
        a, b = getattr(native, name)(*args, **kw), getattr(jnative, name)(*args, **kw)
        for x, y in zip(np.atleast_1d(np.asarray(a, dtype=object)),
                        np.atleast_1d(np.asarray(b, dtype=object))):
            assert np.array_equal(np.asarray(x, dtype=float), np.asarray(y, dtype=float)), name
    assert native.ou_mle(prices, 0.01) == jnative.ou_mle(prices, 0.01)
    assert native.run_position_backtest(prices, np.sign(prices - 100))["sharpe"] == \
        jnative.run_position_backtest(prices, np.sign(prices - 100))["sharpe"]


@pytest.mark.parametrize("bad", [
    torch.zeros(8, dtype=torch.float64, device="meta"),
    torch.zeros(8, dtype=torch.float32),
], ids=["device_tensor", "float32_tensor"])
def test_a_device_or_float32_tensor_is_refused(bad):
    with pytest.raises(ValueError, match="runs on the host in float64"):
        native.zscore_positions(bad, 3, 2.0, 0.5)
    with pytest.raises(ValueError, match="runs on the host in float64"):
        native.thomas_solve(bad[:-1], bad, bad[:-1], bad)
    with pytest.raises(ValueError, match="runs on the host in float64"):
        native.ou_mle(torch.zeros(8, dtype=torch.float64), bad[0])
    # a float64 CPU tensor is a host array
    ok = native.zscore_positions(torch.linspace(90, 110, 40, dtype=torch.float64), 5, 1.0, 0.2)
    assert ok.shape == (40,)
