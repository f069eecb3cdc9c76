"""The port's backtest layer held against ``pde_tpu``: events, metrics,
strategies, the vectorized backtester, the bar feeds, walk-forward and
Monte-Carlo analysis, and the multi-strategy vote.

The same seeded numpy prices go through both packages in float64 (the JAX
side under ``jax_enable_x64``).  Gates, each with its reason:
- positions and the plain copies (events, metrics, strategies): equal.
  The port's prefix sums round in the order of the reference's compiled
  ``jnp.cumsum`` and its walks compose exact integer maps, so its float64
  positions are the reference's bit for bit;
- metrics and out-of-sample returns: 1e-12 relative (means and standard
  deviations reduce in another order);
- JAX's own draws replayed through ``JaxKey``: 1e-12.
Series stay at <= 300 bars: the reference's eager ``lax.scan``s compile
on every call.
"""

import itertools
import queue
from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from jax_key_draws import JaxKey
from pde_tpu.backtest import analysis as ja
from pde_tpu.backtest import data_handler as jdh
from pde_tpu.backtest import events as jev
from pde_tpu.backtest import metrics as jm
from pde_tpu.backtest import multi_strategy as jms
from pde_tpu.backtest import strategy as js
from pde_tpu.backtest import vectorized as jv
from pde_tpu_torch.backtest import analysis as ta
from pde_tpu_torch.backtest import data_handler as tdh
from pde_tpu_torch.backtest import events as tev
from pde_tpu_torch.backtest import metrics as tm
from pde_tpu_torch.backtest import multi_strategy as tms
from pde_tpu_torch.backtest import optimizer as to
from pde_tpu_torch.backtest import strategy as ts
from pde_tpu_torch.backtest import vectorized as tv
from pde_tpu_torch.core.precision import blocked_cumprod, blocked_cumsum
from pde_tpu_torch.validation import statistical_tests as tst
from pde_tpu_torch.validation import stress_testing as tsx

CPU = dict(device="cpu")
REL = dict(rtol=1e-12, atol=0.0)


def mean_reverting(n, seed, phi=0.97, vol=0.02, drift_vol=0.005):
    """Seeded log prices: an AR(1) around a slow random walk (numpy)."""
    rng = np.random.default_rng(seed)
    eps = rng.normal(0.0, vol, n)
    x = np.zeros(n)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + eps[t]
    return 100.0 * np.exp(x + np.cumsum(rng.normal(0.0, drift_vol, n)))


def _close(a, b, rel=1e-12):
    """Relative closeness of two floats (exact where either is 0)."""
    return abs(a - b) <= rel * max(abs(a), abs(b))


# -- the blocked prefix scans -------------------------------------------------

@pytest.mark.parametrize("n", [1, 16, 17, 255, 256, 257, 2520, 4100])
def test_blocked_scans_round_as_the_reference_s_cumsum(n):
    x = np.random.default_rng(n).normal(0.0, 1.0, (3, n))
    y = 1.0 + np.random.default_rng(n + 1).normal(0.0, 0.01, (3, n))
    assert np.array_equal(blocked_cumsum(torch.as_tensor(x)).numpy(),
                          np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)))
    assert np.array_equal(blocked_cumprod(torch.as_tensor(y)).numpy(),
                          np.asarray(jnp.cumprod(jnp.asarray(y), axis=-1)))


# -- events, metrics, strategies: plain copies --------------------------------

TS = datetime(2022, 1, 3)


def test_events_are_the_reference_s():
    for ev in (jev, tev):
        m = ev.MarketEvent(event_type=None, timestamp=TS, symbol="A", price=100.0,
                           bid=99.9, ask=100.2)
        f = ev.FillEvent(event_type=None, timestamp=TS, symbol="A", quantity=-10,
                         fill_price=50.0, commission=1.0, slippage=0.5)
        o = ev.OrderEvent(event_type=None, timestamp=TS, symbol="A", quantity=-3)
        got = (m.event_type.value, m.mid_price, m.spread, m.spread_pct, f.event_type.value,
               f.total_cost, f.notional_value, f.cost_bps, o.notional_value(7.0),
               ev.SignalEvent(event_type=None, timestamp=TS).event_type.value)
        if ev is jev:
            want = got
    assert got == want
    assert [e.value for e in tev.SignalType] == [e.value for e in jev.SignalType]
    assert [e.value for e in tev.OrderType] == [e.value for e in jev.OrderType]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_are_the_reference_s(seed):
    r = np.random.default_rng(seed).normal(0.0004, 0.012, 300)
    assert tm.performance_metrics(r, 0.02) == jm.performance_metrics(r, 0.02)
    eq = np.cumprod(1 + r)
    assert tm.drawdown_stats(eq) == jm.drawdown_stats(eq)
    np.testing.assert_array_equal(tm.equity_to_returns(eq), jm.equity_to_returns(eq))
    assert tm.performance_metrics(np.array([])) == jm.performance_metrics(np.array([]))


STRATEGIES = {
    "buy_and_hold": ("BuyAndHoldStrategy", {}),
    "ma_cross": ("MovingAverageCrossStrategy", dict(short_window=10, long_window=40)),
    "mean_reversion": ("MeanReversionStrategy", dict(lookback=20, entry_z=1.5, exit_z=0.5)),
    "momentum": ("MomentumStrategy", dict(lookback=30, holding_period=10)),
}


def _signals(module, events, cls, kw, prices):
    strat = getattr(module, cls)(["A"], **kw)
    q = queue.Queue()
    for i, p in enumerate(prices):
        strat.calculate_signals(events.MarketEvent(event_type=None, timestamp=TS, symbol="A",
                                                   price=float(p)), q)
    out = []
    while not q.empty():
        s = q.get()
        out.append((s.symbol, s.signal_type.value, s.strength, s.strategy_id))
    return out


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategies_are_the_reference_s(name):
    cls, kw = STRATEGIES[name]
    prices = mean_reverting(300, 5)
    assert _signals(ts, tev, cls, kw, prices) == _signals(js, jev, cls, kw, prices)
    np.testing.assert_array_equal(getattr(ts, cls).signal_array(prices, *kw.values()),
                                  getattr(js, cls).signal_array(prices, *kw.values()))


# -- the vectorized backtester ------------------------------------------------

def test_equity_from_positions_math():
    prices = torch.tensor([100.0, 110.0, 99.0, 108.9], dtype=torch.float64)
    pos = torch.tensor([1.0, 1.0, 0.0, 0.0], dtype=torch.float64)
    ret, eq = tv.equity_from_positions(prices, pos, cost_per_turnover=0.0)
    np.testing.assert_allclose(ret.numpy(), [0.10, -0.10, 0.0], atol=1e-12)
    assert float(eq[-1]) == pytest.approx(0.99)


def test_costs_charged_on_turnover():
    prices = torch.tensor([100.0, 100.0, 100.0], dtype=torch.float64)
    pos = torch.tensor([1.0, -1.0, 0.0], dtype=torch.float64)
    ret, _ = tv.equity_from_positions(prices, pos, cost_per_turnover=0.001)
    # t0: enter (|1|), t1: flip (|2|)
    np.testing.assert_allclose(ret.numpy(), [-0.001, -0.002], atol=1e-12)


GENERATORS = {
    "ma_cross": (jv.ma_cross_positions, tv.ma_cross_positions, [(5, 40), (10, 60), (20, 100)]),
    "zscore": (jv.zscore_positions, tv.zscore_positions,
               [(15, 1.5, 0.5), (20, 2.0, 0.5), (30, 1.0, 0.0)]),
    "momentum": (jv.momentum_positions, tv.momentum_positions, [(20, 5), (40, 10), (60, 20)]),
}


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_positions_equal_the_reference(name, seed):
    jfn, tfn, combos = GENERATORS[name]
    prices = mean_reverting(300, seed)
    for args in combos:
        want = np.asarray(jfn(jnp.asarray(prices), *args))
        got = tfn(prices, *args, **CPU).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(args))
        # a batch of symbols and a grid column give the same rows
        cols = [torch.tensor([a, a]) for a in args]
        batched = tfn(torch.as_tensor(np.stack([prices, prices[::-1]]))[:, None, :], *cols)
        np.testing.assert_array_equal(batched[0, 1].numpy(), want)
        np.testing.assert_array_equal(batched[1, 0].numpy(),
                                      np.asarray(jfn(jnp.asarray(prices[::-1].copy()), *args)))


def test_positions_match_the_event_driven_strategies():
    prices = mean_reverting(300, 13)
    vec = tv.ma_cross_positions(prices, 10, 40, **CPU).numpy()
    np.testing.assert_allclose(vec[45:], ts.MovingAverageCrossStrategy.signal_array(
        prices, 10, 40)[45:], atol=1e-9)
    np.testing.assert_array_equal(tv.zscore_positions(prices, 20, 2.0, 0.5, **CPU).numpy(),
                                  ts.MeanReversionStrategy.signal_array(prices, 20, 2.0, 0.5))


@pytest.mark.parametrize("n", [0, 1, 2])
def test_short_series_metrics_match_the_reference(n):
    """One bar (no return) or two give the reference's finite metrics."""
    prices = np.array([100.0, 101.0])[:max(n, 1)]
    got = tv.backtest_positions(prices, np.ones(prices.size), 0.001, **CPU)
    want = jv.backtest_positions(jnp.asarray(prices), jnp.ones(prices.size), 0.001)
    for k in tv.METRICS:
        assert _close(float(got[k]), float(want[k])), k
    assert blocked_cumsum(torch.zeros(3, n)).shape == (3, n)


@pytest.mark.parametrize("cost", [0.0, 0.0005])
def test_backtest_metrics_match_the_reference(cost):
    prices = mean_reverting(300, 6)
    pos = np.array(jv.zscore_positions(jnp.asarray(prices), 20, 1.5, 0.5))
    want = jv.backtest_positions(jnp.asarray(prices), jnp.asarray(pos), cost)
    got = tv.backtest_positions(prices, pos, cost, **CPU)
    for k in tv.METRICS:
        assert _close(float(got[k]), float(want[k])), k
    ret_t, eq_t = tv.equity_from_positions(prices, pos, cost, **CPU)
    ret_j, eq_j = jv.equity_from_positions(jnp.asarray(prices), jnp.asarray(pos), cost)
    np.testing.assert_array_equal(ret_t.numpy(), np.asarray(ret_j))
    np.testing.assert_array_equal(eq_t.numpy(), np.asarray(eq_j))


def test_grid_backtest_matches_the_reference():
    prices = mean_reverting(300, 2)
    shorts, longs = np.array([5, 10, 20, 5, 10]), np.array([50, 50, 60, 30, 100])
    want = jv.grid_backtest_ma(jnp.asarray(prices), shorts, longs)
    got = tv.grid_backtest_ma(prices, shorts, longs, **CPU)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), **REL)


# -- no Python loop over the bars ----------------------------------------------

class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops(fn, n):
    with _OpCounter() as c:
        fn(n)
    return c.n


def _family(name):
    spec = to.STRATEGY_FAMILIES[name]
    grid = [dict(zip(spec["grid"], c)) for c in itertools.product(*spec["grid"].values())]
    return lambda n: tv._grid_metrics(spec["fn"], [mean_reverting(n, 1)], grid, 0.0005, "cpu")


OP_PATHS = {
    **{f"family:{k}": _family(k) for k in to.STRATEGY_FAMILIES},
    "monte_carlo:shuffle": lambda n: ta.MonteCarloSimulator(8, "shuffle", **CPU).run(
        np.full(n, 1e-3)),
    "monte_carlo:block": lambda n: ta.MonteCarloSimulator(8, "block", **CPU).run(
        np.full(n, 1e-3)),
    "synthetic_bars": lambda n: tdh.SyntheticDataHandler(["A", "B"], n_bars=n, **CPU),
    "bootstrap": lambda n: tst.BootstrapAnalysis(8, **CPU).max_drawdown_confidence_interval(
        np.full(n, 1e-3)),
    "stress": lambda n: tsx.StressTestEngine(**CPU).run_monte_carlo_stress(0.01, n, 8),
}


@pytest.mark.parametrize("name", sorted(OP_PATHS))
def test_no_path_loops_over_the_bars(name):
    """From 256 to 4096 bars (4 doublings) a path may add a bounded number
    of ops a doubling (the walks' rounds, the scans' levels), never ~n."""
    small, large = _ops(OP_PATHS[name], 256), _ops(OP_PATHS[name], 4096)
    assert large - small <= 4 * 40, (small, large)


# -- bar feeds -----------------------------------------------------------------

def test_synthetic_bars_on_jax_draws_match_the_reference():
    want = jdh.SyntheticDataHandler(["A", "B", "C"], n_bars=200, annual_vol=0.3, seed=13)
    got = tdh.SyntheticDataHandler(["A", "B", "C"], n_bars=200, annual_vol=0.3, seed=13,
                                   generator=JaxKey(jax.random.PRNGKey(13)), **CPU)
    for s in "ABC":
        np.testing.assert_allclose(got.prices[s], want.prices[s], **REL)
    assert got.timestamps == want.timestamps


def test_synthetic_bars_on_a_generator_are_seeded():
    a = tdh.SyntheticDataHandler(["A"], n_bars=100, seed=3, **CPU)
    b = tdh.SyntheticDataHandler(["A"], n_bars=100, seed=3, **CPU)
    np.testing.assert_array_equal(a.prices["A"], b.prices["A"])
    assert a.prices["A"][0] == 100.0 and np.all(a.prices["A"] > 0)


class _Frame:
    """A minimal DataFrame stand-in: columns, an index, ``df[c].to_numpy``."""

    def __init__(self, data, index):
        self._data, self.columns, self.index = data, list(data), index

    def __getitem__(self, c):
        return type("Col", (), {"to_numpy": lambda _, dtype=None: np.asarray(
            self._data[c], dtype=dtype)})()


def test_array_and_frame_handlers_feed_the_reference_s_bars():
    prices = {"A": [1.0, 2.0, 3.0], "B": [4.0, 5.0, 6.0]}
    idx = [datetime(2021, 1, d) for d in (4, 5, 6)]
    for h_t, h_j in ((tdh.ArrayDataHandler(prices), jdh.ArrayDataHandler(prices)),
                     (tdh.HistoricDataFrameHandler(_Frame(prices, idx)),
                      jdh.HistoricDataFrameHandler(_Frame(prices, idx)))):
        qt, qj = queue.Queue(), queue.Queue()
        while h_t.continue_backtest:
            h_t.update_bars(qt)
            h_j.update_bars(qj)
            assert h_t.get_latest_price("B") == h_j.get_latest_price("B")
        assert not h_j.continue_backtest
        assert [(e.symbol, e.price, e.timestamp) for e in qt.queue] == [
            (e.symbol, e.price, e.timestamp) for e in qj.queue]
    with pytest.raises(ValueError):
        tdh.ArrayDataHandler({"A": [1.0], "B": [1.0, 2.0]})


# -- analysis -------------------------------------------------------------------

def _ma(p, short, long):
    return tv.ma_cross_positions(p, short, long)


def _ma_ref(p, short, long):
    return jv.ma_cross_positions(jnp.asarray(p), short, long)


@pytest.mark.parametrize("anchored", [False, True])
def test_walk_forward_matches_the_reference(anchored):
    prices = mean_reverting(300, 4)
    kw = dict(param_grid={"short": [5, 10], "long": [30, 40]}, is_window=120, oos_window=60,
              anchored=anchored)
    want = ja.WalkForwardAnalysis(_ma_ref, **kw).run(prices)
    got = ta.WalkForwardAnalysis(_ma, **kw, **CPU).run(prices)
    assert len(got.windows) == len(want.windows) == 3
    for g, w in zip(got.windows, want.windows):
        assert (g.is_start, g.is_end, g.oos_end, g.best_params) == (
            w.is_start, w.is_end, w.oos_end, w.best_params)
        for k in ("is_sharpe", "oos_sharpe", "oos_return"):
            assert _close(getattr(g, k), getattr(w, k)), k
    np.testing.assert_allclose(got.oos_returns, want.oos_returns, **REL)
    for k, v in want.oos_metrics.items():
        assert _close(got.oos_metrics[k], v, 1e-10), k
    assert _close(got.sharpe_decay, want.sharpe_decay, 1e-10)


def test_jax_permutes_an_array_as_it_permutes_its_index():
    """The replay draws index permutations (``JaxKey.permutation``) where the
    reference permutes the returns themselves: the same order."""
    r = np.random.default_rng(0).normal(size=2520)
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    got = jax.vmap(lambda k: jax.random.permutation(k, jnp.asarray(r)))(keys)
    idx = jax.vmap(lambda k: jax.random.permutation(k, r.shape[0]))(keys)
    np.testing.assert_array_equal(np.asarray(got), r[np.asarray(idx)])


@pytest.mark.parametrize("method", ["shuffle", "block", "parametric"])
def test_monte_carlo_on_jax_draws_matches_the_reference(method):
    rets = np.random.default_rng(7).normal(0.0005, 0.01, 200)
    want = ja.MonteCarloSimulator(n_simulations=40, method=method, block_size=15,
                                  seed=1).run(rets, keep_paths=True)
    got = ta.MonteCarloSimulator(n_simulations=40, method=method, block_size=15, seed=1,
                                 **CPU).run(rets, keep_paths=True,
                                            generator=JaxKey(jax.random.PRNGKey(1)))
    np.testing.assert_allclose(got.equity_paths, want.equity_paths, **REL)
    for k in ("final_equity_mean", "final_equity_std", "prob_loss"):
        assert _close(getattr(got, k), getattr(want, k)), k
    for k in ("final_equity_percentiles", "max_drawdown_percentiles", "sharpe_percentiles"):
        for q, v in getattr(want, k).items():
            assert _close(getattr(got, k)[q], v, 1e-11), (k, q)


@pytest.mark.parametrize("method", ["shuffle", "block", "parametric"])
def test_monte_carlo_on_a_generator(method):
    rets = np.random.default_rng(8).normal(0.0005, 0.01, 300)
    res = ta.MonteCarloSimulator(n_simulations=200, method=method, seed=1, **CPU).run(rets)
    assert res.n_simulations == 200 and 0.0 <= res.prob_loss <= 1.0
    assert res.final_equity_percentiles["p5"] <= res.final_equity_percentiles["p95"]
    realized = np.prod(1 + rets)
    assert abs(res.final_equity_mean - realized) / realized < 0.25
    again = ta.MonteCarloSimulator(n_simulations=200, method=method, seed=1, **CPU).run(rets)
    assert again.sharpe_percentiles == res.sharpe_percentiles


def test_monte_carlo_bad_method():
    with pytest.raises(ValueError):
        ta.MonteCarloSimulator(method="nope", **CPU).run(np.zeros(10))


def test_parameter_sensitivity_matches_the_reference():
    prices = mean_reverting(250, 8)
    kw = dict(prices=prices, base_params={"lookback": 40},
              param_ranges={"lookback": [20, 40, 60]})
    want = ja.parameter_sensitivity(
        lambda p, lookback: jv.momentum_positions(jnp.asarray(p), lookback, 10), **kw)
    got = ta.parameter_sensitivity(
        lambda p, lookback: tv.momentum_positions(p, lookback, 10), **kw, **CPU)
    assert [v for v, _ in got["lookback"]] == [20, 40, 60]
    for (_, g), (_, w) in zip(got["lookback"], want["lookback"]):
        assert _close(g, w)


def test_strategy_returns_are_the_reference_s():
    prices, pos = mean_reverting(100, 2), np.sign(np.sin(np.arange(100) / 7.0))
    for a, b in zip(ta._strategy_returns(prices, pos, 0.001),
                    ja._strategy_returns(prices, pos, 0.001)):
        np.testing.assert_array_equal(a, b)


# -- the multi-strategy vote ------------------------------------------------------

@pytest.mark.parametrize("n", [70, 160])
def test_multi_strategy_vote_matches_the_reference(n):
    prices = mean_reverting(n, 9)
    got = tms.MultiStrategyManager(["A"], window=120, **CPU)
    want = jms.MultiStrategyManager(["A"], window=120)
    assert got._sub_signals(prices) == want._sub_signals(prices)
    assert got.vote(prices) == want.vote(prices)


def test_multi_strategy_emits_the_reference_s_signals():
    prices = mean_reverting(140, 10, vol=0.03)
    weights = {"momentum": 1.0, "ma_crossover": 1.0}
    got = _signals(tms, tev, "MultiStrategyManager",
                   dict(window=80, weights=weights, device="cpu"), prices)
    want = _signals(jms, jev, "MultiStrategyManager", dict(window=80, weights=weights), prices)
    assert got == want and got


def test_optimal_strategy_lookup():
    assert tms.get_optimal_strategy("zzz") == jms.get_optimal_strategy("zzz")
    tms.MultiStrategyManager.set_optimization_results({"abc": {"strategy": "rsi", "params": {}}})
    try:
        assert tms.get_optimal_strategy("ABC")["strategy"] == "rsi"
    finally:
        tms._OPTIMAL.clear()
