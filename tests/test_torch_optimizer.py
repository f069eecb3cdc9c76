"""The port's strategy optimizer held against ``pde_tpu``: the RSI and
Bollinger generators, every family's grid, the per-series and per-group
searches with their checkpoints, and the rolling re-optimization.

Same seeded numpy prices through both packages in float64 (the JAX side
under ``jax_enable_x64``).  Positions and choices are equal; fitness,
Sharpe, return, drawdown and out-of-sample returns agree to 1e-12 relative
(reductions run in another order).  Series stay short and the grids
trimmed where the reference's eager scans would compile for long.
"""

import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.backtest import optimizer as jo
from pde_tpu_torch.backtest import optimizer as to
from pde_tpu_torch.backtest.vectorized import _param_column
from test_torch_backtest import mean_reverting

CPU = dict(device="cpu")
REL = dict(rtol=1e-12, atol=0.0)


def _close(a, b, rel=1e-12):
    return abs(a - b) <= rel * max(abs(a), abs(b))


def _same_fit(got, want, rel=1e-12):
    assert (got.group, got.strategy, got.params) == (want.group, want.strategy, want.params)
    for k in ("fitness", "sharpe", "total_return", "max_drawdown"):
        assert _close(getattr(got, k), getattr(want, k), rel), k


@pytest.fixture(scope="module")
def prices():
    return mean_reverting(300, 17, vol=0.025)


def test_rsi_positions_react_to_extremes():
    p = np.concatenate([np.linspace(100, 70, 40), np.linspace(70, 110, 40)])
    pos = to.rsi_positions(p, period=10, **CPU).numpy()
    assert pos[35] == 1.0 and pos[-1] == -1.0
    np.testing.assert_array_equal(pos, np.asarray(jo.rsi_positions(jnp.asarray(p), period=10)))


def test_bollinger_mean_reversion():
    base = np.full(120, 100.0)
    base[60] = 90.0  # sharp drop pierces lower band
    pos = to.bollinger_positions(base, window=20, n_std=2.0, **CPU).numpy()
    assert pos[60] == 1.0 and pos[65] == 0.0
    np.testing.assert_array_equal(
        pos, np.asarray(jo.bollinger_positions(jnp.asarray(base), window=20, n_std=2.0)))


@pytest.mark.parametrize("name", sorted(jo.STRATEGY_FAMILIES))
def test_every_grid_point_positions_like_the_reference(name, prices):
    """Each combination alone equals the reference; the batched grid call
    (prices (2, 1, n), (G,) parameter tensors) gives the same rows."""
    spec = to.STRATEGY_FAMILIES[name]
    keys = list(spec["grid"])
    grid = [dict(zip(keys, c)) for c in itertools.product(*spec["grid"].values())]
    two = np.stack([prices, prices[::-1]])
    p = torch.as_tensor(two)[:, None, :]
    batched = spec["fn"](p, **{k: _param_column([g[k] for g in grid], p)
                               for k in keys}).numpy()
    for g, params in enumerate(grid):
        want = np.asarray(jo.STRATEGY_FAMILIES[name]["fn"](jnp.asarray(prices), **params))
        assert set(np.unique(want)) <= {-1.0, 0.0, 1.0}
        np.testing.assert_array_equal(spec["fn"](torch.as_tensor(prices), **params).numpy(),
                                      want, err_msg=str(params))
        np.testing.assert_array_equal(batched[0, g], want, err_msg=str(params))


def test_optimize_series_matches_the_reference(prices):
    got = to.StrategyOptimizer(**CPU).optimize_series(prices, group="test")
    want = jo.StrategyOptimizer().optimize_series(prices, group="test")
    assert list(got) == list(want) == list(jo.STRATEGY_FAMILIES)
    for name in want:
        _same_fit(got[name], want[name])


# two families on trimmed grids (four points each)
TRIMMED = {"ma_crossover": {"short": [5, 10], "long": [40, 60]},
           "mean_reversion": {"lookback": [15, 20], "entry_z": [1.5, 2.0], "exit_z": [0.5]}}


def _trimmed(module):
    return {k: {"fn": module.STRATEGY_FAMILIES[k]["fn"], "grid": grid}
            for k, grid in TRIMMED.items()}


def _groups(n=220):
    return {"tech": {"A": mean_reverting(n, 1), "B": mean_reverting(n, 2, vol=0.03)},
            "energy": {"D": mean_reverting(n - 40, 4)}}


def test_run_optimization_matches_the_reference():
    got = to.StrategyOptimizer(_trimmed(to), **CPU).run_optimization(_groups())
    want = jo.StrategyOptimizer(_trimmed(jo)).run_optimization(_groups())
    assert list(got) == list(want)
    for g in want:
        assert list(got[g]) == list(want[g])
        for name in want[g]:
            _same_fit(got[g][name], want[g][name])
    o = to.StrategyOptimizer(_trimmed(to), **CPU)
    assert o.get_best_strategy(got, "tech") == max(got["tech"].values(), key=lambda f: f.fitness)


def test_run_optimization_equals_the_per_series_loop():
    """Every symbol of every group (two lengths) evaluated together gives
    each series' own ``optimize_series``."""
    o = to.StrategyOptimizer(**CPU)
    groups = _groups()
    rows = [p for members in groups.values() for p in members.values()]
    names = [g for g, members in groups.items() for _ in members]
    for fits, p, g in zip(o._optimize_rows(rows, names), rows, names):
        alone = o.optimize_series(p, g)
        for name in alone:
            _same_fit(fits[name], alone[name])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_load_in_either_package(writer, tmp_path):
    cache = tmp_path / "fits.json"
    mod = jo if writer == "reference" else to
    kw = {} if writer == "reference" else CPU
    res = mod.StrategyOptimizer(_trimmed(mod), cache_path=str(cache), **kw).run_optimization(
        _groups())
    assert cache.exists()
    reader = to if writer == "reference" else jo
    loaded = reader.StrategyOptimizer.load(cache)
    assert {g: {s: fr.to_dict() for s, fr in c.items()} for g, c in loaded.items()} == {
        g: {s: fr.to_dict() for s, fr in c.items()} for g, c in res.items()}
    assert type(next(iter(loaded["tech"].values()))) is reader.FitnessResult
    assert json.loads(cache.read_text())["tech"]["ma_crossover"]["group"] == "tech"


def test_nan_fitness_never_displaces_a_finite_best(prices):
    """The reference's strict ``>``: a NaN first point stays the best, a
    NaN later point never takes over (``argmax`` would let a NaN win)."""
    def tfn(p, k):
        base = to.ma_cross_positions(p, 5, 40)
        k = torch.as_tensor(k, dtype=base.dtype)[..., None]
        return base * torch.where(k == 1, torch.nan, 1.0)

    def jfn(p, k):
        base = jo.ma_cross_positions(p, 5, 40)
        return base * (jnp.nan if k == 1 else 1.0)

    for grid in ([0, 1, 2], [1, 0, 2]):
        got = to.StrategyOptimizer({"f": {"fn": tfn, "grid": {"k": grid}}},
                                   **CPU).optimize_series(prices)["f"]
        want = jo.StrategyOptimizer({"f": {"fn": jfn, "grid": {"k": grid}}}).optimize_series(
            prices)["f"]
        assert got.params == want.params
        assert np.isnan(got.fitness) == np.isnan(want.fitness)


def test_rolling_run_matches_the_reference(prices):
    kw = dict(opt_window=120, trade_window=60)
    got = to.RollingOptimizationBacktester(
        to.StrategyOptimizer(_trimmed(to), **CPU), **kw).run(prices)
    want = jo.RollingOptimizationBacktester(jo.StrategyOptimizer(_trimmed(jo)), **kw).run(prices)
    assert len(got.periods) == len(want.periods) == 3
    for g, w in zip(got.periods, want.periods):
        assert (g.period_id, g.opt_start, g.opt_end, g.trade_start, g.trade_end,
                g.chosen_strategy, g.chosen_params) == (
            w.period_id, w.opt_start, w.opt_end, w.trade_start, w.trade_end,
            w.chosen_strategy, w.chosen_params)
        assert _close(g.period_return, w.period_return)
        assert _close(g.period_sharpe, w.period_sharpe)
    np.testing.assert_allclose(got.oos_returns, want.oos_returns, **REL)
    for k, v in want.aggregate_metrics.items():
        assert _close(got.aggregate_metrics[k], v, 1e-10), k
    assert got.summary() == want.summary()


def test_rolling_run_on_a_short_series_is_empty():
    got = to.RollingOptimizationBacktester(to.StrategyOptimizer(**CPU)).run(np.ones(100))
    assert got.periods == [] and got.oos_returns.size == 0
    assert "0 periods" in got.summary()
