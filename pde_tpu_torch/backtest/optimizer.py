"""Strategy/parameter optimization: per-group fitness search and rolling
re-optimization (twin of ``pde_tpu/backtest/optimizer.py``).

The five sub-signal families (momentum, MA crossover, mean reversion, RSI,
Bollinger) are vectorized position generators with named parameter grids.
A family's ``fn(prices, **params)`` takes prices (..., n) and parameters
that broadcast against the leading axes (numbers or tensors), so a search
evaluates each family's whole grid over every series of one length in one
batched call on ``device`` (the card unless the caller names another) and
pulls its metrics in one copy.  The choice stays on the host in Python
floats, with the reference's rules: a strict ``fitness > best.fitness``
(the first grid point wins ties, and a NaN never displaces a finite best)
and Python's ``max`` (the first wins).

:meth:`StrategyOptimizer.run_optimization` evaluates all the groups'
symbols together (one call per family and series length);
:class:`RollingOptimizationBacktester` evaluates all its optimization
windows together, then each chosen family's trade windows together.  Each
result equals the reference's per-series loop.  Checkpoints are the
reference's JSON, readable by either package.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .metrics import performance_metrics
from .vectorized import (
    METRICS,
    _affine_scan,
    _col,
    _forward_fill,
    _gather_lagged,
    _grid_metrics,
    _level,
    _metrics_rows,
    _positions,
    _prices,
    _walk3,
    _window,
    ma_cross_positions,
    momentum_positions,
    zscore_positions,
)
from ..core.precision import blocked_cumsum

__all__ = [
    "rsi_positions",
    "bollinger_positions",
    "STRATEGY_FAMILIES",
    "FitnessResult",
    "StrategyOptimizer",
    "RollingOptimizationBacktester",
    "PeriodResult",
    "RollingBacktestResults",
]


# --------------------------------------------------------------------------
# additional signal families


def rsi_positions(prices, period=14, oversold=30.0, overbought=70.0, device=None):
    """RSI band positions: long below oversold, short above overbought,
    hold otherwise; flat for the first ``period`` bars."""
    p = _prices(prices, device)
    delta = torch.diff(p, prepend=p[..., :1])
    gain = torch.clamp_min(delta, 0.0)
    loss = torch.clamp_min(-delta, 0.0)

    per = _window(period, p)
    alpha = _col(1.0 / per.to(p.dtype))
    avg_gain = _affine_scan(alpha * gain, 1.0 - alpha)
    avg_loss = _affine_scan(alpha * loss, 1.0 - alpha)
    rs = avg_gain / torch.clamp_min(avg_loss, 1e-12)
    rsi = 100.0 - 100.0 / (1.0 + rs)

    warm = torch.arange(p.shape[-1], device=p.device) < _col(per)
    low, high = rsi < _col(_level(oversold, p)), rsi > _col(_level(overbought, p))
    value = torch.where(low, 1.0, -1.0).to(p.dtype)
    return _forward_fill(warm | low | high, torch.where(warm, torch.zeros_like(value), value))


def bollinger_positions(prices, window=20, n_std=2.0, device=None):
    """Bollinger band mean reversion: long under the lower band, short over
    the upper, flat at the middle."""
    p = _prices(prices, device)
    idx = torch.arange(p.shape[-1], device=p.device)
    w = _col(_window(window, p))
    csum = blocked_cumsum(p)
    csum2 = blocked_cumsum(p * p)
    back = (idx - w).clamp_min(0)
    lag, lag2 = _gather_lagged(csum, back), _gather_lagged(csum2, back)
    wsum = csum - torch.where(idx >= w, lag, torch.zeros_like(lag))
    wsum2 = csum2 - torch.where(idx >= w, lag2, torch.zeros_like(lag2))
    count = torch.minimum(idx + 1, w)
    mean = wsum / count
    var = torch.clamp_min(wsum2 / count - mean * mean, 0.0)
    std = torch.sqrt(var)
    k = _col(_level(n_std, p))
    upper = mean + k * std
    lower = mean - k * std
    warm = idx < w - 1
    p = p.expand(mean.shape)

    def step(state):
        new = torch.where(p < lower, 1, state)
        new = torch.where(p > upper, -1, new)
        if state == 1:
            new = torch.where(p >= mean, 0, new)
        elif state == -1:
            new = torch.where(p <= mean, 0, new)
        return torch.where(warm, 0, new)

    return _walk3(step).to(p.dtype)


# strategy families with default parameter grids
STRATEGY_FAMILIES: Dict[str, Dict[str, Any]] = {
    "momentum": {
        "fn": lambda p, lookback, holding: momentum_positions(p, lookback, holding),
        "grid": {"lookback": [20, 40, 60], "holding": [5, 10, 20]},
    },
    "ma_crossover": {
        "fn": lambda p, short, long: ma_cross_positions(p, short, long),
        "grid": {"short": [5, 10, 20], "long": [40, 60, 100]},
    },
    "mean_reversion": {
        "fn": lambda p, lookback, entry_z, exit_z: zscore_positions(p, lookback, entry_z, exit_z),
        "grid": {"lookback": [15, 20, 30], "entry_z": [1.5, 2.0, 2.5], "exit_z": [0.5]},
    },
    "rsi": {
        "fn": lambda p, period, oversold, overbought: rsi_positions(p, period, oversold, overbought),
        "grid": {"period": [7, 14, 21], "oversold": [25.0, 30.0], "overbought": [70.0, 75.0]},
    },
    "bollinger": {
        "fn": lambda p, window, n_std: bollinger_positions(p, window, n_std),
        "grid": {"window": [15, 20, 30], "n_std": [1.5, 2.0, 2.5]},
    },
}


@dataclass
class FitnessResult:
    """Best configuration for one (group, strategy) cell."""

    group: str
    strategy: str
    params: Dict[str, Any]
    fitness: float
    sharpe: float
    total_return: float
    max_drawdown: float

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


_SHARPE, _TOTAL, _DD = (METRICS.index(k) for k in ("sharpe", "total_return", "max_drawdown"))


class StrategyOptimizer:
    """Per-group strategy x parameter-grid search with JSON checkpoints.

    Groups are any {name: {symbol: prices}} partition (sectors, industries,
    single names).  Fitness = sharpe - drawdown_penalty * max_dd.
    """

    def __init__(
        self,
        strategies: Optional[Dict[str, Dict]] = None,
        cost_per_turnover: float = 0.0005,
        drawdown_penalty: float = 1.0,
        cache_path: Optional[str] = None,
        device=None,
    ):
        self.strategies = strategies or STRATEGY_FAMILIES
        self.cost = cost_per_turnover
        self.drawdown_penalty = drawdown_penalty
        self.cache_path = Path(cache_path) if cache_path else None
        self.device = device

    def _optimize_rows(self, rows: Sequence[np.ndarray],
                       groups: Sequence[str]) -> List[Dict[str, FitnessResult]]:
        """:meth:`optimize_series` of every row (row i in ``groups[i]``):
        each family's grid over every row of one length in one call."""
        rows = [np.asarray(r, dtype=np.float64) for r in rows]
        out: List[Dict[str, FitnessResult]] = [{} for _ in rows]
        for name, spec in self.strategies.items():
            keys = list(spec["grid"])
            grid = [dict(zip(keys, combo)) for combo in itertools.product(*spec["grid"].values())]
            metrics = _grid_metrics(spec["fn"], rows, grid, self.cost, self.device)
            for i, row_metrics in enumerate(metrics):
                best = None
                for params, res in zip(grid, row_metrics):
                    sharpe = float(res[_SHARPE])
                    dd = float(res[_DD])
                    fitness = sharpe - self.drawdown_penalty * dd
                    if best is None or fitness > best.fitness:
                        best = FitnessResult(group=groups[i], strategy=name, params=params,
                                             fitness=fitness, sharpe=sharpe,
                                             total_return=float(res[_TOTAL]), max_drawdown=dd)
                out[i][name] = best
        return out

    def optimize_series(self, prices: np.ndarray, group: str = "default") -> Dict[str, FitnessResult]:
        """Search every strategy family's grid on one price series."""
        return self._optimize_rows([prices], [group])[0]

    def run_optimization(self, groups: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, Dict[str, FitnessResult]]:
        """groups: {group_name: {symbol: prices}}.  Per-group results are
        averaged over the group's symbols, then checkpointed."""
        names = [g for g, members in groups.items() for _ in members]
        fits = iter(self._optimize_rows(
            [p for members in groups.values() for p in members.values()], names))
        results: Dict[str, Dict[str, FitnessResult]] = {}
        for group, members in groups.items():
            per_strategy: Dict[str, List[FitnessResult]] = {}
            for _ in members:
                for name, fr in next(fits).items():
                    per_strategy.setdefault(name, []).append(fr)
            merged = {}
            for name, frs in per_strategy.items():
                best = max(frs, key=lambda f: f.fitness)
                avg_fitness = float(np.mean([f.fitness for f in frs]))
                merged[name] = FitnessResult(
                    group=group,
                    strategy=name,
                    params=best.params,
                    fitness=avg_fitness,
                    sharpe=float(np.mean([f.sharpe for f in frs])),
                    total_return=float(np.mean([f.total_return for f in frs])),
                    max_drawdown=float(np.mean([f.max_drawdown for f in frs])),
                )
            results[group] = merged
        if self.cache_path:
            self.save(results, self.cache_path)
        return results

    def get_best_strategy(self, results: Dict[str, Dict[str, FitnessResult]], group: str) -> FitnessResult:
        return max(results[group].values(), key=lambda f: f.fitness)

    @staticmethod
    def save(results: Dict[str, Dict[str, FitnessResult]], path) -> None:
        payload = {
            g: {s: fr.to_dict() for s, fr in cells.items()} for g, cells in results.items()
        }
        Path(path).write_text(json.dumps(payload, indent=1))

    @staticmethod
    def load(path) -> Dict[str, Dict[str, FitnessResult]]:
        payload = json.loads(Path(path).read_text())
        return {
            g: {s: FitnessResult(**fr) for s, fr in cells.items()}
            for g, cells in payload.items()
        }


@dataclass
class PeriodResult:
    """One optimize->trade period."""

    period_id: int
    opt_start: int
    opt_end: int
    trade_start: int
    trade_end: int
    chosen_strategy: str
    chosen_params: Dict[str, Any]
    period_return: float
    period_sharpe: float


@dataclass
class RollingBacktestResults:
    """Aggregate of all periods."""

    periods: List[PeriodResult] = field(default_factory=list)
    oos_returns: np.ndarray = field(default_factory=lambda: np.array([]))
    aggregate_metrics: Dict[str, float] = field(default_factory=dict)

    def summary(self) -> str:
        m = self.aggregate_metrics
        return (
            f"Rolling backtest: {len(self.periods)} periods, "
            f"total {m.get('total_return_pct', 0):.2f}%, "
            f"sharpe {m.get('sharpe_ratio', 0):.2f}, "
            f"max dd {m.get('max_drawdown_pct', 0):.2f}%"
        )


class RollingOptimizationBacktester:
    """Optimize on window N, trade window N+1.

    Every optimization window is searched in the same batched calls, and
    the trade windows of the periods that chose one family are positioned
    in one call, on the optimizer's device."""

    def __init__(
        self,
        optimizer: Optional[StrategyOptimizer] = None,
        opt_window: int = 252,
        trade_window: int = 63,
        cost_per_turnover: float = 0.0005,
    ):
        self.optimizer = optimizer or StrategyOptimizer()
        self.opt_window = opt_window
        self.trade_window = trade_window
        self.cost = cost_per_turnover

    def run(self, prices: np.ndarray) -> RollingBacktestResults:
        from .analysis import _strategy_returns

        prices = np.asarray(prices, dtype=np.float64)
        n = len(prices)
        starts = list(range(0, n - self.opt_window - self.trade_window + 1, self.trade_window))
        fits = self.optimizer._optimize_rows(
            [prices[s:s + self.opt_window] for s in starts], ["default"] * len(starts))
        best = [max(f.values(), key=lambda f: f.fitness) for f in fits]

        # signals use the optimization window as lookback context; only the
        # out-of-sample slice is traded (signals on the bare trade window
        # would stay flat until the lookback fills)
        hists = [prices[s:min(s + self.opt_window + self.trade_window, n)] for s in starts]
        pos_full: List[np.ndarray] = [None] * len(starts)
        for name in dict.fromkeys(b.strategy for b in best):
            picks = [i for i, b in enumerate(best) if b.strategy == name]
            pos = _positions(self.optimizer.strategies[name]["fn"], [hists[i] for i in picks],
                             [best[i].params for i in picks], self.optimizer.device)
            for i, ps in zip(picks, pos):
                pos_full[i] = ps
        k = self.opt_window - 1
        trade_prices = [h[k:] for h in hists]
        trade_pos = [ps[k:] for ps in pos_full]
        res = _metrics_rows(trade_prices, trade_pos, self.cost, self.optimizer.device)

        periods: List[PeriodResult] = []
        oos: List[np.ndarray] = []
        for pid, (start, b) in enumerate(zip(starts, best)):
            strat_ret, _ = _strategy_returns(trade_prices[pid], trade_pos[pid], self.cost)
            oos.append(strat_ret)
            periods.append(
                PeriodResult(
                    period_id=pid,
                    opt_start=start,
                    opt_end=start + self.opt_window,
                    trade_start=start + self.opt_window,
                    trade_end=min(start + self.opt_window + self.trade_window, n),
                    chosen_strategy=b.strategy,
                    chosen_params=b.params,
                    period_return=float(res[pid, _TOTAL]),
                    period_sharpe=float(res[pid, _SHARPE]),
                )
            )

        all_oos = np.concatenate(oos) if oos else np.array([])
        return RollingBacktestResults(
            periods=periods,
            oos_returns=all_oos,
            aggregate_metrics=performance_metrics(all_oos),
        )
