"""Walk-forward analysis, Monte-Carlo bootstrap, parameter sensitivity
(twin of ``pde_tpu/backtest/analysis.py``).

Rolling/anchored walk-forward with in-sample grid optimization and
out-of-sample evaluation, including the IS->OOS Sharpe decay; Monte-Carlo
resampling of strategy returns in shuffle, block and parametric modes; and
one-at-a-time parameter sensitivity.

Every in-sample window's grid is evaluated in one batched call on
``device`` (the card unless the caller names another; windows of one
length share the call), and the out-of-sample windows likewise.  All
Monte-Carlo paths are drawn and evaluated as one batched program; the
percentiles are numpy on the host, after one copy.  The draws come from a
``torch.Generator`` seeded with ``seed`` on the device, or from a draw
source passed as ``generator`` (:mod:`pde_tpu_torch.models.heston_mc`'s,
split as the reference splits its key).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.precision import blocked_cumprod, host_tensor
from ..models.heston_mc import _draws
from .metrics import performance_metrics
from .vectorized import METRICS, _grid_metrics, _metrics_rows, _positions, backtest_positions

__all__ = [
    "WalkForwardWindow",
    "WalkForwardResult",
    "WalkForwardAnalysis",
    "MonteCarloResult",
    "MonteCarloSimulator",
    "parameter_sensitivity",
]


@dataclass
class WalkForwardWindow:
    window_id: int
    is_start: int
    is_end: int
    oos_start: int
    oos_end: int
    best_params: Dict
    is_sharpe: float
    oos_sharpe: float
    oos_return: float


@dataclass
class WalkForwardResult:
    windows: List[WalkForwardWindow]
    oos_returns: np.ndarray
    oos_metrics: Dict[str, float]
    avg_is_sharpe: float
    avg_oos_sharpe: float

    @property
    def sharpe_decay(self) -> float:
        """IS->OOS degradation; > ~0.5 signals overfitting."""
        if self.avg_is_sharpe == 0:
            return 0.0
        return 1.0 - self.avg_oos_sharpe / self.avg_is_sharpe


class WalkForwardAnalysis:
    """Rolling/anchored IS-optimize -> OOS-trade analysis.

    ``signal_fn(prices, **params) -> positions`` supplies the strategy; it
    takes prices (..., n) and parameters that broadcast against the leading
    axes (the generators of :mod:`~pde_tpu_torch.backtest.vectorized` do).
    ``param_grid`` is a dict of lists.
    """

    def __init__(
        self,
        signal_fn: Callable,
        param_grid: Dict[str, Sequence],
        is_window: int = 252,
        oos_window: int = 63,
        anchored: bool = False,
        cost_per_turnover: float = 0.0005,
        metric: str = "sharpe",
        device=None,
    ):
        self.signal_fn = signal_fn
        self.param_grid = param_grid
        self.is_window = is_window
        self.oos_window = oos_window
        self.anchored = anchored
        self.cost = cost_per_turnover
        self.metric = metric
        self.device = device

    def _grid(self) -> List[Dict]:
        keys = list(self.param_grid)
        return [dict(zip(keys, combo)) for combo in itertools.product(*self.param_grid.values())]

    def run(self, prices: np.ndarray) -> WalkForwardResult:
        prices = np.asarray(prices, dtype=np.float64)
        n = len(prices)
        grid = self._grid()
        ends = [s + self.is_window for s in
                range(0, n - self.is_window - self.oos_window + 1, self.oos_window)]
        is_starts = [0 if self.anchored else e - self.is_window for e in ends]
        oos_ends = [min(e + self.oos_window, n) for e in ends]

        scored = _grid_metrics(self.signal_fn, [prices[s:e] for s, e in zip(is_starts, ends)],
                               grid, self.cost, self.device)
        best = [max(((dict(zip(METRICS, map(float, m))), params)
                     for m, params in zip(window, grid)), key=lambda sp: sp[0][self.metric])
                for window in scored]

        # signals need IS history as lookback context: generate on IS+OOS
        # and slice the OOS segment (computing them on the bare OOS window
        # would zero the first lookback-1 bars and leave a long-lookback
        # strategy flat for the whole window)
        hists = [prices[s:e] for s, e in zip(is_starts, oos_ends)]
        pos_full = _positions(self.signal_fn, hists, [b[1] for b in best], self.device)
        ks = [e - 1 - s for s, e in zip(is_starts, ends)]  # one-bar overlap for returns
        oos_prices = [h[k:] for h, k in zip(hists, ks)]
        oos_pos = [ps[k:] for ps, k in zip(pos_full, ks)]
        oos = _metrics_rows(oos_prices, oos_pos, self.cost, self.device)

        windows: List[WalkForwardWindow] = []
        oos_returns: List[np.ndarray] = []
        for wid, (s, e, oe, (best_metrics, best_params)) in enumerate(
                zip(is_starts, ends, oos_ends, best)):
            oos_metrics = dict(zip(METRICS, map(float, oos[wid])))
            ret, _ = _strategy_returns(oos_prices[wid], oos_pos[wid], self.cost)
            oos_returns.append(ret)
            windows.append(
                WalkForwardWindow(
                    window_id=wid,
                    is_start=s,
                    is_end=e,
                    oos_start=e,
                    oos_end=oe,
                    best_params=best_params,
                    is_sharpe=best_metrics["sharpe"],
                    oos_sharpe=oos_metrics["sharpe"],
                    oos_return=oos_metrics["total_return"],
                )
            )

        all_oos = np.concatenate(oos_returns) if oos_returns else np.array([])
        return WalkForwardResult(
            windows=windows,
            oos_returns=all_oos,
            oos_metrics=performance_metrics(all_oos),
            avg_is_sharpe=float(np.mean([w.is_sharpe for w in windows])) if windows else 0.0,
            avg_oos_sharpe=float(np.mean([w.oos_sharpe for w in windows])) if windows else 0.0,
        )


def _strategy_returns(prices, positions, cost):
    asset_ret = np.diff(prices) / prices[:-1]
    strat = positions[:-1] * asset_ret
    turnover = np.abs(np.diff(positions, prepend=0.0))[:-1]
    strat = strat - cost * turnover
    equity = np.concatenate([[1.0], np.cumprod(1 + strat)])
    return strat, equity


@dataclass
class MonteCarloResult:
    """Distribution of resampled outcomes."""

    n_simulations: int
    method: str
    final_equity_mean: float
    final_equity_std: float
    final_equity_percentiles: Dict[str, float]
    max_drawdown_percentiles: Dict[str, float]
    prob_loss: float
    sharpe_percentiles: Dict[str, float]
    equity_paths: Optional[np.ndarray] = None


_METHODS = ("shuffle", "block", "parametric")


class MonteCarloSimulator:
    """Bootstrap the realized strategy returns.

    Methods: 'shuffle' (iid permutation), 'block' (stationary block
    bootstrap), 'parametric' (normal fitted to the sample).  All paths are
    drawn and evaluated in one batched program on ``device``.
    """

    def __init__(self, n_simulations: int = 1000, method: str = "shuffle", block_size: int = 20,
                 seed: int = 0, device=None):
        self.n_simulations = n_simulations
        self.method = method
        self.block_size = block_size
        self.seed = seed
        self.device = device

    def run(self, returns: np.ndarray, keep_paths: bool = False,
            generator=None) -> MonteCarloResult:
        """``generator``: a ``torch.Generator`` on the device or a draw
        source; None seeds one with ``seed``."""
        if self.method not in _METHODS:
            raise ValueError(f"unknown method: {self.method}")
        r = host_tensor(np.asarray(returns, dtype=np.float64), self.device)
        n, sims = r.shape[0], self.n_simulations
        draws = _draws(torch.Generator(device=r.device).manual_seed(self.seed)
                       if generator is None else generator, r.device)

        if self.method == "shuffle":
            samples = r[draws.permutation(n, r.device, count=sims)]
        elif self.method == "block":
            # a series shorter than the block collapses to one whole-series
            # block (randint's upper bound would be <= 0 otherwise)
            block = int(min(self.block_size, n))
            n_blocks = -(-n // block)
            starts = draws.randint(0, n - block + 1, (n_blocks,), r.device, count=sims)
            idx = (starts[:, :, None] + torch.arange(block, device=r.device)).reshape(sims, -1)
            samples = r[idx[:, :n]]
        else:
            mu, sigma = torch.mean(r), torch.std(r, correction=0)
            samples = mu + sigma * draws.normal((sims, n), r.dtype, r.device)

        equity = blocked_cumprod(1.0 + samples)
        peak = torch.cummax(equity, dim=1).values
        max_dd = torch.amax(1.0 - equity / peak, dim=1)
        sharpe = (torch.mean(samples, dim=1)
                  / torch.clamp_min(torch.std(samples, dim=1, correction=0), 1e-12)
                  * math.sqrt(252.0))
        final, max_dd, sharpe = torch.stack([equity[:, -1], max_dd, sharpe]).cpu().numpy()

        pct = lambda a: {p: float(np.percentile(a, q)) for p, q in  # noqa: E731
                         [("p5", 5), ("p25", 25), ("p50", 50), ("p75", 75), ("p95", 95)]}
        return MonteCarloResult(
            n_simulations=self.n_simulations,
            method=self.method,
            final_equity_mean=float(final.mean()),
            final_equity_std=float(final.std()),
            final_equity_percentiles=pct(final),
            max_drawdown_percentiles=pct(max_dd),
            prob_loss=float(np.mean(final < 1.0)),
            sharpe_percentiles=pct(sharpe),
            equity_paths=equity.cpu().numpy() if keep_paths else None,
        )


def parameter_sensitivity(
    signal_fn: Callable,
    prices: np.ndarray,
    base_params: Dict,
    param_ranges: Dict[str, Sequence],
    cost_per_turnover: float = 0.0005,
    metric: str = "sharpe",
    device=None,
) -> Dict[str, List[Tuple[float, float]]]:
    """One-at-a-time sweeps around base parameters, on ``device``."""
    p = host_tensor(np.asarray(prices, dtype=np.float64), device)
    out: Dict[str, List[Tuple[float, float]]] = {}
    for name, values in param_ranges.items():
        rows = []
        for v in values:
            params = {**base_params, name: v}
            res = backtest_positions(p, signal_fn(p, **params), cost_per_turnover)
            rows.append((v, float(res[metric])))
        out[name] = rows
    return out
