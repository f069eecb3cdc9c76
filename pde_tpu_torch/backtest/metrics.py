"""Performance metrics over return series (plain numpy copy of
``pde_tpu/backtest/metrics.py``).

Formulas as the reference's: annualization by 252, Sharpe/Sortino off
annualized return minus risk-free over annualized (downside) vol, Calmar =
annualized return / max drawdown, empirical 95% VaR/CVaR.  Shared by the
vectorized backtester and the analysis tools.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = ["performance_metrics", "drawdown_stats", "equity_to_returns"]


def equity_to_returns(equities: Sequence[float]) -> np.ndarray:
    eq = np.asarray(equities, dtype=np.float64)
    prev = eq[:-1]
    ret = np.where(prev > 0, np.diff(eq) / np.where(prev > 0, prev, 1.0), 0.0)
    return ret


def drawdown_stats(equities: Sequence[float]) -> Dict[str, float]:
    eq = np.asarray(equities, dtype=np.float64)
    peak = np.maximum.accumulate(eq)
    dd = 1.0 - eq / np.maximum(peak, 1e-300)
    max_dd = float(np.max(dd)) if dd.size else 0.0
    in_dd = dd > 0
    avg_dd = float(np.mean(dd[in_dd])) if np.any(in_dd) else 0.0

    # longest consecutive run under water
    duration = longest = 0
    for flag in in_dd:
        duration = duration + 1 if flag else 0
        longest = max(longest, duration)
    return {
        "max_drawdown_pct": max_dd * 100.0,
        "avg_drawdown_pct": avg_dd * 100.0,
        "drawdown_duration_days": int(longest),
    }


def performance_metrics(
    returns: np.ndarray,
    risk_free_rate: float = 0.0,
    periods_per_year: int = 252,
) -> Dict[str, float]:
    """Sharpe/Sortino/Calmar/vol/VaR on a return series (engine.py:308-371)."""
    r = np.asarray(returns, dtype=np.float64)
    if r.size == 0:
        return {
            "total_return_pct": 0.0,
            "annualized_return_pct": 0.0,
            "volatility_pct": 0.0,
            "sharpe_ratio": 0.0,
            "sortino_ratio": 0.0,
            "calmar_ratio": 0.0,
            "var_95_pct": 0.0,
            "cvar_95_pct": 0.0,
            "max_drawdown_pct": 0.0,
        }

    equity = np.concatenate([[1.0], np.cumprod(1.0 + r)])
    total = (equity[-1] - 1.0) * 100.0
    n_years = r.size / periods_per_year
    ann = ((equity[-1]) ** (1.0 / n_years) - 1.0) * 100.0 if n_years > 0 and equity[-1] > 0 else total
    vol = float(np.std(r) * np.sqrt(periods_per_year) * 100.0)

    sharpe = (ann - risk_free_rate * 100.0) / vol if vol > 0 else 0.0
    downside = r[r < 0]
    if downside.size:
        dstd = float(np.std(downside) * np.sqrt(periods_per_year) * 100.0)
        sortino = (ann - risk_free_rate * 100.0) / dstd if dstd > 0 else 0.0
    else:
        sortino = sharpe

    dd = drawdown_stats(equity)
    calmar = ann / dd["max_drawdown_pct"] if dd["max_drawdown_pct"] > 0 else 0.0

    q5 = np.percentile(r, 5)
    tail = r[r <= q5]
    return {
        "total_return_pct": float(total),
        "annualized_return_pct": float(ann),
        "volatility_pct": vol,
        "sharpe_ratio": float(sharpe),
        "sortino_ratio": float(sortino),
        "calmar_ratio": float(calmar),
        "var_95_pct": float(-q5 * 100.0),
        "cvar_95_pct": float(-np.mean(tail) * 100.0) if tail.size else float(-q5 * 100.0),
        "max_drawdown_pct": dd["max_drawdown_pct"],
    }
