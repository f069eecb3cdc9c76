"""Performance attribution: returns, risk, Brinson, trades, factors.

Plain copy of ``pde_tpu/monitoring/attribution.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference monitoring/attribution.py: per-position return
attribution (:187-300), risk (vol) contribution (:301-400), Brinson
allocation/selection (:401-520), trade-level attribution (:521-640), factor
regression attribution (:641-715) and the PerformanceAttributionEngine
report (:716-873).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "return_attribution",
    "risk_contribution",
    "brinson_attribution",
    "trade_attribution",
    "factor_attribution",
    "PerformanceAttributionEngine",
]


def return_attribution(weights: Dict[str, float], returns: Dict[str, float]) -> Dict[str, float]:
    """Per-asset contribution w_i * r_i (attribution.py:187-300)."""
    return {k: weights.get(k, 0.0) * returns.get(k, 0.0) for k in weights}


def risk_contribution(weights: np.ndarray, cov: np.ndarray, names: List[str]) -> Dict[str, float]:
    """Marginal risk contributions w_i (Sigma w)_i / sigma_p (attribution.py:301-400)."""
    w = np.asarray(weights, dtype=np.float64)
    cov = np.asarray(cov, dtype=np.float64)
    port_var = float(w @ cov @ w)
    if port_var <= 0:
        return {n: 0.0 for n in names}
    sigma_p = np.sqrt(port_var)
    mrc = cov @ w / sigma_p
    return {n: float(w[i] * mrc[i]) for i, n in enumerate(names)}


def brinson_attribution(
    portfolio_weights: Dict[str, float],
    benchmark_weights: Dict[str, float],
    portfolio_returns: Dict[str, float],
    benchmark_returns: Dict[str, float],
) -> Dict[str, Dict[str, float]]:
    """Brinson-Fachler allocation/selection/interaction per group
    (attribution.py:401-520)."""
    groups = set(portfolio_weights) | set(benchmark_weights)
    rb_total = sum(
        benchmark_weights.get(g, 0.0) * benchmark_returns.get(g, 0.0) for g in groups
    )
    out = {}
    for g in groups:
        wp = portfolio_weights.get(g, 0.0)
        wb = benchmark_weights.get(g, 0.0)
        rp = portfolio_returns.get(g, 0.0)
        rb = benchmark_returns.get(g, 0.0)
        allocation = (wp - wb) * (rb - rb_total)
        selection = wb * (rp - rb)
        interaction = (wp - wb) * (rp - rb)
        out[g] = {
            "allocation": allocation,
            "selection": selection,
            "interaction": interaction,
            "total": allocation + selection + interaction,
        }
    return out


def trade_attribution(trades: List[Dict]) -> Dict[str, Dict[str, float]]:
    """PnL grouped by strategy/symbol with hit rates (attribution.py:521-640).

    trades: dicts with 'symbol', 'strategy', 'pnl'.
    """
    by_key: Dict[str, List[float]] = {}
    for t in trades:
        for key in (f"strategy:{t.get('strategy', 'unknown')}", f"symbol:{t['symbol']}"):
            by_key.setdefault(key, []).append(float(t["pnl"]))
    out = {}
    for key, pnls in by_key.items():
        arr = np.array(pnls)
        out[key] = {
            "total_pnl": float(arr.sum()),
            "n_trades": len(arr),
            "hit_rate": float(np.mean(arr > 0)),
            "avg_pnl": float(arr.mean()),
            "best": float(arr.max()),
            "worst": float(arr.min()),
        }
    return out


def factor_attribution(
    strategy_returns: np.ndarray, factor_returns: Dict[str, np.ndarray]
) -> Dict[str, float]:
    """OLS loadings + contribution split incl. alpha (attribution.py:641-715)."""
    y = np.asarray(strategy_returns, dtype=np.float64)
    names = list(factor_returns)
    X = np.column_stack([np.ones(len(y))] + [np.asarray(factor_returns[n])[: len(y)] for n in names])
    coeffs, *_ = np.linalg.lstsq(X, y, rcond=None)
    out = {"alpha_daily": float(coeffs[0])}
    for i, n in enumerate(names):
        beta = float(coeffs[i + 1])
        out[f"beta_{n}"] = beta
        out[f"contribution_{n}"] = float(beta * np.mean(factor_returns[n][: len(y)]))
    resid = y - X @ coeffs
    ss_tot = np.sum((y - y.mean()) ** 2)
    out["r_squared"] = float(1.0 - np.sum(resid**2) / ss_tot) if ss_tot > 0 else 0.0
    return out


class PerformanceAttributionEngine:
    """Bundled report (attribution.py:716-873)."""

    def report(
        self,
        weights: Dict[str, float],
        asset_returns: Dict[str, float],
        trades: Optional[List[Dict]] = None,
        cov: Optional[np.ndarray] = None,
        factor_returns: Optional[Dict[str, np.ndarray]] = None,
        strategy_returns: Optional[np.ndarray] = None,
    ) -> Dict:
        out: Dict = {"return_attribution": return_attribution(weights, asset_returns)}
        out["total_return"] = float(sum(out["return_attribution"].values()))
        if cov is not None:
            names = list(weights)
            out["risk_contribution"] = risk_contribution(
                np.array([weights[n] for n in names]), cov, names
            )
        if trades:
            out["trade_attribution"] = trade_attribution(trades)
        if factor_returns is not None and strategy_returns is not None:
            out["factor_attribution"] = factor_attribution(strategy_returns, factor_returns)
        return out
