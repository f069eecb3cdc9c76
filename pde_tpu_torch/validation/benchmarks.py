"""Benchmark comparison and alpha/beta attribution.

Plain copy of ``pde_tpu/validation/benchmarks.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference validation/benchmarks.py: the benchmark family
(buy & hold, 60/40, momentum, risk-free, equal-weight; :78-216), the
BenchmarkComparator (:217-356) and the OLS alpha/beta AlphaCalculator
(:357-516).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..backtest.metrics import performance_metrics

__all__ = [
    "BenchmarkType",
    "BenchmarkResult",
    "ComparisonReport",
    "Benchmark",
    "BuyAndHoldBenchmark",
    "SixtyFortyBenchmark",
    "MomentumBenchmark",
    "RiskFreeBenchmark",
    "EqualWeightBenchmark",
    "BenchmarkComparator",
    "AlphaCalculator",
]


class BenchmarkType(str, enum.Enum):
    BUY_AND_HOLD = "buy_and_hold"
    SIXTY_FORTY = "sixty_forty"
    MOMENTUM = "momentum"
    RISK_FREE = "risk_free"
    EQUAL_WEIGHT = "equal_weight"


@dataclass
class BenchmarkResult:
    name: str
    benchmark_type: str
    metrics: Dict[str, float]
    returns: np.ndarray


@dataclass
class ComparisonReport:
    strategy_metrics: Dict[str, float]
    benchmark_results: List[BenchmarkResult]
    excess_return_pct: Dict[str, float] = field(default_factory=dict)
    beats_benchmark: Dict[str, bool] = field(default_factory=dict)


class Benchmark:
    def __init__(self, name: str, benchmark_type: BenchmarkType):
        self.name = name
        self.benchmark_type = benchmark_type

    def calculate_returns(self, market_returns: np.ndarray, **kwargs) -> np.ndarray:
        raise NotImplementedError


class BuyAndHoldBenchmark(Benchmark):
    def __init__(self, name: str = "Buy-and-Hold"):
        super().__init__(name, BenchmarkType.BUY_AND_HOLD)

    def calculate_returns(self, market_returns, **kwargs):
        return np.asarray(market_returns, dtype=np.float64)


class SixtyFortyBenchmark(Benchmark):
    def __init__(self, name: str = "60/40", bond_returns: Optional[np.ndarray] = None):
        super().__init__(name, BenchmarkType.SIXTY_FORTY)
        self.bond_returns = bond_returns

    def calculate_returns(self, market_returns, bond_returns=None, **kwargs):
        eq = np.asarray(market_returns, dtype=np.float64)
        bonds = np.asarray(
            bond_returns if bond_returns is not None else self.bond_returns
            if self.bond_returns is not None else np.full_like(eq, 0.03 / 252)
        )
        return 0.6 * eq + 0.4 * bonds[: len(eq)]


class MomentumBenchmark(Benchmark):
    """Long when trailing return positive, flat otherwise (benchmarks.py:143-180)."""

    def __init__(self, lookback: int = 60, name: str = "Time-Series Momentum"):
        super().__init__(name, BenchmarkType.MOMENTUM)
        self.lookback = lookback

    def calculate_returns(self, market_returns, **kwargs):
        r = np.asarray(market_returns, dtype=np.float64)
        cum = np.cumprod(1 + r)
        pos = np.zeros(len(r))
        for i in range(self.lookback, len(r)):
            pos[i] = 1.0 if cum[i - 1] > cum[i - self.lookback] else 0.0
        return pos * r


class RiskFreeBenchmark(Benchmark):
    def __init__(self, annual_rate: float = 0.05, name: str = "Risk-Free"):
        super().__init__(name, BenchmarkType.RISK_FREE)
        self.annual_rate = annual_rate

    def calculate_returns(self, market_returns, **kwargs):
        n = len(market_returns)
        return np.full(n, self.annual_rate / 252.0)


class EqualWeightBenchmark(Benchmark):
    def __init__(self, name: str = "Equal-Weight"):
        super().__init__(name, BenchmarkType.EQUAL_WEIGHT)

    def calculate_returns(self, market_returns, asset_returns: Optional[np.ndarray] = None, **kwargs):
        if asset_returns is not None:
            return np.asarray(asset_returns).mean(axis=1)
        return np.asarray(market_returns, dtype=np.float64)


class BenchmarkComparator:
    """Strategy vs a panel of benchmarks (benchmarks.py:217-356)."""

    def __init__(self, benchmarks: Optional[List[Benchmark]] = None, risk_free_rate: float = 0.05):
        self.benchmarks = benchmarks or [
            BuyAndHoldBenchmark(),
            SixtyFortyBenchmark(),
            MomentumBenchmark(),
            RiskFreeBenchmark(risk_free_rate),
        ]
        self.risk_free_rate = risk_free_rate

    def compare(
        self, strategy_returns: np.ndarray, market_returns: np.ndarray, **kwargs
    ) -> ComparisonReport:
        strat = performance_metrics(np.asarray(strategy_returns), self.risk_free_rate)
        results = []
        excess = {}
        beats = {}
        for b in self.benchmarks:
            br = b.calculate_returns(market_returns, **kwargs)
            metrics = performance_metrics(br, self.risk_free_rate)
            results.append(BenchmarkResult(b.name, b.benchmark_type.value, metrics, br))
            excess[b.name] = strat["annualized_return_pct"] - metrics["annualized_return_pct"]
            beats[b.name] = strat["sharpe_ratio"] > metrics["sharpe_ratio"]
        return ComparisonReport(
            strategy_metrics=strat,
            benchmark_results=results,
            excess_return_pct=excess,
            beats_benchmark=beats,
        )


class AlphaCalculator:
    """OLS alpha/beta with t-stats and information ratio
    (benchmarks.py:357-516)."""

    def __init__(self, risk_free_rate: float = 0.05, periods_per_year: int = 252):
        self.rf_daily = risk_free_rate / periods_per_year
        self.periods_per_year = periods_per_year

    def calculate(self, strategy_returns: np.ndarray, benchmark_returns: np.ndarray) -> Dict[str, float]:
        s = np.asarray(strategy_returns, dtype=np.float64) - self.rf_daily
        b = np.asarray(benchmark_returns, dtype=np.float64) - self.rf_daily
        n = min(len(s), len(b))
        s, b = s[:n], b[:n]

        X = np.column_stack([np.ones(n), b])
        coeffs, *_ = np.linalg.lstsq(X, s, rcond=None)
        alpha_daily, beta = float(coeffs[0]), float(coeffs[1])
        resid = s - X @ coeffs
        dof = max(n - 2, 1)
        se = np.sqrt(np.sum(resid**2) / dof)
        sxx = np.sum((b - b.mean()) ** 2)
        se_alpha = se * np.sqrt(1.0 / n + b.mean() ** 2 / max(sxx, 1e-300))
        se_beta = se / np.sqrt(max(sxx, 1e-300))

        active = s - b
        te = np.std(active, ddof=1) * np.sqrt(self.periods_per_year)
        ir = (np.mean(active) * self.periods_per_year) / te if te > 0 else 0.0

        return {
            "alpha_annualized_pct": alpha_daily * self.periods_per_year * 100.0,
            "beta": beta,
            "alpha_t_stat": alpha_daily / se_alpha if se_alpha > 0 else 0.0,
            "beta_t_stat": beta / se_beta if se_beta > 0 else 0.0,
            "r_squared": float(1.0 - np.sum(resid**2) / max(np.sum((s - s.mean()) ** 2), 1e-300)),
            "tracking_error_pct": float(te * 100.0),
            "information_ratio": float(ir),
        }
