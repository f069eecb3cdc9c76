"""Strategy statistical validation: significance, overfitting, bootstrap
(twin of ``pde_tpu/validation/statistical_tests.py``).

Return/Sharpe significance tests, normality and strategy comparison, the
deflated Sharpe ratio and probability-of-backtest-overfitting detectors
(after Bailey & Lopez de Prado): scipy on the host, as in the reference.
The bootstrap draws and evaluates all its resamples as one batched program
on ``device`` (the card unless the caller names another), from a
``torch.Generator`` seeded with ``random_state`` there or from a draw
source passed as ``generator``; its percentiles are numpy on the host.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import math

import numpy as np
import torch
from scipy import stats

from ..core.precision import blocked_cumprod, host_tensor
from ..models.heston_mc import _draws

__all__ = [
    "TestResult",
    "StatisticalTestResult",
    "StrategyStatisticalTests",
    "OverfittingDetector",
    "BootstrapAnalysis",
]


class TestResult(str, enum.Enum):
    SIGNIFICANT = "significant"
    NOT_SIGNIFICANT = "not_significant"
    INCONCLUSIVE = "inconclusive"


@dataclass
class StatisticalTestResult:
    test_name: str
    result: TestResult
    statistic: float
    p_value: float
    confidence_level: float
    details: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["result"] = self.result.value
        return d


class StrategyStatisticalTests:
    """Significance testing for strategy return series."""

    def __init__(self, confidence_level: float = 0.95):
        self.confidence_level = confidence_level
        self.alpha = 1.0 - confidence_level

    def test_returns_significance(self, returns: np.ndarray) -> StatisticalTestResult:
        """One-sample t-test of mean return > 0 (statistical_tests.py:75-123)."""
        r = np.asarray(returns, dtype=np.float64)
        t_stat, p_two = stats.ttest_1samp(r, 0.0)
        p_one = p_two / 2.0 if t_stat > 0 else 1.0 - p_two / 2.0
        return StatisticalTestResult(
            test_name="returns_significance",
            result=TestResult.SIGNIFICANT if p_one < self.alpha else TestResult.NOT_SIGNIFICANT,
            statistic=float(t_stat),
            p_value=float(p_one),
            confidence_level=self.confidence_level,
            details={"mean_daily": float(r.mean()), "n": len(r)},
        )

    def test_sharpe_significance(
        self, returns: np.ndarray, benchmark_sharpe: float = 0.0
    ) -> StatisticalTestResult:
        """Sharpe t-test with the Lo (2002) standard error incl. skew/kurtosis
        correction (statistical_tests.py:124-195)."""
        r = np.asarray(returns, dtype=np.float64)
        n = len(r)
        sr = r.mean() / r.std(ddof=1) if r.std(ddof=1) > 0 else 0.0
        skew = stats.skew(r)
        kurt = stats.kurtosis(r)  # excess
        se = np.sqrt((1.0 + 0.5 * sr**2 - skew * sr + (kurt / 4.0) * sr**2) / n)
        bench_daily = benchmark_sharpe / np.sqrt(252.0)
        z = (sr - bench_daily) / se if se > 0 else 0.0
        p = float(1.0 - stats.norm.cdf(z))
        return StatisticalTestResult(
            test_name="sharpe_significance",
            result=TestResult.SIGNIFICANT if p < self.alpha else TestResult.NOT_SIGNIFICANT,
            statistic=float(z),
            p_value=p,
            confidence_level=self.confidence_level,
            details={"sharpe_annualized": float(sr * np.sqrt(252.0)), "se": float(se)},
        )

    def test_returns_normality(self, returns: np.ndarray) -> StatisticalTestResult:
        """Jarque-Bera (statistical_tests.py:196-239)."""
        jb, p = stats.jarque_bera(np.asarray(returns, dtype=np.float64))
        return StatisticalTestResult(
            test_name="returns_normality",
            result=TestResult.SIGNIFICANT if p < self.alpha else TestResult.NOT_SIGNIFICANT,
            statistic=float(jb),
            p_value=float(p),
            confidence_level=self.confidence_level,
            details={"interpretation": "significant = reject normality"},
        )

    def test_strategy_comparison(
        self, returns_a: np.ndarray, returns_b: np.ndarray
    ) -> StatisticalTestResult:
        """Paired t-test of A - B daily returns (statistical_tests.py:240-294)."""
        a = np.asarray(returns_a, dtype=np.float64)
        b = np.asarray(returns_b, dtype=np.float64)
        n = min(len(a), len(b))
        t_stat, p = stats.ttest_rel(a[:n], b[:n])
        return StatisticalTestResult(
            test_name="strategy_comparison",
            result=TestResult.SIGNIFICANT if p < self.alpha else TestResult.NOT_SIGNIFICANT,
            statistic=float(t_stat),
            p_value=float(p),
            confidence_level=self.confidence_level,
            details={"mean_diff_daily": float(np.mean(a[:n] - b[:n]))},
        )

    def test_information_coefficient(
        self, predictions: np.ndarray, outcomes: np.ndarray
    ) -> StatisticalTestResult:
        """Spearman IC significance (statistical_tests.py:295-337)."""
        ic, p = stats.spearmanr(predictions, outcomes)
        return StatisticalTestResult(
            test_name="information_coefficient",
            result=TestResult.SIGNIFICANT if p < self.alpha else TestResult.NOT_SIGNIFICANT,
            statistic=float(ic),
            p_value=float(p),
            confidence_level=self.confidence_level,
        )

    def test_regime_stability(self, returns: np.ndarray, n_regimes: int = 3) -> StatisticalTestResult:
        """ANOVA across equal-length sub-periods (statistical_tests.py:338-389)."""
        r = np.asarray(returns, dtype=np.float64)
        chunks = np.array_split(r, n_regimes)
        f_stat, p = stats.f_oneway(*chunks)
        return StatisticalTestResult(
            test_name="regime_stability",
            result=TestResult.NOT_SIGNIFICANT if p < self.alpha else TestResult.SIGNIFICANT,
            statistic=float(f_stat),
            p_value=float(p),
            confidence_level=self.confidence_level,
            details={"interpretation": "significant = stable across regimes"},
        )


class OverfittingDetector:
    """Backtest-overfitting diagnostics (statistical_tests.py:403-588)."""

    def __init__(self, significance_level: float = 0.05):
        self.significance_level = significance_level

    def deflated_sharpe_ratio(
        self,
        observed_sharpe: float,
        n_trials: int,
        n_observations: int,
        skewness: float = 0.0,
        kurtosis: float = 3.0,
        sharpe_variance: Optional[float] = None,
    ) -> Dict[str, float]:
        """DSR after Bailey & Lopez de Prado (2014): probability the observed
        (daily) Sharpe exceeds the expected max of n_trials noise Sharpes."""
        if sharpe_variance is None:
            sharpe_variance = 1.0 / n_observations
        emc = 0.5772156649015329
        max_z = (1 - emc) * stats.norm.ppf(1 - 1.0 / n_trials) + emc * stats.norm.ppf(
            1 - 1.0 / (n_trials * np.e)
        )
        sr0 = np.sqrt(sharpe_variance) * max_z  # expected max noise Sharpe
        denom = np.sqrt(
            max(1e-12, 1 - skewness * observed_sharpe + (kurtosis - 1) / 4.0 * observed_sharpe**2)
        )
        z = (observed_sharpe - sr0) * np.sqrt(n_observations - 1) / denom
        dsr = float(stats.norm.cdf(z))
        return {
            "deflated_sharpe_ratio": dsr,
            "expected_max_noise_sharpe": float(sr0),
            "is_significant": dsr > 1 - self.significance_level,
        }

    def probability_of_backtest_overfitting(
        self, is_metrics: np.ndarray, oos_metrics: np.ndarray
    ) -> Dict[str, float]:
        """PBO: how often the IS-best config underperforms the OOS median
        (statistical_tests.py:469-514).  Inputs: (n_splits, n_configs)."""
        is_m = np.atleast_2d(is_metrics)
        oos_m = np.atleast_2d(oos_metrics)
        n_splits = is_m.shape[0]
        below_median = 0
        for s in range(n_splits):
            best = int(np.argmax(is_m[s]))
            rank = stats.rankdata(oos_m[s])[best] / (oos_m.shape[1] + 1)
            if rank <= 0.5:
                below_median += 1
        pbo = below_median / n_splits
        return {"pbo": float(pbo), "is_overfit": pbo > 0.5, "n_splits": n_splits}

    def is_oos_degradation(self, is_sharpe: float, oos_sharpe: float) -> Dict[str, float]:
        # degrade relative to |IS|: the naive 1 - oos/is flips sign for a
        # negative IS metric and would PASS a strategy that collapses OOS
        denom = max(abs(is_sharpe), 1e-12)
        decay = (is_sharpe - oos_sharpe) / denom
        return {"sharpe_decay": float(decay), "suspicious": decay > 0.5}


class BootstrapAnalysis:
    """Batched bootstrap CIs on ``device``."""

    def __init__(self, n_bootstrap: int = 1000, random_state: int = 42, device=None):
        self.n_bootstrap = n_bootstrap
        self.random_state = random_state
        self.device = device

    def _resample(self, returns: np.ndarray, generator=None) -> torch.Tensor:
        """(n_bootstrap, n) resamples with replacement; ``generator`` is a
        ``torch.Generator`` on the device or a draw source (None: one
        seeded with ``random_state``, so every call resamples alike)."""
        r = host_tensor(np.asarray(returns, dtype=np.float64), self.device)
        draws = _draws(torch.Generator(device=r.device).manual_seed(self.random_state)
                       if generator is None else generator, r.device)
        idx = draws.randint(0, r.shape[0], (self.n_bootstrap, r.shape[0]), r.device)
        return r[idx]

    def sharpe_confidence_interval(
        self, returns: np.ndarray, confidence: float = 0.95, generator=None
    ) -> Tuple[float, float, float]:
        samples = self._resample(returns, generator)
        sr = torch.mean(samples, dim=1) / torch.clamp_min(torch.std(samples, dim=1, correction=1), 1e-12)
        sr = (sr * math.sqrt(252.0)).cpu().numpy()
        a = (1 - confidence) / 2
        point = float(np.mean(returns) / np.std(returns, ddof=1) * np.sqrt(252))
        return point, float(np.percentile(sr, a * 100)), float(np.percentile(sr, (1 - a) * 100))

    def max_drawdown_confidence_interval(
        self, returns: np.ndarray, confidence: float = 0.95, generator=None
    ) -> Tuple[float, float, float]:
        samples = self._resample(returns, generator)
        equity = blocked_cumprod(1.0 + samples)
        peak = torch.cummax(equity, dim=1).values
        dd = torch.amax(1.0 - equity / peak, dim=1).cpu().numpy()
        a = (1 - confidence) / 2
        eq = np.cumprod(1 + np.asarray(returns))
        point = float(np.max(1 - eq / np.maximum.accumulate(eq)))
        return point, float(np.percentile(dd, a * 100)), float(np.percentile(dd, (1 - a) * 100))
