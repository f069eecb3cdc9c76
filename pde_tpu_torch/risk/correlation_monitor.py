"""Pair-relationship health: rolling correlation + Engle-Granger cointegration.

Plain copy of ``pde_tpu/risk/correlation_monitor.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference risk/correlation_monitor.py: rolling short/long-window
correlations with breakdown detection (:169-300), Engle-Granger two-step
cointegration via OLS hedge ratio + ADF on residuals (:301-407), half-life
drift checks, HEALTHY/WARNING/CRITICAL/FAILED status (:408-432), batch pair
checks (:433-466) and position recommendations (:467-511).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "HealthStatus",
    "CointegrationResult",
    "CorrelationHealth",
    "CorrelationMonitorConfig",
    "CorrelationMonitor",
]


class HealthStatus(str, enum.Enum):
    HEALTHY = "healthy"
    WARNING = "warning"
    CRITICAL = "critical"
    FAILED = "failed"


@dataclass
class CointegrationResult:
    is_cointegrated: bool
    p_value: float
    test_statistic: float
    critical_values: Dict[str, float]
    hedge_ratio: float
    residual_std: float

    def to_dict(self) -> Dict:
        return dict(self.__dict__)


@dataclass
class CorrelationHealth:
    pair_name: str
    status: HealthStatus
    current_correlation: float
    historical_correlation: float
    correlation_change: float
    cointegration: Optional[CointegrationResult]
    current_half_life: float
    historical_half_life: float
    warnings: List[str]
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))


@dataclass
class CorrelationMonitorConfig:
    """Defaults match correlation_monitor.py:104-126."""

    min_correlation: float = 0.7
    correlation_drop_threshold: float = 0.15
    cointegration_p_value: float = 0.05
    max_half_life_days: float = 90.0
    half_life_increase_threshold: float = 1.5
    short_window: int = 21
    long_window: int = 63
    cointegration_window: int = 252
    check_frequency_days: int = 1


class CorrelationMonitor:
    """Detects statistical-relationship breakdown for pairs strategies."""

    def __init__(self, config: Optional[CorrelationMonitorConfig] = None):
        self.config = config or CorrelationMonitorConfig()
        self._historical_metrics: Dict[str, Dict] = {}

    # ------------------------------------------------------------------ API

    def check_pair_health(
        self,
        pair_name: str,
        asset1_prices: np.ndarray,
        asset2_prices: np.ndarray,
        current_ou_params=None,
    ) -> CorrelationHealth:
        warnings: List[str] = []
        p1 = np.asarray(asset1_prices, dtype=np.float64)
        p2 = np.asarray(asset2_prices, dtype=np.float64)
        r1 = np.diff(np.log(p1))
        r2 = np.diff(np.log(p2))

        current = self._rolling_corr(r1, r2, self.config.short_window)
        historical = self._rolling_corr(r1, r2, self.config.long_window)
        measurable = bool(np.isfinite(current) and np.isfinite(historical))
        change = current - historical if measurable else 0.0

        if not np.isfinite(current):
            warnings.append(
                "Correlation unmeasurable: insufficient or degenerate history"
            )
        elif current < self.config.min_correlation:
            warnings.append(
                f"Correlation {current:.2f} below minimum {self.config.min_correlation}"
            )
        if measurable and abs(change) > self.config.correlation_drop_threshold:
            warnings.append(
                f"Correlation changed by {change:+.2f} (from {historical:.2f} to {current:.2f})"
            )

        cointegration = None
        if len(p1) >= self.config.cointegration_window:
            cointegration = self.test_cointegration(
                p1[-self.config.cointegration_window :],
                p2[-self.config.cointegration_window :],
            )
            if not cointegration.is_cointegrated:
                warnings.append(
                    f"Cointegration test failed: p-value {cointegration.p_value:.3f}"
                )

        current_hl = historical_hl = 30.0
        if current_ou_params is not None:
            if hasattr(current_ou_params, "half_life"):
                hl = current_ou_params.half_life
                current_hl = float(hl() if callable(hl) else hl) * 252.0
            elif isinstance(current_ou_params, dict):
                current_hl = float(current_ou_params.get("half_life", 30.0))
        if pair_name in self._historical_metrics:
            historical_hl = self._historical_metrics[pair_name].get("half_life", current_hl)

        if current_hl > self.config.max_half_life_days:
            warnings.append(
                f"Half-life {current_hl:.1f} days exceeds maximum "
                f"{self.config.max_half_life_days:.0f}"
            )
        if historical_hl > 0 and current_hl / historical_hl > self.config.half_life_increase_threshold:
            warnings.append(
                f"Half-life increased {current_hl / historical_hl:.1f}x "
                f"(from {historical_hl:.1f} to {current_hl:.1f} days)"
            )

        status = self._determine_status(current, cointegration, warnings)
        self._historical_metrics[pair_name] = {
            "half_life": current_hl,
            "correlation": current,
        }

        return CorrelationHealth(
            pair_name=pair_name,
            status=status,
            current_correlation=current,
            historical_correlation=historical,
            correlation_change=change,
            cointegration=cointegration,
            current_half_life=current_hl,
            historical_half_life=historical_hl,
            warnings=warnings,
        )

    def check_all_pairs(self, pairs: Dict[str, Dict]) -> Dict[str, CorrelationHealth]:
        """pairs: {name: {asset1_prices, asset2_prices, current_ou_params?}}."""
        return {
            name: self.check_pair_health(pair_name=name, **kwargs)
            for name, kwargs in pairs.items()
        }

    def get_position_recommendations(
        self, healths: Dict[str, CorrelationHealth]
    ) -> Dict[str, str]:
        """Status -> action map (correlation_monitor.py:467-511)."""
        actions = {
            HealthStatus.HEALTHY: "maintain",
            HealthStatus.WARNING: "reduce",
            HealthStatus.CRITICAL: "close",
            HealthStatus.FAILED: "close_immediately",
        }
        return {name: actions[h.status] for name, h in healths.items()}

    # ------------------------------------------------------------ internals

    @staticmethod
    def _rolling_corr(r1: np.ndarray, r2: np.ndarray, window: int) -> float:
        """NaN (NOT 0.0) when the correlation is unmeasurable — too little
        history or a degenerate series.  0.0 is a real measurement that
        reads as a broken pair and escalates to CRITICAL/'close'; absence
        of evidence must stay distinguishable from evidence of breakdown."""
        n = min(len(r1), len(r2), window)
        if n < 3:
            return float("nan")
        a, b = r1[-n:], r2[-n:]
        if np.std(a) == 0 or np.std(b) == 0:
            return float("nan")
        return float(np.corrcoef(a, b)[0, 1])

    def test_cointegration(self, p1: np.ndarray, p2: np.ndarray) -> CointegrationResult:
        """Engle-Granger two-step: OLS hedge ratio then ADF on residuals
        (correlation_monitor.py:301-407)."""
        X = np.column_stack([np.ones(len(p2)), p2])
        coeffs = np.linalg.lstsq(X, p1, rcond=None)[0]
        beta = float(coeffs[1])
        resid = p1 - X @ coeffs

        stat, p_value = self._adf(resid)
        critical = {"1%": -3.90, "5%": -3.34, "10%": -3.05}  # EG residual CVs
        return CointegrationResult(
            is_cointegrated=p_value < self.config.cointegration_p_value,
            p_value=p_value,
            test_statistic=stat,
            critical_values=critical,
            hedge_ratio=beta,
            residual_std=float(np.std(resid)),
        )

    @staticmethod
    def _adf(x: np.ndarray):
        """ADF regression d x_t = a + rho x_{t-1} + e; p-value from an
        interpolation of MacKinnon critical values for EG residuals
        (mirrors the reference's pure-numpy approximation)."""
        dx = np.diff(x)
        lag = x[:-1]
        X = np.column_stack([np.ones(len(dx)), lag])
        coeffs, *_ = np.linalg.lstsq(X, dx, rcond=None)
        resid = dx - X @ coeffs
        se = np.sqrt(np.sum(resid**2) / (len(dx) - 2))
        denom = np.sqrt(np.sum((lag - lag.mean()) ** 2))
        t_stat = float(coeffs[1] / (se / denom)) if denom > 0 and se > 0 else 0.0

        # crude p-value interpolation over EG residual critical values
        cvs = [(-3.90, 0.01), (-3.34, 0.05), (-3.05, 0.10), (-2.57, 0.25)]
        if t_stat <= cvs[0][0]:
            p = 0.005
        elif t_stat >= cvs[-1][0]:
            p = 0.5
        else:
            p = 0.5
            for (c1, p1v), (c2, p2v) in zip(cvs[:-1], cvs[1:]):
                if c1 <= t_stat <= c2:
                    w = (t_stat - c1) / (c2 - c1)
                    p = p1v + w * (p2v - p1v)
                    break
        return t_stat, float(p)

    def _determine_status(self, corr, coint, warnings) -> HealthStatus:
        if coint is not None and not coint.is_cointegrated and corr < self.config.min_correlation:
            return HealthStatus.FAILED
        if coint is not None and not coint.is_cointegrated:
            return HealthStatus.CRITICAL
        if not np.isfinite(corr):
            # unmeasurable is a data problem, not a broken pair: hold at
            # WARNING ('reduce') instead of CRITICAL ('close')
            return HealthStatus.WARNING
        if corr < self.config.min_correlation:
            return HealthStatus.CRITICAL
        if warnings:
            return HealthStatus.WARNING
        return HealthStatus.HEALTHY
