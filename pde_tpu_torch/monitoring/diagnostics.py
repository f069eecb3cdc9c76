"""Model diagnostics: calibration drift, parameter stability, forecast

Plain copy of ``pde_tpu/monitoring/diagnostics.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.
accuracy, backtest-vs-live comparison.

Mirrors the reference monitoring/diagnostics.py: the calibration monitor and
PSI-style drift detector (:239-500), parameter-stability tracking (:501-610),
forecast-accuracy scoring (:611-700), the backtest-vs-live comparator
(:701-785) and the ModelDiagnosticsEngine facade with a module singleton
(:786-930).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "population_stability_index",
    "CalibrationMonitor",
    "ParameterStabilityTracker",
    "ForecastAccuracyTracker",
    "BacktestLiveComparator",
    "ModelDiagnosticsEngine",
    "get_diagnostics_engine",
]


def population_stability_index(expected: np.ndarray, actual: np.ndarray, n_bins: int = 10) -> float:
    """PSI drift score (diagnostics.py:330-400): <0.1 stable, 0.1-0.25 drift,
    >0.25 significant shift."""
    expected = np.asarray(expected, dtype=np.float64)
    actual = np.asarray(actual, dtype=np.float64)
    edges = np.quantile(expected, np.linspace(0, 1, n_bins + 1))
    edges[0], edges[-1] = -np.inf, np.inf
    e_frac = np.histogram(expected, edges)[0] / len(expected)
    a_frac = np.histogram(actual, edges)[0] / len(actual)
    e_frac = np.clip(e_frac, 1e-6, None)
    a_frac = np.clip(a_frac, 1e-6, None)
    return float(np.sum((a_frac - e_frac) * np.log(a_frac / e_frac)))


@dataclass
class CalibrationRecord:
    model: str
    underlying: str
    rmse: float
    converged: bool
    parameters: Dict[str, float]
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))


class CalibrationMonitor:
    """Tracks calibration quality over time (diagnostics.py:239-330)."""

    def __init__(self, rmse_warning: float = 0.1, history: int = 500):
        self.rmse_warning = rmse_warning
        self.records: deque = deque(maxlen=history)

    def record(self, model: str, underlying: str, rmse: float, converged: bool,
               parameters: Dict[str, float]) -> CalibrationRecord:
        rec = CalibrationRecord(model, underlying, rmse, converged, dict(parameters))
        self.records.append(rec)
        return rec

    def status(self, model: str, underlying: str) -> Dict:
        rows = [r for r in self.records if r.model == model and r.underlying == underlying]
        if not rows:
            return {"status": "unknown", "n": 0}
        rmses = np.array([r.rmse for r in rows])
        convergence_rate = float(np.mean([r.converged for r in rows]))
        latest = rows[-1]
        status = "ok"
        if latest.rmse > self.rmse_warning or not latest.converged:
            status = "warning"
        if convergence_rate < 0.5:
            status = "critical"
        return {
            "status": status,
            "n": len(rows),
            "latest_rmse": latest.rmse,
            "median_rmse": float(np.median(rmses)),
            "convergence_rate": convergence_rate,
        }


class ParameterStabilityTracker:
    """Relative day-over-day parameter jumps (diagnostics.py:501-610)."""

    def __init__(self, jump_threshold: float = 0.5, history: int = 250):
        self.jump_threshold = jump_threshold
        self._series: Dict[str, deque] = {}
        self._history = history

    def record(self, key: str, parameters: Dict[str, float]) -> List[str]:
        """Returns the names of parameters that jumped more than threshold."""
        series = self._series.setdefault(key, deque(maxlen=self._history))
        jumps = []
        if series:
            prev = series[-1]
            for name, value in parameters.items():
                if name in prev and abs(prev[name]) > 1e-12:
                    rel = abs(value - prev[name]) / abs(prev[name])
                    if rel > self.jump_threshold:
                        jumps.append(name)
        series.append(dict(parameters))
        return jumps

    def volatility(self, key: str) -> Dict[str, float]:
        """Std of relative changes per parameter."""
        series = list(self._series.get(key, []))
        if len(series) < 3:
            return {}
        out = {}
        names = series[0].keys()
        for name in names:
            vals = np.array([s[name] for s in series if name in s])
            rel = np.diff(vals) / np.clip(np.abs(vals[:-1]), 1e-12, None)
            out[name] = float(np.std(rel))
        return out


class ForecastAccuracyTracker:
    """Realized-vs-forecast scoring (diagnostics.py:611-700)."""

    def __init__(self, history: int = 500):
        self._pairs: Dict[str, deque] = {}
        self._history = history

    def record(self, key: str, forecast: float, realized: float) -> None:
        self._pairs.setdefault(key, deque(maxlen=self._history)).append((forecast, realized))

    def metrics(self, key: str) -> Dict[str, float]:
        pairs = np.array(self._pairs.get(key, []))
        if len(pairs) < 2:
            return {}
        f, r = pairs[:, 0], pairs[:, 1]
        err = f - r
        denom = np.clip(np.abs(r), 1e-12, None)
        ss_tot = np.sum((r - r.mean()) ** 2)
        return {
            "n": len(pairs),
            "mae": float(np.mean(np.abs(err))),
            "rmse": float(np.sqrt(np.mean(err**2))),
            "mape": float(np.mean(np.abs(err) / denom)),
            "bias": float(np.mean(err)),
            "r_squared": float(1.0 - np.sum(err**2) / ss_tot) if ss_tot > 0 else 0.0,
        }


class BacktestLiveComparator:
    """Live performance vs backtest expectations (diagnostics.py:701-785)."""

    def __init__(self, max_sharpe_shortfall: float = 0.5):
        self.max_sharpe_shortfall = max_sharpe_shortfall

    def compare(self, backtest_returns: np.ndarray, live_returns: np.ndarray) -> Dict:
        from scipy import stats

        bt = np.asarray(backtest_returns, dtype=np.float64)
        lv = np.asarray(live_returns, dtype=np.float64)

        def sharpe(x):
            return float(x.mean() / x.std(ddof=1) * np.sqrt(252)) if x.std(ddof=1) > 0 else 0.0

        bt_sharpe, lv_sharpe = sharpe(bt), sharpe(lv)
        shortfall = 1.0 - lv_sharpe / bt_sharpe if bt_sharpe > 0 else 0.0
        # distributional drift of live vs backtest returns
        ks_stat, ks_p = stats.ks_2samp(bt, lv) if len(lv) >= 10 else (0.0, 1.0)
        psi = population_stability_index(bt, lv) if len(lv) >= 20 else 0.0
        return {
            "backtest_sharpe": bt_sharpe,
            "live_sharpe": lv_sharpe,
            "sharpe_shortfall": float(shortfall),
            "degraded": shortfall > self.max_sharpe_shortfall,
            "ks_p_value": float(ks_p),
            "psi": psi,
            "n_live": len(lv),
        }


class ModelDiagnosticsEngine:
    """Facade bundling all diagnostics (diagnostics.py:786-930)."""

    def __init__(self):
        self.calibration = CalibrationMonitor()
        self.stability = ParameterStabilityTracker()
        self.forecasts = ForecastAccuracyTracker()
        self.live_comparator = BacktestLiveComparator()

    def record_calibration(self, model: str, underlying: str, rmse: float,
                           converged: bool, parameters: Dict[str, float]) -> Dict:
        self.calibration.record(model, underlying, rmse, converged, parameters)
        jumps = self.stability.record(f"{model}:{underlying}", parameters)
        return {
            "status": self.calibration.status(model, underlying),
            "parameter_jumps": jumps,
        }

    def report(self) -> Dict:
        models = {(r.model, r.underlying) for r in self.calibration.records}
        return {
            f"{m}:{u}": self.calibration.status(m, u) for m, u in sorted(models)
        }


_ENGINE: Optional[ModelDiagnosticsEngine] = None


def get_diagnostics_engine() -> ModelDiagnosticsEngine:
    """Module singleton (diagnostics.py:920-930)."""
    global _ENGINE
    if _ENGINE is None:
        _ENGINE = ModelDiagnosticsEngine()
    return _ENGINE
