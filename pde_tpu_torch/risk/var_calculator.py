"""Value-at-Risk / CVaR, stress scenarios and VaR backtesting (twin of
``pde_tpu/risk/var_calculator.py``).

Parametric (delta-normal), historical and Monte-Carlo VaR with component
VaR, the crisis scenario library (2008 / COVID / Black Monday / euro crisis
/ 2022 rates / vol spike / correlation breakdown) and the Kupiec POF
backtest.  Semantics (quantile indexing, the component-VaR correlation
approximation, VaR floored at zero) are the reference's, the two methods'
different quantile indices included.

The historical P&L product and the Monte-Carlo scenarios run on ``device``
(default: the CUDA card), in the returns' float64 unless ``dtype`` says
otherwise; the sorts, quantiles, component VaR, the parametric method,
:class:`StressTester` and :class:`VaRBacktester` are numpy, as in the
reference.  The scenarios are ``mean + z L^T`` with ``L`` the Cholesky
factor of the covariance (JAX's ``multivariate_normal`` by its default
``cholesky`` method) and ``z`` standard normals from a ``torch.Generator``
seeded with ``seed`` (:func:`_mc_normals`): JAX's threefry and torch's
Philox streams differ, so the same seed draws other scenarios than the
reference's.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy import stats

from ..core.precision import cholesky_nan, host_tensor

__all__ = ["VaRMethod", "VaRResult", "StressTestResult", "VaRCalculator", "StressTester", "VaRBacktester"]


def _mc_normals(seed: int, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Standard normals of ``shape`` from a ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _mc_scenarios(mean: torch.Tensor, cov: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Correlated scenarios ``mean + z L^T``, ``L`` the lower Cholesky
    factor of ``cov`` (NaN where it is not positive definite, as
    ``jnp.linalg.cholesky``), for normals ``z`` of shape (n, d)."""
    return mean + z @ cholesky_nan(cov).T


class VaRMethod(str, enum.Enum):
    PARAMETRIC = "parametric"
    HISTORICAL = "historical"
    MONTE_CARLO = "monte_carlo"


@dataclass
class VaRResult:
    """Mirrors var_calculator.py:55-111."""

    var_95: float
    var_99: float
    cvar_95: float
    cvar_99: float
    method: str
    time_horizon: int = 1
    portfolio_value: float = 0.0
    component_var: Dict[str, float] = field(default_factory=dict)
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    @property
    def var_95_pct(self) -> float:
        return self.var_95 / self.portfolio_value if self.portfolio_value > 0 else 0.0

    @property
    def var_99_pct(self) -> float:
        return self.var_99 / self.portfolio_value if self.portfolio_value > 0 else 0.0

    def to_dict(self) -> Dict:
        return {
            "var_95": self.var_95,
            "var_99": self.var_99,
            "cvar_95": self.cvar_95,
            "cvar_99": self.cvar_99,
            "method": self.method,
            "time_horizon": self.time_horizon,
            "portfolio_value": self.portfolio_value,
            "component_var": self.component_var,
            "timestamp": self.timestamp.isoformat(),
        }


@dataclass
class StressTestResult:
    """Mirrors var_calculator.py:113-141."""

    scenario_name: str
    scenario_pnl: float
    scenario_pnl_pct: float
    portfolio_value: float
    position_impacts: Dict[str, float] = field(default_factory=dict)
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    def to_dict(self) -> Dict:
        return {
            "scenario_name": self.scenario_name,
            "scenario_pnl": self.scenario_pnl,
            "scenario_pnl_pct": self.scenario_pnl_pct,
            "portfolio_value": self.portfolio_value,
            "position_impacts": self.position_impacts,
            "timestamp": self.timestamp.isoformat(),
        }


class VaRCalculator:
    """Portfolio VaR/CVaR with three estimation methods.

    ``device`` (default: the CUDA card) and ``dtype`` (default: the
    returns' own, float64) set where and how the historical and Monte Carlo
    paths run; the parametric one is numpy, as in the reference."""

    def __init__(
        self,
        method: VaRMethod = VaRMethod.HISTORICAL,
        time_horizon: int = 1,
        n_simulations: int = 10_000,
        seed: int = 42,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        self.method = VaRMethod(method)
        self.time_horizon = time_horizon
        self.n_simulations = n_simulations
        self.seed = seed
        self.device = device
        self.dtype = dtype

    # ------------------------------------------------------------------ API

    def calculate(
        self,
        position_values: Dict[str, float],
        historical_returns: np.ndarray,
        asset_ids: Optional[List[str]] = None,
        correlation_matrix: Optional[np.ndarray] = None,
    ) -> VaRResult:
        returns = np.asarray(historical_returns, dtype=np.float64)
        if returns.ndim == 1:
            returns = returns.reshape(-1, 1)
        if asset_ids is None:
            asset_ids = list(position_values.keys())
        n_assets = min(returns.shape[1], len(asset_ids))
        values = np.array([position_values.get(a, 0.0) for a in asset_ids[:n_assets]])
        portfolio_value = float(np.sum(np.abs(values)))

        # a supplied correlation matrix (e.g. a stressed one) overrides the
        # historically estimated dependence; marginal vols stay historical.
        # HISTORICAL VaR is nonparametric over the realized joint paths, so
        # the override applies to the PARAMETRIC and MONTE_CARLO methods.
        cov_override = None
        if correlation_matrix is not None:
            corr = np.asarray(correlation_matrix, dtype=np.float64)[:n_assets, :n_assets]
            sd = returns[:, :n_assets].std(axis=0, ddof=1)
            cov_override = corr * np.outer(sd, sd)

        if self.method == VaRMethod.PARAMETRIC:
            return self._parametric(values, returns[:, :n_assets], asset_ids,
                                    portfolio_value, cov_override)
        if self.method == VaRMethod.HISTORICAL:
            return self._historical(values, returns[:, :n_assets], asset_ids, portfolio_value)
        return self._monte_carlo(values, returns[:, :n_assets], asset_ids,
                                 portfolio_value, cov_override)

    # ------------------------------------------------------------ internals

    def _parametric(self, values, returns, asset_ids, portfolio_value,
                    cov_override=None) -> VaRResult:
        """Delta-normal VaR (var_calculator.py:241-316)."""
        mean = returns.mean(axis=0)
        cov = (np.atleast_2d(cov_override) if cov_override is not None
               else np.atleast_2d(np.cov(returns, rowvar=False)))
        mu_p = float(values @ mean) * self.time_horizon
        std_p = float(np.sqrt(max(0.0, values @ cov @ values))) * np.sqrt(self.time_horizon)

        z95, z99 = stats.norm.ppf(0.95), stats.norm.ppf(0.99)
        var_95 = -mu_p + z95 * std_p
        var_99 = -mu_p + z99 * std_p
        cvar_95 = std_p * stats.norm.pdf(z95) / 0.05 - mu_p
        cvar_99 = std_p * stats.norm.pdf(z99) / 0.01 - mu_p

        # marginal component VaR: w_i (Sigma w)_i / (w' Sigma w) * VaR
        comp = {}
        denom = max(values @ cov @ values, 1e-300)
        marg = cov @ values
        for i, aid in enumerate(asset_ids[: len(values)]):
            comp[aid] = float(values[i] * marg[i] / denom * max(0.0, var_95))

        return VaRResult(
            var_95=max(0.0, var_95),
            var_99=max(0.0, var_99),
            cvar_95=max(0.0, cvar_95),
            cvar_99=max(0.0, cvar_99),
            method="parametric",
            time_horizon=self.time_horizon,
            portfolio_value=portfolio_value,
            component_var=comp,
        )

    def _historical(self, values, returns, asset_ids, portfolio_value) -> VaRResult:
        """Empirical-quantile VaR (var_calculator.py:317-381)."""
        r = host_tensor(returns, self.device, self.dtype)
        pnl = r @ torch.as_tensor(values, dtype=r.dtype, device=r.device)
        pnl = (pnl * np.sqrt(self.time_horizon)).cpu().numpy()
        srt = np.sort(pnl)
        n = len(srt)
        i95 = max(0, int(n * 0.05) - 1)
        i99 = max(0, int(n * 0.01) - 1)
        var_95 = -srt[i95]
        var_99 = -srt[i99]
        cvar_95 = -np.mean(srt[: i95 + 1])
        cvar_99 = -np.mean(srt[: i99 + 1])

        comp = self._component_by_correlation(values, returns, pnl, asset_ids, max(0.0, var_95), portfolio_value)
        return VaRResult(
            var_95=max(0.0, float(var_95)),
            var_99=max(0.0, float(var_99)),
            cvar_95=max(0.0, float(cvar_95)),
            cvar_99=max(0.0, float(cvar_99)),
            method="historical",
            time_horizon=self.time_horizon,
            portfolio_value=portfolio_value,
            component_var=comp,
        )

    def _monte_carlo(self, values, returns, asset_ids, portfolio_value,
                     cov_override=None) -> VaRResult:
        """Correlated multivariate-normal simulation on the device
        (var_calculator.py:382-469): ``n_simulations`` scenarios from
        :func:`_mc_normals`, then :func:`_mc_scenarios`."""
        n_assets = returns.shape[1]
        mean = returns.mean(axis=0) * self.time_horizon
        cov = (np.atleast_2d(cov_override) if cov_override is not None
               else np.atleast_2d(np.cov(returns, rowvar=False))) * self.time_horizon
        cov = cov + np.eye(n_assets) * 1e-8

        mean_t = host_tensor(mean, self.device, self.dtype)
        cov_t = host_tensor(cov, self.device, self.dtype)
        z = _mc_normals(self.seed, (self.n_simulations, n_assets), mean_t.dtype, mean_t.device)
        sims = _mc_scenarios(mean_t, cov_t, z)
        pnl = sims @ torch.as_tensor(values, dtype=sims.dtype, device=sims.device)
        host = torch.cat([sims, pnl[:, None]], dim=1).cpu().numpy()   # one read
        sims, pnl = host[:, :-1], host[:, -1]
        srt = np.sort(pnl)
        i95 = int(self.n_simulations * 0.05)
        i99 = int(self.n_simulations * 0.01)
        var_95 = -srt[i95]
        var_99 = -srt[i99]
        cvar_95 = -np.mean(srt[:i95]) if i95 > 0 else var_95
        cvar_99 = -np.mean(srt[:i99]) if i99 > 0 else var_99

        comp = self._component_by_correlation(
            values, sims, pnl, asset_ids, max(0.0, float(var_95)), portfolio_value
        )
        return VaRResult(
            var_95=max(0.0, float(var_95)),
            var_99=max(0.0, float(var_99)),
            cvar_95=max(0.0, float(cvar_95)),
            cvar_99=max(0.0, float(cvar_99)),
            method="monte_carlo",
            time_horizon=self.time_horizon,
            portfolio_value=portfolio_value,
            component_var=comp,
        )

    @staticmethod
    def _component_by_correlation(values, returns, pnl, asset_ids, var_95, portfolio_value):
        """|corr| * VaR * |w| / V approximation (var_calculator.py:358-380)."""
        comp = {}
        for i, aid in enumerate(asset_ids[: len(values)]):
            asset_pnl = returns[:, i] * values[i]
            if np.std(pnl) > 0 and np.std(asset_pnl) > 0:
                corr = np.corrcoef(asset_pnl, pnl)[0, 1]
                corr = 0.0 if np.isnan(corr) else corr
            else:
                corr = 0.0
            comp[aid] = float(abs(corr) * var_95 * abs(values[i]) / max(portfolio_value, 1e-300))
        return comp


class StressTester:
    """Scenario shock engine with the reference's crisis library
    (var_calculator.py:540-772)."""

    def __init__(self):
        self.scenarios: Dict[str, Dict[str, float]] = {
            "2008_financial_crisis": {
                "SPY": -0.38, "QQQ": -0.42, "IWM": -0.40, "TLT": 0.25,
                "GLD": 0.05, "HYG": -0.25, "VIX": 3.50,
            },
            "2020_covid_crash": {
                "SPY": -0.34, "QQQ": -0.28, "IWM": -0.42, "TLT": 0.15,
                "GLD": 0.08, "HYG": -0.20, "VIX": 4.00,
            },
            "1987_black_monday": {"SPY": -0.22, "QQQ": -0.22, "IWM": -0.25},
            "2011_euro_crisis": {"SPY": -0.20, "TLT": 0.15, "GLD": 0.12},
            "2022_rate_hike": {"SPY": -0.25, "QQQ": -0.33, "TLT": -0.30, "GLD": -0.05},
            "vol_spike_20pct": {"SPY": -0.10, "QQQ": -0.12, "IWM": -0.11, "TLT": -0.03},
            "correlation_breakdown": {
                "SPY": -0.15, "QQQ": -0.15, "IWM": -0.15, "TLT": -0.10, "GLD": -0.05,
            },
        }

    def add_scenario(self, name: str, shocks: Dict[str, float]) -> None:
        self.scenarios[name] = dict(shocks)

    def apply_scenario(self, portfolio: Dict[str, float], scenario_name: str) -> StressTestResult:
        if scenario_name not in self.scenarios:
            raise KeyError(f"Unknown scenario: {scenario_name}")
        return self.apply_custom_scenario(portfolio, self.scenarios[scenario_name], scenario_name)

    def apply_custom_scenario(
        self,
        portfolio: Dict[str, float],
        shocks: Dict[str, float],
        name: str = "custom",
        default_shock: float = 0.0,
    ) -> StressTestResult:
        impacts = {
            asset: value * shocks.get(asset, default_shock)
            for asset, value in portfolio.items()
        }
        pnl = float(sum(impacts.values()))
        pv = float(sum(abs(v) for v in portfolio.values()))
        return StressTestResult(
            scenario_name=name,
            scenario_pnl=pnl,
            scenario_pnl_pct=pnl / pv if pv > 0 else 0.0,
            portfolio_value=pv,
            position_impacts=impacts,
        )

    def run_all_scenarios(self, portfolio: Dict[str, float]) -> Dict[str, StressTestResult]:
        return {name: self.apply_scenario(portfolio, name) for name in self.scenarios}

    def get_worst_case(self, portfolio: Dict[str, float]) -> StressTestResult:
        results = self.run_all_scenarios(portfolio)
        return min(results.values(), key=lambda r: r.scenario_pnl)

    def summary_report(self, portfolio: Dict[str, float]) -> str:
        lines = [f"Stress test summary ({len(self.scenarios)} scenarios)"]
        for name, res in sorted(
            self.run_all_scenarios(portfolio).items(), key=lambda kv: kv[1].scenario_pnl
        ):
            lines.append(f"  {name:28s} PnL {res.scenario_pnl:>14,.0f} ({res.scenario_pnl_pct:+.1%})")
        return "\n".join(lines)


class VaRBacktester:
    """Kupiec proportion-of-failures test (var_calculator.py:774-855)."""

    @staticmethod
    def kupiec_test(
        realized_pnl: np.ndarray,
        var_forecasts: np.ndarray,
        confidence: float = 0.95,
    ) -> Dict:
        """LR_POF ~ chi2(1); H0: the VaR breach rate equals 1 - confidence."""
        pnl = np.asarray(realized_pnl, dtype=np.float64)
        var = np.asarray(var_forecasts, dtype=np.float64)
        n = len(pnl)
        breaches = pnl < -var
        x = int(np.sum(breaches))
        p = 1.0 - confidence
        phat = x / n if n else 0.0

        if x == 0:
            lr = -2.0 * n * np.log(1.0 - p)
        elif x == n:
            lr = -2.0 * n * np.log(p)
        else:
            lr = -2.0 * (
                (n - x) * np.log((1.0 - p) / (1.0 - phat)) + x * np.log(p / phat)
            )
        p_value = float(1.0 - stats.chi2.cdf(lr, df=1))
        return {
            "n_observations": n,
            "n_breaches": x,
            "breach_rate": phat,
            "expected_rate": p,
            "lr_statistic": float(lr),
            "p_value": p_value,
            "reject_model": p_value < 0.05,
        }
