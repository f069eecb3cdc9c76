"""Historical-scenario replay and tail-risk analysis (twin of
``pde_tpu/validation/stress_testing.py``).

MarketScenario records with built-in crisis definitions (their paths drawn
by numpy, bit for bit the reference's), the StressTestEngine (historical
replay, Monte-Carlo stress with fat tails, reverse stress search) and the
TailRiskAnalyzer.  The Monte-Carlo stress paths draw and compound as one
batched Student-t program on ``device`` (the card unless the caller names
another), from a ``torch.Generator`` seeded with ``random_state`` there or
from a draw source passed as ``generator``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.precision import blocked_cumprod, resolve_device
from ..models.heston_mc import _draws

__all__ = ["ScenarioType", "MarketScenario", "StressTestResult", "StressTestEngine", "TailRiskAnalyzer"]


class ScenarioType(str, enum.Enum):
    HISTORICAL = "historical"
    HYPOTHETICAL = "hypothetical"
    MONTE_CARLO = "monte_carlo"
    REVERSE = "reverse"


@dataclass
class MarketScenario:
    """A market shock path specification (stress_testing.py:30-58)."""

    name: str
    scenario_type: ScenarioType
    description: str = ""
    # daily shock path applied to strategy returns (e.g. crisis replay)
    return_path: Optional[np.ndarray] = None
    # or summary shocks
    equity_shock: float = 0.0
    vol_multiplier: float = 1.0
    duration_days: int = 21


# approximate daily crisis paths (drift + vol regime over the window).
# The noisy log path is RE-CENTERED so the realized compound return equals
# the declared scenario shock exactly — otherwise the named scenario would
# materially misstate its own severity (measured ~2x on the taper tantrum).
def _crisis_path(total_return: float, vol: float, days: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    log_ret = vol * rng.standard_normal(days)
    log_ret += (np.log1p(total_return) - log_ret.sum()) / days
    return np.expm1(log_ret)


BUILTIN_SCENARIOS: List[MarketScenario] = [
    MarketScenario(
        "2008_financial_crisis", ScenarioType.HISTORICAL,
        "Sep-Nov 2008 deleveraging", _crisis_path(-0.38, 0.035, 60, 1), -0.38, 3.0, 60,
    ),
    MarketScenario(
        "2020_covid_crash", ScenarioType.HISTORICAL,
        "Feb-Mar 2020 pandemic selloff", _crisis_path(-0.34, 0.045, 23, 2), -0.34, 4.0, 23,
    ),
    MarketScenario(
        "1987_black_monday", ScenarioType.HISTORICAL,
        "Oct 1987 single-day crash", _crisis_path(-0.22, 0.05, 5, 3), -0.22, 5.0, 5,
    ),
    MarketScenario(
        "2013_taper_tantrum", ScenarioType.HISTORICAL,
        "May-Jun 2013 rates shock", _crisis_path(-0.06, 0.015, 30, 4), -0.06, 1.5, 30,
    ),
]


@dataclass
class StressTestResult:
    scenario_name: str
    scenario_type: str
    total_pnl_pct: float
    max_drawdown_pct: float
    worst_day_pct: float
    days_underwater: int
    breaches_risk_limit: bool
    details: Dict[str, Any] = field(default_factory=dict)


class StressTestEngine:
    """Replay scenarios through a strategy exposure profile
    (stress_testing.py:195-444)."""

    def __init__(self, risk_limit_drawdown: float = 0.25, random_state: int = 42, device=None):
        self.scenarios: Dict[str, MarketScenario] = {s.name: s for s in BUILTIN_SCENARIOS}
        self.risk_limit_drawdown = risk_limit_drawdown
        self.random_state = random_state
        self.device = device

    def add_scenario(self, scenario: MarketScenario) -> None:
        self.scenarios[scenario.name] = scenario

    def run_historical_scenario(
        self, scenario_name: str, beta: float = 1.0, base_vol_daily: float = 0.0
    ) -> StressTestResult:
        """Apply a crisis return path scaled by the strategy's market beta."""
        sc = self.scenarios[scenario_name]
        path = np.asarray(sc.return_path) * beta
        if base_vol_daily > 0.0:
            # idiosyncratic (non-market) strategy vol layered on the
            # beta-scaled crisis path
            rng = np.random.default_rng(self.random_state)
            path = path + base_vol_daily * rng.standard_normal(len(path))
        return self._metrics(sc, path)

    def run_all_historical_scenarios(self, beta: float = 1.0) -> Dict[str, StressTestResult]:
        return {
            name: self.run_historical_scenario(name, beta)
            for name, sc in self.scenarios.items()
            if sc.scenario_type == ScenarioType.HISTORICAL
        }

    def run_monte_carlo_stress(
        self,
        daily_vol: float,
        n_days: int = 63,
        n_paths: int = 2000,
        t_dof: float = 4.0,
        vol_multiplier: float = 2.0,
        generator=None,
    ) -> Dict[str, Any]:
        """Fat-tailed (Student-t) stressed paths as one batched draw, in
        float64 on ``device``; ``generator`` is a ``torch.Generator`` there
        or a draw source (None: one seeded with ``random_state``)."""
        dev = resolve_device(self.device)
        draws = _draws(torch.Generator(device=dev).manual_seed(self.random_state)
                       if generator is None else generator, dev)
        t = draws.student_t(t_dof, (n_paths, n_days), torch.float64, dev)
        scale = daily_vol * vol_multiplier * np.sqrt((t_dof - 2) / t_dof)
        rets = t * scale
        equity = blocked_cumprod(1.0 + rets)
        peak = torch.cummax(equity, dim=1).values
        dd, final = torch.stack([torch.amax(1.0 - equity / peak, dim=1),
                                 equity[:, -1]]).cpu().numpy()
        return {
            "n_paths": n_paths,
            "prob_breach_risk_limit": float(np.mean(dd > self.risk_limit_drawdown)),
            "expected_max_drawdown": float(dd.mean()),
            "p99_max_drawdown": float(np.percentile(dd, 99)),
            "p1_final_equity": float(np.percentile(final, 1)),
        }

    def reverse_stress_test(
        self, daily_vol: float, target_loss: float = 0.25, n_days: int = 21
    ) -> Dict[str, float]:
        """How severe must a uniform shock be to hit the target loss
        (stress_testing.py:343-393)."""
        daily_shock = 1.0 - (1.0 - target_loss) ** (1.0 / n_days)
        sigmas = daily_shock / daily_vol if daily_vol > 0 else float("inf")
        return {
            "target_loss": target_loss,
            "required_daily_shock": float(daily_shock),
            "shock_in_daily_sigmas": float(sigmas),
            "plausible": sigmas < 5.0,
        }

    def _metrics(self, sc: MarketScenario, path: np.ndarray) -> StressTestResult:
        equity = np.cumprod(1.0 + path)
        peak = np.maximum.accumulate(equity)
        dd = 1.0 - equity / peak
        return StressTestResult(
            scenario_name=sc.name,
            scenario_type=sc.scenario_type.value,
            total_pnl_pct=float((equity[-1] - 1.0) * 100),
            max_drawdown_pct=float(dd.max() * 100),
            worst_day_pct=float(path.min() * 100),
            days_underwater=int((dd > 0).sum()),
            breaches_risk_limit=bool(dd.max() > self.risk_limit_drawdown),
            details={"duration_days": sc.duration_days},
        )


class TailRiskAnalyzer:
    """Empirical tail diagnostics (stress_testing.py:445-558)."""

    def analyze(self, returns: np.ndarray) -> Dict[str, float]:
        from scipy import stats as sp_stats

        r = np.asarray(returns, dtype=np.float64)
        q01, q05 = np.percentile(r, [1, 5])
        left_tail = r[r <= q05]
        return {
            "skewness": float(sp_stats.skew(r)),
            "excess_kurtosis": float(sp_stats.kurtosis(r)),
            "var_99_pct": float(-q01 * 100),
            "var_95_pct": float(-q05 * 100),
            "cvar_95_pct": float(-left_tail.mean() * 100) if left_tail.size else 0.0,
            "tail_ratio": float(abs(np.percentile(r, 95) / q05)) if q05 != 0 else float("inf"),
            "worst_day_pct": float(r.min() * 100),
            "prob_3sigma_day": float(np.mean(np.abs(r - r.mean()) > 3 * r.std())),
        }

    def hill_tail_index(self, returns: np.ndarray, k_fraction: float = 0.05) -> float:
        """Hill estimator on loss magnitudes; smaller = fatter tail."""
        losses = -np.asarray(returns)
        losses = np.sort(losses[losses > 0])[::-1]
        k = max(2, int(len(losses) * k_fraction))
        if len(losses) < k + 1:
            return float("nan")
        top = losses[:k]
        return float(1.0 / np.mean(np.log(top / losses[k])))
