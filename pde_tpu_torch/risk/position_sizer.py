"""Volatility-managed position sizing (Moreira & Muir 2017) (twin of
``pde_tpu/risk/position_sizer.py``).

The vol estimators (realized / EWMA lambda=0.94 / GARCH(1,1) / hybrid), the
w = sigma_target^2 / sigma_realized^2 scaling clipped to [0.2, 2.0], the
linear drawdown multiplier, portfolio weights and the Kelly sizer.  The
sizers and the confidence interval are numpy, as in the reference; the
estimators' tensor paths run on ``device`` (default: the CUDA card).

Two forms differ from the reference's scans, each with the same value:

* **EWMA** is one weighted sum, not a step loop:
  ``var_m = lam^m init + (1 - lam) sum_k lam^(m-1-k) r_k^2`` over the m
  returns after the 10 that seed ``init`` (their population variance).
  :meth:`VolatilityEstimator.estimate_batch` takes a (n_assets, n_obs)
  universe in one call.
* **GARCH(1,1)**'s variance path is the closed form of its linear
  recursion, ``var_t = b^t var0 + sum_{k<t} b^(t-1-k) (omega + a r_k^2)``,
  taken as a log-depth scan: ceil(log2 n) steps, each adding the sums
  ``2^s`` places back times ``b^(2^s)`` (Hillis-Steele), where the
  reference steps n times.  The powers of b come by squaring, never by
  ``pow``, so a b near 0 (where ``b ** 0`` would have the gradient
  0 * b^-1) leaves no NaN in the gradient.  The likelihood's value and
  gradient come from ``torch.autograd.grad`` and go to scipy's L-BFGS-B as
  the reference's jitted ``value_and_grad`` does.

The fit falls back to EWMA on what the numerics raise (``ValueError``,
``ArithmeticError``, ``LinAlgError``) only, where the reference catches
every ``Exception``: a device error propagates.

``dtype=None`` keeps the returns' own precision (numpy float64 returns run
in float64), as :func:`pde_tpu_torch.core.precision.result_dtype` reads
inputs.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.precision import host_tensor

__all__ = [
    "VolatilityMethod",
    "VolatilityEstimator",
    "PositionSizeResult",
    "PositionSizerConfig",
    "VolatilityScaledPositionSizer",
    "KellyPositionSizer",
]


class VolatilityMethod(str, enum.Enum):
    REALIZED = "realized"
    EWMA = "ewma"
    GARCH = "garch"
    IMPLIED = "implied"
    HYBRID = "hybrid"


def _ewma_variance(returns: torch.Tensor, lam: float) -> torch.Tensor:
    """EWMA variance over the last axis, seeded with the population
    variance of the first 10 observations (position_sizer.py:144-166), as
    one weighted sum of the squared returns after them."""
    init_window = 10
    init = torch.var(returns[..., :init_window], dim=-1, correction=0)
    r2 = returns[..., init_window:] ** 2
    m = r2.shape[-1]
    lags = torch.arange(m - 1, -1, -1, dtype=returns.dtype, device=returns.device)
    return lam**m * init + (1.0 - lam) * torch.sum(lam**lags * r2, dim=-1)


def _garch_variance(params_vec, returns):
    """The conditional variances var_0 .. var_{n-1} of the GARCH(1,1)
    recursion var_{t+1} = omega + a r_t^2 + b var_t from var_0 = var(r), as
    a log-depth scan of the geometric prefix sums (module docstring).

    params_vec = (log omega, logit alpha, logit beta') with the
    stationarity-respecting parameterization alpha + beta < 1."""
    omega = torch.exp(params_vec[0])
    a = torch.sigmoid(params_vec[1])
    b = torch.sigmoid(params_vec[2]) * (1.0 - a) * 0.999
    var0 = torch.var(returns, correction=0)
    # var_t = sum_{j <= t} b^(t-j) y_j with y = (var0, c_0, .., c_{n-2})
    y = torch.cat([var0[None], (omega + a * returns * returns)[:-1]])
    shift, b_pow = 1, b                 # b_pow = b^shift, by squaring
    while shift < y.shape[-1]:
        y = torch.cat([y[:shift], y[shift:] + b_pow * y[:-shift]])
        shift, b_pow = 2 * shift, b_pow * b_pow
    return y


def _garch_neg_ll(params_vec, returns):
    """GARCH(1,1) negative Gaussian log-likelihood."""
    var = _garch_variance(params_vec, returns)
    lls = -0.5 * (torch.log(2.0 * math.pi * var) + returns * returns / var)
    return -torch.sum(lls)


def _garch_value_and_grad(params_vec, returns):
    """The negative log-likelihood and its gradient in ``params_vec``, by
    reverse-mode autograd."""
    x = params_vec.detach().requires_grad_(True)
    with torch.enable_grad():
        val = _garch_neg_ll(x, returns)
        (grad,) = torch.autograd.grad(val, x)
    return val.detach(), grad


class VolatilityEstimator:
    """Annualized volatility estimation (API parity with the reference).

    ``device`` (default: the CUDA card) and ``dtype`` (default: the
    returns' own) set where and how the EWMA, GARCH and batch paths run;
    the realized estimate is numpy, as in the reference."""

    def __init__(
        self,
        method: VolatilityMethod = VolatilityMethod.REALIZED,
        lookback_days: int = 21,
        ewma_lambda: float = 0.94,
        annualization_factor: float = 252.0,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        self.method = VolatilityMethod(method)
        self.lookback_days = lookback_days
        self.ewma_lambda = ewma_lambda
        self.annualization_factor = annualization_factor
        self.device = device
        self.dtype = dtype

    def estimate(self, returns, prices=None) -> float:
        returns = np.asarray(returns, dtype=np.float64)
        if prices is not None and len(returns) == 0:
            returns = np.diff(np.log(np.asarray(prices, dtype=np.float64)))
        if len(returns) < 5:
            return 0.20  # reference default on insufficient data
        if self.method == VolatilityMethod.REALIZED:
            return self._realized(returns)
        if self.method == VolatilityMethod.EWMA:
            return self._ewma(returns)
        if self.method == VolatilityMethod.GARCH:
            return self._garch(returns)
        if self.method == VolatilityMethod.HYBRID:
            return 0.5 * self._realized(returns) + 0.5 * self._ewma(returns)
        raise ValueError(f"method {self.method} needs market implied vols")

    def estimate_batch(self, returns: np.ndarray) -> np.ndarray:
        """Vol for a (n_assets, n_obs) batch — same estimator per method as
        :meth:`estimate` (REALIZED/EWMA/HYBRID in one call on the device;
        GARCH fits per row)."""
        if self.method == VolatilityMethod.GARCH:
            return np.array([self._garch(np.asarray(row)) for row in returns])
        if self.method not in (VolatilityMethod.REALIZED, VolatilityMethod.EWMA,
                               VolatilityMethod.HYBRID):
            raise ValueError(f"method {self.method} needs market implied vols")
        r = host_tensor(returns, self.device, self.dtype)

        def realized():
            lookback = min(returns.shape[-1], self.lookback_days)
            daily = torch.std(r[..., -lookback:], dim=-1, correction=1)
            return daily * math.sqrt(self.annualization_factor)

        def ewma():
            return torch.sqrt(_ewma_variance(r, self.ewma_lambda) * self.annualization_factor)

        if self.method == VolatilityMethod.REALIZED:
            vol = realized()
        elif self.method == VolatilityMethod.EWMA:
            vol = ewma()
        else:
            vol = 0.5 * realized() + 0.5 * ewma()
        return vol.cpu().numpy()

    def estimate_with_confidence(self, returns) -> Tuple[float, float, float]:
        """Point estimate + chi-squared 95% CI (position_sizer.py:224-261)."""
        from scipy import stats

        vol = self.estimate(returns)
        n = len(returns)
        if n < 10:
            return vol, vol * 0.5, vol * 2.0
        df = n - 1
        var = (vol / np.sqrt(self.annualization_factor)) ** 2
        lo = np.sqrt(df * var / stats.chi2.ppf(0.975, df) * self.annualization_factor)
        hi = np.sqrt(df * var / stats.chi2.ppf(0.025, df) * self.annualization_factor)
        return vol, float(lo), float(hi)

    # ------------------------------------------------------------ internals

    def _realized(self, returns: np.ndarray) -> float:
        lookback = min(len(returns), self.lookback_days)
        daily = np.std(returns[-lookback:], ddof=1)
        return float(daily * np.sqrt(self.annualization_factor))

    def _ewma(self, returns: np.ndarray) -> float:
        r = host_tensor(returns, self.device, self.dtype)
        var = float(_ewma_variance(r, self.ewma_lambda))
        return float(np.sqrt(var * self.annualization_factor))

    def _garch(self, returns: np.ndarray) -> float:
        """GARCH(1,1) MLE; one-step-ahead variance forecast."""
        from scipy import optimize, special

        r = host_tensor(returns * 100.0, self.device, self.dtype)  # scale for conditioning
        x0 = np.array([np.log(0.1 * float(np.var(returns * 100))), 0.0, 2.0])

        def fun_and_jac(v):
            val, g = _garch_value_and_grad(torch.as_tensor(v, dtype=r.dtype, device=r.device), r)
            host = torch.cat([val[None], g]).cpu().numpy().astype(np.float64)
            return float(host[0]), host[1:]

        try:
            res = optimize.minimize(fun_and_jac, x0, jac=True, method="L-BFGS-B")
            omega = np.exp(res.x[0])
            a = float(special.expit(res.x[1]))
            b = float(special.expit(res.x[2])) * (1.0 - a) * 0.999
            # one-step forecast from the filtered variance
            var = float(np.var(returns * 100))
            for ret in np.asarray(returns * 100.0):
                var = omega + a * ret**2 + b * var
            daily_var = var / 10000.0
            return float(np.sqrt(daily_var * self.annualization_factor))
        except (ValueError, ArithmeticError, np.linalg.LinAlgError):
            return self._ewma(returns)


@dataclass
class PositionSizeResult:
    """Sizing output (mirrors position_sizer.py:263-290)."""

    position_size: float
    target_weight: float
    realized_vol: float
    leverage: float
    rationale: str
    expected_daily_var: float = 0.0
    max_loss_1d: float = 0.0

    def to_dict(self) -> Dict:
        return {
            "position_size": self.position_size,
            "target_weight": self.target_weight,
            "realized_vol": self.realized_vol,
            "leverage": self.leverage,
            "rationale": self.rationale,
            "expected_daily_var": self.expected_daily_var,
            "max_loss_1d": self.max_loss_1d,
        }


@dataclass
class PositionSizerConfig:
    """Defaults match position_sizer.py:292-310."""

    target_annual_vol: float = 0.15
    max_leverage: float = 2.0
    min_leverage: float = 0.2
    vol_lookback_days: int = 21
    vol_floor: float = 0.01
    vol_ceiling: float = 1.0
    max_position_pct: float = 0.25
    max_drawdown_trigger: float = 0.15


class VolatilityScaledPositionSizer:
    """w_t = sigma_target^2 / sigma_realized^2, clipped (Moreira-Muir 2017)."""

    def __init__(self, config: Optional[PositionSizerConfig] = None):
        self.config = config or PositionSizerConfig()

    def compute_position_size(
        self,
        return_series,
        available_capital: float,
        current_drawdown: float = 0.0,
    ) -> PositionSizeResult:
        realized_vol = self._realized_vol(np.asarray(return_series, dtype=np.float64))
        realized_vol = float(np.clip(realized_vol, self.config.vol_floor, self.config.vol_ceiling))

        target_weight = (self.config.target_annual_vol**2) / (realized_vol**2)
        target_weight = float(np.clip(target_weight, self.config.min_leverage, self.config.max_leverage))

        if current_drawdown > self.config.max_drawdown_trigger:
            mult = self._drawdown_multiplier(current_drawdown)
            raw = target_weight
            target_weight *= mult
            rationale = (
                f"Vol-scaled weight {raw:.2f} reduced to {target_weight:.2f} "
                f"due to {current_drawdown:.1%} drawdown"
            )
        else:
            rationale = (
                f"Vol-scaled: realized vol {realized_vol:.1%} vs target "
                f"{self.config.target_annual_vol:.1%} -> weight {target_weight:.2f}"
            )

        position_size = available_capital * target_weight
        max_position = available_capital * self.config.max_position_pct
        if position_size > max_position:
            position_size = max_position
            target_weight = self.config.max_position_pct
            rationale += f" (capped at {self.config.max_position_pct:.0%})"

        daily_vol = realized_vol / np.sqrt(252)
        return PositionSizeResult(
            position_size=position_size,
            target_weight=target_weight,
            realized_vol=realized_vol,
            leverage=target_weight,
            rationale=rationale,
            expected_daily_var=position_size * daily_vol * 2.33,
            max_loss_1d=position_size * daily_vol * 3.0,
        )

    def compute_portfolio_weights(
        self,
        strategy_returns: Dict[str, np.ndarray],
        total_capital: float,
        strategy_allocations: Optional[Dict[str, float]] = None,
    ) -> Dict[str, PositionSizeResult]:
        if strategy_allocations is None:
            n = len(strategy_returns)
            strategy_allocations = {k: 1.0 / n for k in strategy_returns}
        return {
            name: self.compute_position_size(
                rets, total_capital * strategy_allocations.get(name, 0.0)
            )
            for name, rets in strategy_returns.items()
        }

    def estimate_required_capital(self, target_position: float, return_series) -> float:
        vol = float(
            np.clip(
                self._realized_vol(np.asarray(return_series)),
                self.config.vol_floor,
                self.config.vol_ceiling,
            )
        )
        w = float(
            np.clip(
                (self.config.target_annual_vol**2) / vol**2,
                self.config.min_leverage,
                self.config.max_leverage,
            )
        )
        return target_position / w

    def _realized_vol(self, returns: np.ndarray) -> float:
        if len(returns) < 5:
            return self.config.target_annual_vol
        lookback = min(len(returns), self.config.vol_lookback_days)
        return float(np.std(returns[-lookback:], ddof=1) * np.sqrt(252))

    def _drawdown_multiplier(self, drawdown: float) -> float:
        """Linear reduction past the trigger, floored at 0.25
        (position_sizer.py:481-497)."""
        excess = drawdown - self.config.max_drawdown_trigger
        if excess <= 0:
            return 1.0
        return max(0.25, 1.0 - excess / self.config.max_drawdown_trigger)


class KellyPositionSizer:
    """Fractional Kelly sizing (position_sizer.py:530-612)."""

    def __init__(self, kelly_fraction: float = 0.25, max_kelly_weight: float = 0.5):
        self.kelly_fraction = kelly_fraction
        self.max_kelly_weight = max_kelly_weight

    def compute_position_size(
        self,
        win_probability: float,
        win_loss_ratio: float,
        available_capital: float,
    ) -> PositionSizeResult:
        """Kelly f* = p - (1-p)/b, scaled by the fraction and capped."""
        p, b = win_probability, win_loss_ratio
        if not 0 < p < 1:
            raise ValueError("win_probability must be in (0, 1)")
        if b <= 0:
            raise ValueError("win_loss_ratio must be positive")
        f_star = p - (1.0 - p) / b
        weight = float(np.clip(f_star * self.kelly_fraction, 0.0, self.max_kelly_weight))
        return PositionSizeResult(
            position_size=available_capital * weight,
            target_weight=weight,
            realized_vol=float("nan"),
            leverage=weight,
            rationale=(
                f"Kelly f*={f_star:.3f} x fraction {self.kelly_fraction} "
                f"-> weight {weight:.3f}"
            ),
        )
