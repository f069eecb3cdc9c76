"""OU fitter — analytical MLE, diagnostics and optimal boundaries (twin of
``pde_tpu/calibrate/ou.py``).

Mirrors the reference OUFitter (calibration/ou_fitter.py): the OLS-based
analytical MLE (:246-294, slope clipped to [0.001, 0.999], ddof=1 residual
variance — this variant differs slightly from the C++ moment MLE in
:mod:`pde_tpu_torch.models.ou`; both are provided, as in the reference), an
L-BFGS-B numerical refinement (scipy, on the host) triggered when mu leaves
[0.01, 50], its gradient from ``torch.autograd``; residual diagnostics with
skewness/kurtosis and a Ljung-Box test (:496-520), the approximate Leung-Li
entry boundary entry = sigma_stat sqrt(2 c mu / sigma^2 + 0.5) (:439-494),
a simple ADF stationarity test (:569-620), and a synthetic-path generator
(:644-668).

The fits run on ``device`` (default: the CUDA card) in ``dtype`` (default:
torch's default float); ``device="cpu"`` runs them on the CPU.
``db_session`` is any object; it is kept, not used.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, Optional

import numpy as np
import torch

from ..core.precision import default_float, resolve_device
from ..models.ou import OUParams, log_likelihood

__all__ = ["OptimalBoundaries", "OUFitResult", "OUFitter"]


@dataclass
class OptimalBoundaries:
    """Entry/exit boundaries (ou_fitter.py:99-120)."""

    entry_lower: float
    entry_upper: float
    exit_long: float
    exit_short: float
    stop_loss_long: Optional[float] = None
    stop_loss_short: Optional[float] = None

    def to_dict(self) -> Dict[str, Optional[float]]:
        return {
            "entry_lower": self.entry_lower,
            "entry_upper": self.entry_upper,
            "exit_long": self.exit_long,
            "exit_short": self.exit_short,
            "stop_loss_long": self.stop_loss_long,
            "stop_loss_short": self.stop_loss_short,
        }


@dataclass
class OUFitResult:
    """Fit output (ou_fitter.py:123-160)."""

    params: OUParams
    boundaries: Optional[OptimalBoundaries]
    log_likelihood: float
    aic: float
    bic: float
    n_observations: int
    fit_time: float
    success: bool
    message: str
    residual_stats: Dict[str, float] = field(default_factory=dict)
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    def to_dict(self) -> Dict:
        return {
            "params": {
                "theta": float(self.params.theta),
                "mu": float(self.params.mu),
                "sigma": float(self.params.sigma),
                "half_life": float(self.params.half_life()),
                "stationary_variance": float(self.params.stationary_variance()),
            },
            "boundaries": self.boundaries.to_dict() if self.boundaries else None,
            "log_likelihood": self.log_likelihood,
            "aic": self.aic,
            "bic": self.bic,
            "n_observations": self.n_observations,
            "fit_time": self.fit_time,
            "success": self.success,
            "message": self.message,
            "residual_stats": self.residual_stats,
            "timestamp": self.timestamp.isoformat(),
        }


def _analytical_mle(x, dt):
    """OLS-regression MLE over the last axis, reference semantics
    (ou_fitter.py:246-294): a = corr-slope clipped to [0.001, 0.999], theta
    from the intercept, sigma^2 = 2 mu Var[resid]_{ddof=1} / (1 - a^2).
    Returns (theta, mu, sigma), each of the batch shape.  The sums are
    taken of each series less its first value, as in
    :func:`pde_tpu_torch.models.ou.fit_mle`: S_xx - S_x^2 / n of a series
    far from zero cancels most of float32's digits."""
    shift = x[..., :1]
    x = x - shift
    xt = x[..., :-1]
    xn = x[..., 1:]
    n = xt.shape[-1]

    S_x = torch.sum(xt, dim=-1)
    S_y = torch.sum(xn, dim=-1)
    S_xx = torch.sum(xt * xt, dim=-1)
    S_xy = torch.sum(xt * xn, dim=-1)

    denom = S_xx - S_x * S_x / n
    degenerate = torch.abs(n * S_xx - S_x**2) < 1e-10
    a_raw = (S_xy - S_x * S_y / n) / torch.where(degenerate, 1.0, denom)
    a = torch.clamp(torch.where(degenerate, 0.5, a_raw), 0.001, 0.999)
    theta = torch.where(degenerate, torch.mean(x, dim=-1), (S_y - a * S_x) / (n * (1.0 - a)))

    mu = -torch.log(a) / dt
    resid = xn - theta[..., None] - (xt - theta[..., None]) * a[..., None]
    var_resid = torch.var(resid, dim=-1, correction=1)
    sigma = torch.sqrt(torch.clamp_min(2.0 * mu * var_resid / (1.0 - a * a), 1e-10))
    return theta + shift[..., 0], mu, sigma


def _neg_log_likelihood(params_vec, x, dt):
    p = OUParams(theta=params_vec[0], mu=params_vec[1], sigma=params_vec[2])
    return -log_likelihood(x, p, dt)


class OUFitter:
    """OU parameter estimation with trading-boundary computation."""

    DEFAULT_BOUNDS = {
        "theta": (-np.inf, np.inf),
        "mu": (0.01, 50.0),
        "sigma": (1e-6, np.inf),
    }

    def __init__(self, bounds=None, db_session=None, device=None,
                 dtype: Optional[torch.dtype] = None):
        self.bounds = {**self.DEFAULT_BOUNDS, **(bounds or {})}
        self.db_session = db_session
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()
        self._cached_params: Dict[str, OUParams] = {}

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------ API

    def fit(
        self,
        X,
        dt: float = 1.0 / 252,
        compute_boundaries: bool = True,
        transaction_cost: float = 0.001,
        method: str = "analytical",
        pair_name: Optional[str] = None,
    ) -> OUFitResult:
        """Fit OU parameters to a spread series (ou_fitter.py:296-437)."""
        start = time.time()
        x = self._t(X)
        n = int(x.shape[0])

        theta, mu, sigma = (float(v) for v in _analytical_mle(x, dt))
        success = True

        if method == "analytical" and (mu < 0.01 or mu > 50):
            method = "numerical"

        if method == "numerical":
            from scipy import optimize

            def value_and_grad(v):
                vec = self._t(v).requires_grad_()
                nll = _neg_log_likelihood(vec, x, dt)
                grad, = torch.autograd.grad(nll, vec)
                return float(nll.detach()), grad.detach().cpu().numpy().astype(np.float64)

            res = optimize.minimize(
                value_and_grad,
                x0=np.array([theta, mu, sigma]),
                jac=True,
                method="L-BFGS-B",
                bounds=[self.bounds["theta"], self.bounds["mu"], self.bounds["sigma"]],
            )
            theta, mu, sigma = (float(v) for v in res.x)
            success = bool(res.success)

        if mu <= 0 or sigma <= 0:
            params = OUParams(theta=self._t(np.mean(np.asarray(X))), mu=self._t(0.1),
                              sigma=self._t(np.std(np.asarray(X))))
            return OUFitResult(
                params=params,
                boundaries=None,
                log_likelihood=float("-inf"),
                aic=float("inf"),
                bic=float("inf"),
                n_observations=n,
                fit_time=time.time() - start,
                success=False,
                message="invalid parameters estimated",
            )

        params = OUParams(theta=self._t(theta), mu=self._t(mu), sigma=self._t(sigma))
        ll = float(log_likelihood(x, params, dt))
        aic = 2 * 3 - 2 * ll
        bic = 3 * np.log(n - 1) - 2 * ll

        residual_stats = self._residual_diagnostics(np.asarray(X), params, dt)

        boundaries = None
        if compute_boundaries:
            boundaries = self.compute_optimal_boundaries(
                params, transaction_cost=transaction_cost
            )

        result = OUFitResult(
            params=params,
            boundaries=boundaries,
            log_likelihood=ll,
            aic=aic,
            bic=bic,
            n_observations=n,
            fit_time=time.time() - start,
            success=success,
            message="Fit successful" if success else "Optimization did not converge",
            residual_stats=residual_stats,
        )
        if pair_name:
            self._cached_params[pair_name] = params
        return result

    def fit_batch(self, X, dt: float = 1.0 / 252) -> OUParams:
        """Analytical MLE for a batch of spreads (B, n) in one call."""
        theta, mu, sigma = _analytical_mle(self._t(X), dt)
        return OUParams(theta=theta, mu=mu, sigma=sigma)

    def compute_optimal_boundaries(
        self,
        params: OUParams,
        transaction_cost: float = 0.001,
        stop_loss_mult: float = 2.0,
    ) -> OptimalBoundaries:
        """Approximate Leung-Li boundaries (ou_fitter.py:439-494):
        entry = sigma_stat * sqrt(2 c mu / sigma^2 + 0.5), floored at
        0.5 sigma_stat; exit band 0.1 sigma_stat; 2-sigma stop-losses.
        """
        theta = float(params.theta)
        mu = float(params.mu)
        sigma = float(params.sigma)
        sigma_stat = float(OUParams(*(self._t(float(v)) for v in params)).stationary_std())

        c = transaction_cost * abs(theta) if abs(theta) > 1 else transaction_cost
        entry = sigma_stat * np.sqrt(2.0 * c * mu / (sigma**2) + 0.5)
        entry = max(entry, 0.5 * sigma_stat)
        exit_thr = 0.1 * sigma_stat
        stop = stop_loss_mult * sigma_stat

        return OptimalBoundaries(
            entry_lower=theta - entry,
            entry_upper=theta + entry,
            exit_long=theta + exit_thr,
            exit_short=theta - exit_thr,
            stop_loss_long=theta - stop,
            stop_loss_short=theta + stop,
        )

    # ------------------------------------------------------------ diagnostics

    @staticmethod
    def _residual_diagnostics(X: np.ndarray, params: OUParams, dt: float) -> Dict[str, float]:
        from scipy import stats as sp_stats

        decay = np.exp(-float(params.mu) * dt)
        expected = float(params.theta) + (X[:-1] - float(params.theta)) * decay
        residuals = X[1:] - expected
        return {
            "mean": float(np.mean(residuals)),
            "std": float(np.std(residuals)),
            "skewness": float(sp_stats.skew(residuals)),
            "kurtosis": float(sp_stats.kurtosis(residuals)),
            "ljung_box_p": OUFitter._ljung_box(residuals),
        }

    @staticmethod
    def _ljung_box(residuals: np.ndarray, lags: int = 10) -> float:
        """Ljung-Box p-value (ou_fitter.py:496-520)."""
        from scipy import stats as sp_stats

        n = len(residuals)
        if n < lags + 10:
            return 1.0
        acf = np.correlate(residuals, residuals, mode="full")
        acf = acf[n - 1 :] / acf[n - 1]
        lb = n * (n + 2) * np.sum(acf[1 : lags + 1] ** 2 / (n - np.arange(1, lags + 1)))
        return float(1.0 - sp_stats.chi2.cdf(lb, lags))

    def test_stationarity(self, X: np.ndarray, significance: float = 0.05) -> Dict:
        """Simple ADF approximation (ou_fitter.py:569-620): regress
        dX on X_{t-1}, compare the t-stat to MacKinnon critical values."""
        X = np.asarray(X, dtype=np.float64)
        dX = np.diff(X)
        X_lag = X[:-1]
        n_reg = len(dX)
        X_mat = np.column_stack([np.ones(n_reg), X_lag])
        coeffs = np.linalg.lstsq(X_mat, dX, rcond=None)[0]
        rho = coeffs[1]
        residuals = dX - X_mat @ coeffs
        se = np.sqrt(np.sum(residuals**2) / (n_reg - 2))
        se_rho = se / np.sqrt(np.sum((X_lag - np.mean(X_lag)) ** 2))
        adf_stat = rho / se_rho
        critical = {0.01: -3.43, 0.05: -2.86, 0.10: -2.57}
        cv = critical.get(significance, -2.86)
        return {
            "adf_statistic": float(adf_stat),
            "critical_value": cv,
            "is_stationary": bool(adf_stat < cv),
            "rho": float(rho),
        }

    # --------------------------------------------------------------- fixtures

    def simulate(
        self,
        params: OUParams,
        n_steps: int,
        dt: float = 1.0 / 252,
        X0: Optional[float] = None,
        seed: Optional[int] = None,
    ) -> np.ndarray:
        """Exact-discretization simulation on the fitter's device, its
        normals from a ``torch.Generator`` seeded with ``seed`` (default 0)
        (ou_fitter.py:522-567): the reference's streams differ, its
        statistics do not."""
        from ..models.ou import simulate as ou_simulate

        gen = torch.Generator(device=self.device)
        gen.manual_seed(0 if seed is None else seed)
        x0 = float(params.theta) if X0 is None else X0
        p = OUParams(*(self._t(float(v)) for v in params))
        return ou_simulate(p, self._t(x0), n_steps * dt, n_steps, gen).cpu().numpy()

    @staticmethod
    def generate_synthetic_data(
        theta: float = 0.0,
        mu: float = 5.0,
        sigma: float = 0.2,
        n_points: int = 500,
        dt: float = 1.0 / 252,
        seed: int = 42,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ) -> np.ndarray:
        """A synthetic OU series, simulated on ``device`` (default: the CUDA
        card) in ``dtype`` (default: torch's default float)."""
        params = OUParams(theta=theta, mu=mu, sigma=sigma)
        return OUFitter(device=device, dtype=dtype).simulate(params, n_points, dt=dt,
                                                             seed=seed)
