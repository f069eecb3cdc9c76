"""SABR smile calibration — per-maturity (alpha, rho, nu) fits (twin of
``pde_tpu/calibrate/sabr.py``).

Mirrors the reference SABRCalibrator (calibration/sabr_calibrator.py):
beta fixed (default 0.5), a weighted least-squares smile fit per maturity
from an ATM-vol-derived alpha start (:296-333), forward F = F0 e^{(r-q)T}
(:440), parameter interpolation across maturities (:533-609) and synthetic
smiles (:611-657).  The fit is the bounded Levenberg-Marquardt of
:mod:`.lm` on the Hagan formula of :mod:`pde_tpu_torch.models.sabr`;
:meth:`SABRCalibrator.calibrate_surface_batch` fits every maturity of a
rectangular surface in one LM call, each smile's data mapped beside its
start.

Runs on the card unless the caller passes ``device="cpu"``; float32 by
default, float64 for the parity tests.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.precision import default_float, resolve_device
from ..models import sabr as sabr_model
from ..models.sabr import SABRParams
from .lm import levenberg_marquardt

__all__ = ["SABRCalibrationError", "SABRCalibrationResult", "SABRCalibrator"]


class SABRCalibrationError(Exception):
    pass


@dataclass
class SABRCalibrationResult:
    """Surface calibration output (mirrors sabr_calibrator.py:73-105)."""

    params_by_maturity: Dict[float, SABRParams]
    rmse_by_maturity: Dict[float, float]
    total_rmse: float
    calibration_time: float
    n_maturities: int
    n_options: int
    success: bool
    message: str
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    converged_by_maturity: Dict[float, bool] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "params_by_maturity": {
                str(T): {"alpha": float(p.alpha), "beta": float(p.beta),
                         "rho": float(p.rho), "nu": float(p.nu)}
                for T, p in self.params_by_maturity.items()
            },
            "rmse_by_maturity": {str(T): float(v) for T, v in self.rmse_by_maturity.items()},
            "total_rmse": float(self.total_rmse),
            "calibration_time": self.calibration_time,
            "n_maturities": self.n_maturities,
            "n_options": self.n_options,
            "success": self.success,
            "message": self.message,
            "timestamp": self.timestamp.isoformat(),
        }


def _fit_smiles(strikes, market_vols, weights, F, T, x0, lower, upper,
                beta: float, max_iter: int = 80):
    """LM fits of (alpha, rho, nu) to M smiles at once: ``strikes``,
    ``market_vols`` and ``weights`` (M, K), ``F`` and ``T`` (M,), ``x0``
    (M, 3).  Weighted residuals; returns (x (M, 3), rmse (M,), converged (M,))."""
    sw = torch.sqrt(weights / torch.sum(weights, dim=-1, keepdim=True))

    def residuals(x, k, v, s, f, t):
        # (1,)-shaped parameters, not 0-d: under jacfwd a 0-d tensor times
        # a Python number gets a float64 tangent, which would break a
        # float32 fit
        p = SABRParams(alpha=x[0:1], beta=beta, rho=x[1:2], nu=x[2:3])
        return s * (sabr_model.implied_volatility(k, f, t, p) - v)

    res = levenberg_marquardt(residuals, torch.clamp(x0, lower, upper), lower,
                              upper, max_iter=max_iter,
                              data=(strikes, market_vols, sw, F, T))
    x = res.x
    model = sabr_model.implied_volatility(
        strikes, F[:, None], T[:, None],
        SABRParams(x[:, 0:1], beta, x[:, 1:2], x[:, 2:3]))
    rmse = torch.sqrt(torch.mean((model - market_vols) ** 2, dim=-1))
    return x, rmse, res.converged


class SABRCalibrator:
    """Per-maturity SABR smile calibrator (API parity with the reference).

    ``device`` and ``dtype`` set where and in which precision the fits run
    (default: the CUDA card, torch's default float; ``device="cpu"`` for
    the CPU).  ``db_session`` is any object; it is kept, not used."""

    DEFAULT_BOUNDS = {
        "alpha": (0.001, 2.0),
        "rho": (-0.99, 0.99),
        "nu": (0.001, 3.0),
    }

    def __init__(self, beta: float = 0.5, bounds=None, db_session=None,
                 device=None, dtype: Optional[torch.dtype] = None):
        self.beta = float(beta)
        self.bounds = {**self.DEFAULT_BOUNDS, **(bounds or {})}
        self.db_session = db_session
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()
        self._cached_params: Dict[str, Dict[float, SABRParams]] = {}

    # ------------------------------------------------------------------ API

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=self.dtype,
                               device=self.device)

    def _box(self):
        names = ("alpha", "rho", "nu")
        return tuple(self._t([self.bounds[k][i] for k in names]) for i in (0, 1))

    def sabr_implied_vol(self, F, K, T, alpha, beta, rho, nu):
        """Single-point Hagan vol (reference sabr_calibrator.py:159-258)."""
        return float(sabr_model.implied_volatility(
            self._t(K), self._t(F), self._t(T), SABRParams(alpha, beta, rho, nu)))

    def calibrate_single_maturity(
        self,
        strikes: np.ndarray,
        market_vols: np.ndarray,
        F: float,
        T: float,
        weights: Optional[np.ndarray] = None,
        initial_guess: Optional[Dict[str, float]] = None,
    ) -> Tuple[SABRParams, float]:
        """Fit (alpha, rho, nu) for one maturity (sabr_calibrator.py:260-360)."""
        strikes = np.asarray(strikes, dtype=np.float64)
        market_vols = np.asarray(market_vols, dtype=np.float64)
        if len(strikes) < 3:
            raise SABRCalibrationError(
                f"Need at least 3 strikes for SABR calibration, got {len(strikes)}")
        if weights is None:
            weights = np.ones(len(strikes))
        if initial_guess:
            x0 = np.array([initial_guess.get("alpha", 0.3),
                           initial_guess.get("rho", -0.3),
                           initial_guess.get("nu", 0.5)])
        else:
            # alpha from the ATM vol: sigma_ATM ~ alpha / F^(1-beta)
            atm_idx = int(np.argmin(np.abs(strikes - F)))
            x0 = np.array([market_vols[atm_idx] * F ** (1.0 - self.beta), -0.3, 0.5])

        lower, upper = self._box()
        x, rmse, conv = _fit_smiles(
            self._t(strikes)[None], self._t(market_vols)[None], self._t(weights)[None],
            self._t([F]), self._t([T]), self._t(x0)[None], lower, upper, beta=self.beta)
        # one transfer of the results
        x, rmse, conv = (a[0].cpu() for a in (x, rmse, conv))
        params = SABRParams(alpha=float(x[0]), beta=self.beta, rho=float(x[1]),
                            nu=float(x[2]))
        self._last_converged = bool(conv)
        return params, float(rmse)

    def calibrate(
        self,
        market_options,
        F0: float,
        r: float = 0.0,
        q: float = 0.0,
        use_forward: bool = True,
        warm_start: Optional[Dict[float, Dict[str, float]]] = None,
        underlying: Optional[str] = None,
    ) -> SABRCalibrationResult:
        """Calibrate across all maturities (sabr_calibrator.py:363-497).

        ``market_options``: DataFrame or dict with 'strike', 'T',
        'implied_vol' and optional 'weight'.
        """
        start = time.time()
        if hasattr(market_options, "columns"):
            get = lambda c: market_options[c].to_numpy()  # noqa: E731
            has = lambda c: c in market_options.columns  # noqa: E731
        else:
            get = lambda c: np.asarray(market_options[c])  # noqa: E731
            has = lambda c: c in market_options  # noqa: E731

        strikes_all = get("strike").astype(np.float64)
        T_all = get("T").astype(np.float64)
        vols_all = get("implied_vol").astype(np.float64)
        w_all = get("weight").astype(np.float64) if has("weight") else None

        maturities = sorted(np.unique(T_all).tolist())
        params_by_maturity: Dict[float, SABRParams] = {}
        rmse_by_maturity: Dict[float, float] = {}
        converged_by_maturity: Dict[float, bool] = {}
        total_errors = []

        # regular surfaces (same strike count per maturity, no weights or
        # warm starts) fit every smile in ONE batched LM call
        counts = {int(np.sum(T_all == T)) for T in maturities}
        regular = (w_all is None and not warm_start and len(counts) == 1
                   and counts != {0} and next(iter(counts)) >= 3)
        if regular:
            order = np.argsort(T_all, kind="stable")
            Kn = next(iter(counts))
            M = len(maturities)
            T_arr = np.asarray(maturities)
            F_arr = F0 * np.exp((r - q) * T_arr) if use_forward else np.full(M, F0)
            out = self.calibrate_surface_batch(strikes_all[order].reshape(M, Kn),
                                               vols_all[order].reshape(M, Kn),
                                               F_arr, T_arr)
            for m, T in enumerate(maturities):
                params_by_maturity[T] = SABRParams(
                    alpha=float(out["alpha"][m]), beta=self.beta,
                    rho=float(out["rho"][m]), nu=float(out["nu"][m]))
                rmse_by_maturity[T] = float(out["rmse"][m])
                converged_by_maturity[T] = bool(out["converged"][m])
                total_errors.extend([float(out["rmse"][m]) ** 2] * Kn)
        else:
            for T in maturities:
                mask = T_all == T
                strikes = strikes_all[mask]
                vols = vols_all[mask]
                weights = w_all[mask] if w_all is not None else None
                F = F0 * np.exp((r - q) * T) if use_forward else F0
                guess = warm_start.get(T) if warm_start else None
                try:
                    params, rmse = self.calibrate_single_maturity(
                        strikes, vols, F, T, weights=weights, initial_guess=guess)
                    params_by_maturity[T] = params
                    rmse_by_maturity[T] = rmse
                    converged_by_maturity[T] = getattr(self, "_last_converged", True)
                    model = sabr_model.implied_volatilities(
                        self._t(strikes), self._t(F), self._t(T), params).cpu().numpy()
                    total_errors.extend(((model - vols) ** 2).tolist())
                except SABRCalibrationError:
                    rmse_by_maturity[T] = float("inf")

        elapsed = time.time() - start
        total_rmse = float(np.sqrt(np.mean(total_errors))) if total_errors else float("inf")
        all_fitted = len(params_by_maturity) == len(maturities)
        success = all_fitted and all(converged_by_maturity.get(T, False)
                                     for T in maturities)
        result = SABRCalibrationResult(
            params_by_maturity=params_by_maturity,
            rmse_by_maturity=rmse_by_maturity,
            total_rmse=total_rmse,
            calibration_time=elapsed,
            n_maturities=len(maturities),
            n_options=len(strikes_all),
            success=success,
            message=("Calibration successful" if success
                     else ("Converged on a subset of maturities" if all_fitted
                           else "Partial calibration")),
            converged_by_maturity=converged_by_maturity,
        )
        if underlying:
            self._cached_params[underlying] = params_by_maturity
        return result

    def calibrate_surface_batch(
        self,
        strikes: np.ndarray,
        market_vols: np.ndarray,
        forwards: np.ndarray,
        maturities: np.ndarray,
        x0: Optional[np.ndarray] = None,
    ):
        """Fit a rectangular surface: strikes (M, K), vols (M, K), forwards
        (M,), maturities (M,) — every maturity in one batched LM call."""
        strikes, market_vols, forwards = (np.asarray(a, dtype=np.float64)
                                          for a in (strikes, market_vols, forwards))
        M, _ = strikes.shape
        if x0 is None:
            atm_idx = np.argmin(np.abs(strikes - forwards[:, None]), axis=1)
            alpha0 = market_vols[np.arange(M), atm_idx] * forwards ** (1.0 - self.beta)
            x0 = np.stack([alpha0, np.full(M, -0.3), np.full(M, 0.5)], axis=1)
        lower, upper = self._box()
        s = self._t(strikes)
        xs, rmses, conv = _fit_smiles(s, self._t(market_vols), torch.ones_like(s),
                                      self._t(forwards), self._t(maturities),
                                      self._t(x0), lower, upper, beta=self.beta)
        xs, rmses, conv = (a.cpu().numpy() for a in (xs, rmses, conv))
        return {"alpha": xs[:, 0], "rho": xs[:, 1], "nu": xs[:, 2], "rmse": rmses,
                "converged": conv}

    # -------------------------------------------------- interpolation & gen

    def get_implied_vol(self, K: float, T: float,
                        params_by_maturity: Dict[float, SABRParams], F: float):
        """Vol at arbitrary (K, T) via parameter interpolation across
        maturities (sabr_calibrator.py:499-609)."""
        p = self.interpolate_parameters(T, params_by_maturity)
        return float(sabr_model.implied_volatility(self._t(K), self._t(F),
                                                   self._t(T), p))

    def interpolate_parameters(
        self, T: float, params_by_maturity: Dict[float, SABRParams]
    ) -> SABRParams:
        """Linear interpolation of (alpha, rho, nu) in maturity; clamped ends."""
        if not params_by_maturity:
            raise SABRCalibrationError("No calibrated parameters to interpolate")
        Ts = sorted(params_by_maturity)
        if T <= Ts[0]:
            return params_by_maturity[Ts[0]]
        if T >= Ts[-1]:
            return params_by_maturity[Ts[-1]]
        hi = next(i for i, t in enumerate(Ts) if t >= T)
        t0, t1 = Ts[hi - 1], Ts[hi]
        w = (T - t0) / (t1 - t0)
        p0, p1 = params_by_maturity[t0], params_by_maturity[t1]
        mix = lambda a, b: float(a) * (1 - w) + float(b) * w  # noqa: E731
        return SABRParams(alpha=mix(p0.alpha, p1.alpha), beta=self.beta,
                          rho=mix(p0.rho, p1.rho), nu=mix(p0.nu, p1.nu))

    @classmethod
    def generate_synthetic_smile(
        cls,
        F: float = 100.0,
        T: float = 0.5,
        alpha: float = 0.25,
        beta: float = 0.5,
        rho: float = -0.3,
        nu: float = 0.5,
        n_strikes: int = 11,
        noise_std: float = 0.0,
        seed: int = 0,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        """Synthetic smile from known parameters (sabr_calibrator.py:611-657),
        priced on ``device`` (default: the CUDA card) in ``dtype`` (default:
        torch's default float); returns numpy (strikes, vols)."""
        strikes = np.linspace(0.8 * F, 1.2 * F, n_strikes)
        vols = sabr_model.implied_volatilities(
            torch.as_tensor(strikes, dtype=dtype or default_float(),
                            device=resolve_device(device)),
            F, T, SABRParams(alpha, beta, rho, nu)).cpu().double().numpy()
        if noise_std > 0:
            rng = np.random.default_rng(seed)
            vols = np.maximum(vols + rng.normal(0, noise_std, len(vols)), 1e-4)
        return strikes, vols
