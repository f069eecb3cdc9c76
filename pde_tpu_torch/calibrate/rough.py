"""Rough Heston surface calibration (twin of ``pde_tpu/calibrate/rough.py``).

Fits (hurst, lam, theta, nu, rho, v0) to an option surface with the
bounded Levenberg-Marquardt of the classic calibrator (calibrate/lm.py):
the Jacobian comes from ``torch.func.jacfwd`` straight through the
fractional-Riccati loop of ``models/rough_heston.price_rough``, which
marches every maturity of the surface at once, and the starts of the
multistart fit are one batch of that LM.

A single smile cannot separate H from nu (both steepen the short end); the
fitter wants >= 2 maturities, ideally with a short one where the
T^{H-1/2} skew term dominates.

Runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..core.precision import default_float, resolve_device
from ..models.rough_heston import RoughHestonParams, price_rough
from .lm import LMResult, levenberg_marquardt

__all__ = ["RoughHestonCalibrator", "RoughCalibrationResult"]

# (hurst, lam, theta, nu, rho, v0)
_LOWER = np.array([0.02, 0.1, 0.005, 0.05, -0.95, 0.005])
_UPPER = np.array([0.5, 10.0, 1.0, 2.0, 0.0, 1.0])


@dataclass
class RoughCalibrationResult:
    params: RoughHestonParams
    rmse: float
    converged: bool
    n_iter: int
    fit_quality: Dict[str, float] = field(default_factory=dict)


def _best_of_starts(residuals, x0s, lower, upper, max_iter):
    """Multistart LM: the same bounded LM from every row of ``x0s`` (S, 6),
    as one call with the starts as its batch axis, keeping the
    lowest-cost run.  The float32 path needs it: a single LM can stall in a
    bad damping cycle from an unlucky start."""
    res = levenberg_marquardt(residuals, x0s, lower, upper, max_iter=max_iter)
    i = torch.argmin(res.cost)
    return LMResult(*(t[i] for t in res))


def _params(x):
    return RoughHestonParams(x[0], x[1], x[2], x[3], x[4], x[5])


def _fit(strikes, maturities, mids, S0, r, q, x0s, lower, upper,
         n_steps: int, max_iter: int):
    """strikes/mids: (n_mat, n_k); maturities: (n_mat,); x0s: (k, 6).

    The reference's ``lax.map`` over maturities is one ``price_rough``
    call on the whole surface: a single fractional-Riccati march carries
    every maturity, so each residual (and each ``jacfwd`` pass) costs
    ``n_steps`` steps, not ``n_mat * n_steps``."""

    def residuals(x):
        model = price_rough(_params(x), strikes, maturities, S0, r, q, n_steps=n_steps)
        return ((model - mids) / torch.clamp_min(mids, 1e-8)).reshape(-1)

    return _best_of_starts(residuals, x0s, lower, upper, max_iter)


def _fit_flat(strikes, t_idx, unique_T, is_call, mids, S0, r, q,
              x0, lower, upper, n_steps: int, max_iter: int):
    """Flat quote-vector fit (the classic calibrator's input convention):
    strikes/mids/is_call (n_quotes,), ``t_idx`` maps each quote to its row
    of ``unique_T``.  Each unique maturity prices the whole strike vector
    (one march for all maturities), then each quote takes its own
    maturity's row."""
    rows = strikes.expand(unique_T.shape[0], -1)

    def residuals(x):
        grid = price_rough(_params(x), rows, unique_T, S0, r, q, is_call=is_call,
                           n_steps=n_steps)                     # (n_T, n_quotes)
        model = torch.take_along_dim(grid, t_idx[None, :], dim=0)[0]
        return (model - mids) / torch.clamp_min(mids, 1e-8)

    return _best_of_starts(residuals, x0, lower, upper, max_iter)


class RoughHestonCalibrator:
    """LM surface fit of the rough Heston model.

    The classic ``HestonCalibrator`` minus the DE global stage: rough fits
    start from a classic fit (H = 0.25, lam = kappa, nu = sigma) when one
    is given.  ``device`` and ``dtype`` set where and in which precision
    the fit runs (default: the CUDA card, torch's default float;
    ``device="cpu"`` for the CPU).
    """

    def __init__(self, n_steps: int = 96, max_iter: int = 40, device=None,
                 dtype: Optional[torch.dtype] = None):
        self.n_steps = int(n_steps)
        self.max_iter = int(max_iter)
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()
        self.bounds = {
            k: (float(lo), float(hi))
            for k, lo, hi in zip(("hurst", "lam", "theta", "nu", "rho", "v0"),
                                 _LOWER, _UPPER)
        }

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype or self.dtype, device=self.device)

    def calibrate(
        self,
        strikes,
        maturities,
        mid_prices,
        S0: float,
        r: float = 0.0,
        q: float = 0.0,
        x0: Optional[RoughHestonParams] = None,
        classic_params=None,
    ) -> RoughCalibrationResult:
        """Fit to a regular surface: ``strikes``/``mid_prices`` of shape
        (n_maturities, n_strikes), ``maturities`` (n_maturities,).
        ``classic_params`` (a HestonParams) seeds the start at the classic
        fit with H = 0.25; an explicit ``x0`` wins."""
        strikes = self._tensor(strikes)
        mids = self._tensor(mid_prices)
        mats = self._tensor(maturities)
        if strikes.dim() != 2 or mids.shape != strikes.shape:
            raise ValueError("strikes/mid_prices must be (n_mat, n_k)")
        if mats.shape != (strikes.shape[0],):
            raise ValueError("maturities must match the surface rows")

        res = _fit(strikes, mats, mids, float(S0), float(r), float(q),
                   self._start(x0, classic_params), self._tensor(_LOWER),
                   self._tensor(_UPPER), n_steps=self.n_steps, max_iter=self.max_iter)
        return self._package(res, strikes.numel())

    def calibrate_quotes(
        self,
        data,
        S0: float,
        r: float = 0.0,
        q: float = 0.0,
        x0: Optional[RoughHestonParams] = None,
        classic_params=None,
    ) -> RoughCalibrationResult:
        """Fit to a FLAT quote vector, the classic calibrator's input
        convention (dict with 'strike', 'maturity', 'mid_price', optional
        'is_call' arrays), so irregular market chains work unchanged."""
        from ..models.heston import group_maturities

        strikes = np.asarray(data["strike"], np.float64)
        mats = np.asarray(data["maturity"], np.float64)
        mids = np.asarray(data["mid_price"], np.float64)
        is_call = np.asarray(data.get("is_call", np.ones(strikes.shape, bool)))
        if not (strikes.shape == mats.shape == mids.shape == is_call.shape):
            raise ValueError("quote arrays must share one flat shape")
        unique_T, t_idx = group_maturities(mats)

        res = _fit_flat(self._tensor(strikes), self._tensor(t_idx, torch.int64),
                        self._tensor(unique_T), self._tensor(is_call, torch.bool),
                        self._tensor(mids), float(S0), float(r), float(q),
                        self._start(x0, classic_params), self._tensor(_LOWER),
                        self._tensor(_UPPER), n_steps=self.n_steps,
                        max_iter=self.max_iter)
        return self._package(res, strikes.size)

    def _start(self, x0, classic_params):
        """Bank of LM starts (k, 6): the primary guess plus deterministic
        H / mean-reversion variations."""
        if x0 is not None:
            primary = [x0.hurst, x0.lam, x0.theta, x0.nu, x0.rho, x0.v0]
        elif classic_params is not None:
            cp = classic_params
            primary = [0.25, cp.kappa, cp.theta, cp.sigma, cp.rho, cp.v0]
        else:
            primary = [0.2, 2.0, 0.04, 0.4, -0.5, 0.04]
        h, lam, th, nu, rho, v0 = (float(v) for v in primary)
        starts = [
            [h, lam, th, nu, rho, v0],
            [0.1, lam, th, nu, rho, v0],
            [0.4, 0.5 * lam, th, 0.7 * nu, rho, v0],
            [min(max(h, 0.05), 0.45), 2.0 * lam, th, 1.3 * nu, rho, v0],
        ]
        return self._tensor(np.clip(np.asarray(starts, np.float64), _LOWER, _UPPER))

    @staticmethod
    def _package(res, n_quotes) -> RoughCalibrationResult:
        x = res.x.detach().cpu().numpy()
        params = RoughHestonParams(*[float(v) for v in x])
        rmse = float(np.sqrt(2.0 * float(res.cost) / n_quotes))
        return RoughCalibrationResult(
            params=params,
            rmse=rmse,
            converged=bool(res.converged),
            n_iter=int(res.n_iter),
            fit_quality={"rel_rmse": rmse, "n_quotes": float(n_quotes)},
        )

    @staticmethod
    def generate_synthetic_surface(
        hurst=0.15, lam=2.0, theta=0.04, nu=0.3, rho=-0.65, v0=0.04,
        S0=100.0, r=0.02, q=0.0,
        strikes=None, maturities=(0.05, 0.25, 1.0), n_steps: int = 96,
        device=None, dtype: Optional[torch.dtype] = None,
    ):
        """Synthetic rough-Heston surface for recovery tests, priced on
        ``device`` in ``dtype`` (default: the CUDA card, torch's default
        float)."""
        device = resolve_device(device)
        dtype = dtype or default_float()
        p = RoughHestonParams(hurst, lam, theta, nu, rho, v0)
        ks = np.linspace(85.0, 115.0, 9) if strikes is None else np.asarray(strikes)
        mats = np.asarray(maturities, dtype=np.float64)
        k_grid = np.tile(ks, (len(mats), 1))
        mids = price_rough(p, torch.as_tensor(k_grid, dtype=dtype, device=device),
                           torch.as_tensor(mats, dtype=dtype, device=device), S0, r, q,
                           n_steps=n_steps)
        return {
            "strikes": k_grid,
            "maturities": mats,
            "mid_prices": mids.cpu().numpy(),
            "S0": S0, "r": r, "q": q, "true_params": p,
        }
