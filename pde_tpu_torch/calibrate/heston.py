"""Heston surface calibration — two-stage (DE global + LM local), on tensors
(twin of ``pde_tpu/calibrate/heston.py``).

Mirrors the reference HestonCalibrator (calibration/heston_calibrator.py:
247-735): same bounds, same sum-of-squared-relative-errors objective
(:486-513), same relative-error residuals for the local stage (:515-536),
same fit-quality metrics (:588-643) and warnings (:645-674).

* Stage 1: :mod:`.de` prices every DE generation as one batched tensor —
  the population rides a leading parameter dimension of the grouped
  Carr-Madan pricer.
* Stage 2: :mod:`.lm`, with the top-k DE members and one data-informed
  start polished together as a batch.

Runs on whatever device the quote tensors are on; the GPU path is
float32/complex64, the parity tests float64/complex128.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.precision import default_float
from ..models import black_scholes as bs
from ..models import heston as heston_model
from ..models.heston import HestonParams
from .de import differential_evolution
from .lm import levenberg_marquardt

__all__ = ["CalibrationError", "CalibrationResult", "HestonCalibrator"]

PARAM_ORDER = ("kappa", "theta", "sigma", "rho", "v0")


class CalibrationError(Exception):
    """Raised when calibration fails (reference heston_calibrator.py:40)."""


@dataclass
class CalibrationResult:
    """Calibration output (mirrors reference heston_calibrator.py:132-176)."""

    params: HestonParams
    fit_quality: Dict[str, float]
    convergence: Dict[str, Any]
    timestamp: datetime
    warnings: List[str] = field(default_factory=list)

    @property
    def success(self) -> bool:
        return bool(
            self.convergence.get("local_converged", False)
            or self.convergence.get("cached", False)
        )

    @property
    def rmse(self) -> float:
        return float(self.fit_quality.get("rmse", float("inf")))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "params": {k: float(getattr(self.params, k)) for k in PARAM_ORDER},
            "fit_quality": self.fit_quality,
            "convergence": self.convergence,
            "timestamp": self.timestamp,
            "warnings": self.warnings,
            "success": self.success,
            "rmse": self.rmse,
        }


# Euler-Maclaurin-corrected Gauss-Legendre nodes for both stages: DE and LM
# optimize numerically the same objective, the reference's rectangle sum
# (models/heston.py:_gl_ref_rule)
_DE_GL_POINTS = 64


def _params_of(x: torch.Tensor) -> HestonParams:
    """(..., 5) parameter vectors -> HestonParams whose fields broadcast
    against the pricer's (M, n_u) characteristic-function rows."""
    return HestonParams(*(x[..., i, None, None] for i in range(5)))


def _price_vec_grouped(params_array, strikes, t_idx, unique_T, is_calls,
                       S0, r, q, n_points=heston_model.N_QUADRATURE,
                       du=heston_model.DU):
    return heston_model.price_carr_madan_grouped(
        _params_of(params_array), strikes, t_idx, unique_T, S0, r, q, is_calls,
        n_points=n_points, du=du,
    )


def _price_vec_gl_grouped(params_array, strikes, t_idx, unique_T, is_calls,
                          S0, r, q, n_points=_DE_GL_POINTS):
    return heston_model.price_carr_madan_gl_grouped(
        _params_of(params_array), strikes, t_idx, unique_T, S0, r, q, is_calls,
        n_points=n_points,
    )


def _objective_population_gl_grouped(pop, strikes, t_idx, unique_T, is_calls,
                                     market_prices, mask, S0, r, q,
                                     n_points=_DE_GL_POINTS):
    """DE-stage objective: sum of squared relative errors per population
    member (reference heston_calibrator.py:486-513) on the corrected-GL
    grid.  ``mask`` zeroes the residuals of padded quote slots.

    DEVIATION (kept from the reference package): non-positive prices are
    clamped to 1e-10, as the reference's own local-stage residuals do
    (:533), instead of the flat 1e10 penalty, which an f32 DE stage would
    hit on deep-OTM short-dated quotes even at the true parameters.  NaN
    still gets the hard penalty."""
    prices = _price_vec_gl_grouped(pop, strikes, t_idx, unique_T, is_calls,
                                   S0, r, q, n_points)          # (P, N)
    # neutralize padded slots BEFORE the NaN check: NaN * 0 is NaN
    prices = torch.where(mask > 0, prices, market_prices)
    nan_bad = torch.any(torch.isnan(prices), dim=-1)
    prices = torch.clamp_min(prices, 1e-10)
    errors = mask * (prices - market_prices) / market_prices
    obj = torch.sum(errors * errors, dim=-1)
    return torch.where(nan_bad, torch.full_like(obj, 1e10), obj)


def _calibrate_pipeline(
    strikes,
    t_idx,
    unique_T,
    is_calls,
    market_prices,
    mask,
    S0,
    r,
    q,
    lower,
    upper,
    generator: torch.Generator,
    x0,
    use_x0: bool,
    global_maxiter: int = 100,
    global_popsize: int = 15,
    local_max_iter: int = 60,
):
    """The full two-stage calibration.

    Maturities arrive grouped as ``(t_idx, unique_T)`` from
    :func:`pde_tpu_torch.models.heston.group_maturities`.  ``mask`` (1.0 =
    real quote, 0.0 = padding) weights every residual: padded slots add
    zero to the DE objective, zero rows to the LM Jacobian, and nothing to
    convergence.  All tensors share one device and float dtype;
    ``generator`` lives on that device.

    Returns ``(de_x, de_fun, de_n_iter, lm_x, lm_cost, lm_converged,
    lm_n_iter, model_prices)``, the reference's tuple.
    """

    def objective(pop):
        return _objective_population_gl_grouped(
            pop, strikes, t_idx, unique_T, is_calls, market_prices, mask,
            S0, r, q,
        )

    # warm start seeds the DE population (heston_calibrator.py:411-413)
    seed = x0 if use_x0 else 0.5 * (lower + upper)
    de = differential_evolution(
        objective,
        lower,
        upper,
        generator,
        x0=seed,
        popsize=global_popsize,
        maxiter=global_maxiter,
        # floor-immune early termination (see calibrate/de.py): population
        # collapsed below 1% of the box, 12 stalled generations, or 1%
        # mean relative price error (basin capture for the multistart LM)
        param_tol=1e-2,
        stagnation_patience=12,
        target_energy=1e-4 * torch.sum(mask),
    )

    def residuals(x):
        prices = _price_vec_gl_grouped(x, strikes, t_idx, unique_T, is_calls, S0, r, q)
        # padded slots must yield an EXACT zero residual even when the CF
        # NaNs there (mask * NaN = NaN would poison the cost and Jacobian)
        prices = torch.where(mask > 0, prices, market_prices)
        prices = torch.clamp_min(prices, 1e-10)  # heston_calibrator.py:533
        return mask * (prices - market_prices) / market_prices

    # MULTISTART local stage: the top-k DE members (the reference's
    # deviation from a single least_squares, kept) ...
    k_starts = min(4, global_popsize * 5)
    order = torch.argsort(de.population_energies)
    starts = de.population[order[:k_starts]]

    # ... plus one INFORMED start: short-maturity ATM implied variance ~ v0,
    # long-maturity ATM implied variance ~ theta
    T_q = unique_T[t_idx.long()]
    big = 1e18
    fwd = S0 * torch.exp((r - q) * T_q)
    # a rough vol level is enough to seed the start — 8 Newton iterations
    iv = bs.implied_vol(market_prices, S0, strikes, r, q, T_q, is_calls,
                        max_iter=8)
    atm_pen = torch.abs(strikes - fwd) + (1.0 - mask) * big
    t_short = torch.min(torch.where(mask > 0, T_q, torch.full_like(T_q, big)))
    t_long = torch.max(torch.where(mask > 0, T_q, torch.full_like(T_q, -big)))
    i_short = torch.argmin(atm_pen + big * (T_q != t_short))
    i_long = torch.argmin(atm_pen + big * (T_q != t_long))
    const = lambda c: torch.full((), c, dtype=strikes.dtype, device=strikes.device)  # noqa: E731
    informed = torch.stack([const(2.0), iv[i_long] ** 2, const(0.5),
                            const(-0.5), iv[i_short] ** 2])
    informed = torch.clamp(informed, lower, upper)
    informed = torch.where(torch.isfinite(informed), informed, 0.5 * (lower + upper))
    starts = torch.cat([starts, informed[None, :]], dim=0)

    # two chained LM passes with a FRESH damping state: long descents
    # through the ill-conditioned kappa-sigma ridge inflate lambda; the
    # restart from the first pass's iterate reaches the optimum quickly
    first = levenberg_marquardt(residuals, starts, lower, upper,
                                max_iter=local_max_iter, ftol=1e-8)
    lm_all = levenberg_marquardt(residuals, first.x, lower, upper,
                                 max_iter=local_max_iter, ftol=1e-8)
    best = torch.argmin(lm_all.cost)
    lm_x = lm_all.x[best]

    # reported prices stay on the LITERAL reference grid; only the optimizer
    # hot loops use the corrected-GL rule
    model_prices = _price_vec_grouped(lm_x, strikes, t_idx, unique_T, is_calls, S0, r, q)
    return (de.x, de.fun, de.n_iter, lm_x, lm_all.cost[best],
            lm_all.converged[best], lm_all.n_iter[best], model_prices)


class HestonCalibrator:
    """Two-stage Heston calibrator (API parity with the reference class).

    ``db`` is any object exposing ``store_model_parameters`` /
    ``get_latest_model_parameters``.  ``device`` and ``dtype`` set where and
    in which precision the pipeline runs (default: CPU, torch's default
    float).
    """

    DEFAULT_BOUNDS = {
        "kappa": (0.1, 10.0),
        "theta": (0.01, 1.0),
        "sigma": (0.01, 2.0),
        "rho": (-0.99, 0.99),
        "v0": (0.01, 1.0),
    }

    def __init__(
        self,
        db=None,
        bounds: Optional[Dict[str, Tuple[float, float]]] = None,
        global_maxiter: int = 100,
        global_popsize: int = 15,
        local_max_iter: int = 60,
        seed: int = 42,
        pad_shapes: bool = True,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        self.db = db
        self.bounds = bounds or dict(self.DEFAULT_BOUNDS)
        self.global_maxiter = global_maxiter
        self.global_popsize = global_popsize
        self.local_max_iter = local_max_iter
        self.seed = seed
        # pad the quote/maturity axes up to shape buckets: padded, masked
        # slots leave the fit unchanged (kept from the reference, where it
        # lets one compiled program serve chains of different sizes)
        self.pad_shapes = pad_shapes
        self.device = torch.device(device or "cpu")
        self.dtype = dtype or default_float()

    # ------------------------------------------------------------------ API

    def calibrate(
        self,
        market_options,
        S0: float,
        r: float,
        q: float,
        warm_start: Optional[Dict[str, float]] = None,
        use_cached_on_failure: bool = True,
        underlying: Optional[str] = None,
    ) -> CalibrationResult:
        """Calibrate to market option prices.

        ``market_options``: DataFrame or dict with columns/keys 'strike',
        'maturity', 'mid_price' and optionally 'is_call' / 'option_type' /
        'underlying' (same schema as the reference).
        """
        start = time.time()
        strikes, maturities, prices, is_calls, underlying = self._extract(
            market_options, underlying
        )
        dev, dt = self.device, self.dtype

        def tensor(a, dtype=dt):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        try:
            lower = tensor([self.bounds[k][0] for k in PARAM_ORDER])
            upper = tensor([self.bounds[k][1] for k in PARAM_ORDER])
            use_x0 = bool(warm_start)
            x0 = tensor([warm_start[k] for k in PARAM_ORDER] if use_x0 else np.zeros(5))

            generator = torch.Generator(device=dev)
            generator.manual_seed(self.seed)
            n_real = len(strikes)
            if self.pad_shapes:
                n_pad = max(32, -(-n_real // 32) * 32)  # next multiple of 32
                # maturity buckets of 2 (the CF cost scales with M)
                unique_T, t_idx = heston_model.group_maturities(
                    maturities,
                    pad_to=-(-len(np.unique(maturities)) // 2) * 2,
                )
                pad = n_pad - n_real
                strikes_p = np.concatenate([strikes, np.full(pad, float(S0))])
                t_idx = np.concatenate([t_idx, np.zeros(pad, t_idx.dtype)])
                is_calls_p = np.concatenate([is_calls, np.ones(pad, bool)])
                prices_p = np.concatenate([prices, np.ones(pad)])
                mask = np.concatenate([np.ones(n_real), np.zeros(pad)])
            else:
                unique_T, t_idx = heston_model.group_maturities(maturities)
                strikes_p, is_calls_p, prices_p = strikes, is_calls, prices
                mask = np.ones(n_real)
            out = _calibrate_pipeline(
                tensor(strikes_p),
                tensor(t_idx, torch.int64),
                tensor(unique_T),
                tensor(is_calls_p, torch.bool),
                tensor(prices_p),
                tensor(mask),
                float(S0),
                float(r),
                float(q),
                lower,
                upper,
                generator,
                x0,
                use_x0,
                global_maxiter=self.global_maxiter,
                global_popsize=self.global_popsize,
                local_max_iter=self.local_max_iter,
            )
            # ONE device->host transfer of the results
            (_, de_fun, de_iter, lm_x, lm_cost, lm_conv, lm_iter,
             model_prices) = (t.cpu().numpy() for t in out)
            params = HestonParams(*[float(v) for v in lm_x])
            warnings = self._validate_parameters(
                params, max_maturity=float(np.max(maturities))
            )
            fit_quality = self._fit_quality(
                model_prices[:n_real].astype(np.float64), prices, params)
            elapsed_ms = int((time.time() - start) * 1000)

            result = CalibrationResult(
                params=params,
                fit_quality=fit_quality,
                convergence={
                    "global_converged": True,
                    "local_converged": bool(lm_conv),
                    "global_nit": int(de_iter),
                    "local_nfev": int(lm_iter),
                    "global_obj": float(de_fun),
                    "local_cost": float(lm_cost),
                    "calibration_time_ms": elapsed_ms,
                },
                timestamp=datetime.now(),
                warnings=warnings,
            )
            if self.db is not None:
                self._store(result, underlying)
            return result

        except Exception as exc:  # noqa: BLE001 - mirror reference fallback
            if use_cached_on_failure and self.db is not None:
                cached = self._load_cached(underlying)
                if cached is not None:
                    return cached
            raise CalibrationError(f"Calibration failed: {exc}") from exc

    # ------------------------------------------------------------ internals

    @staticmethod
    def _extract(market_options, underlying):
        if hasattr(market_options, "columns"):  # DataFrame
            cols = market_options.columns
            for col in ("strike", "maturity", "mid_price"):
                if col not in cols:
                    raise ValueError(f"Missing required column: {col}")
            strikes = market_options["strike"].to_numpy(dtype=np.float64)
            maturities = market_options["maturity"].to_numpy(dtype=np.float64)
            prices = market_options["mid_price"].to_numpy(dtype=np.float64)
            if "is_call" in cols:
                is_calls = market_options["is_call"].to_numpy(dtype=bool)
            elif "option_type" in cols:
                is_calls = (
                    market_options["option_type"].str.lower() == "call"
                ).to_numpy()
            else:
                is_calls = np.ones(len(strikes), dtype=bool)
            if underlying is None:
                underlying = (
                    str(market_options["underlying"].iloc[0])
                    if "underlying" in cols
                    else "UNKNOWN"
                )
        else:  # dict of arrays
            for colname in ("strike", "maturity", "mid_price"):
                if colname not in market_options:
                    raise ValueError(f"Missing required column: {colname}")
            strikes = np.asarray(market_options["strike"], dtype=np.float64)
            maturities = np.asarray(market_options["maturity"], dtype=np.float64)
            prices = np.asarray(market_options["mid_price"], dtype=np.float64)
            if "is_call" in market_options:
                is_calls = np.asarray(market_options["is_call"], dtype=bool)
            elif "option_type" in market_options:
                is_calls = np.asarray(
                    [str(t).lower() == "call"
                     for t in np.atleast_1d(market_options["option_type"])]
                )
            else:
                is_calls = np.ones(len(strikes), dtype=bool)
            if underlying is None and "underlying" in market_options:
                underlying = str(np.atleast_1d(market_options["underlying"])[0])
            underlying = underlying or "UNKNOWN"

        # input validation (heston_calibrator.py:676-698)
        if np.any(prices <= 0):
            raise ValueError(f"Found {int(np.sum(prices <= 0))} options with price <= 0")
        if np.any(maturities <= 0):
            raise ValueError(
                f"Found {int(np.sum(maturities <= 0))} options with maturity <= 0"
            )
        return strikes, maturities, prices, is_calls, underlying

    @staticmethod
    def _fit_quality(model_prices, market_prices, params: HestonParams):
        """RMSE / R^2 / relative and absolute errors (heston_calibrator.py:588-643)."""
        errors = model_prices - market_prices
        rmse = float(np.sqrt(np.mean(errors**2)))
        ss_res = float(np.sum(errors**2))
        ss_tot = float(np.sum((market_prices - np.mean(market_prices)) ** 2))
        return {
            "rmse": rmse,
            "r_squared": 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0,
            "relative_rmse": rmse / float(np.mean(market_prices)),
            "max_abs_error": float(np.max(np.abs(errors))),
            "mean_abs_error": float(np.mean(np.abs(errors))),
            "n_options": int(len(market_prices)),
            "feller_satisfied": bool(params.feller_satisfied()),
            "feller_value": float(params.feller_value()),
        }

    @staticmethod
    def _validate_parameters(params: HestonParams,
                             max_maturity: float | None = None) -> List[str]:
        """Warning heuristics matching heston_calibrator.py:645-674, plus the
        Carr-Madan validity check (models/heston.py:moment_explosion_time)."""
        warnings = []
        k, t, s, rho, v0 = (float(getattr(params, n)) for n in PARAM_ORDER)
        if not params.feller_satisfied():
            warnings.append(
                f"Feller condition violated: 2kappa*theta = {2*k*t:.4f} < "
                f"sigma^2 = {s**2:.4f}. Variance may reach zero."
            )
        if max_maturity is not None:
            t_star = heston_model.moment_explosion_time(
                params, 1.0 + heston_model.INTEGRATION_ALPHA
            )
            if max_maturity >= 0.8 * t_star:
                warnings.append(
                    f"Carr-Madan validity at risk: the 1.75-moment explosion "
                    f"time T*={t_star:.2f} is within 25% of the longest "
                    f"quoted maturity {max_maturity:.2f}; quadrature prices "
                    f"near that horizon are unreliable at these parameters."
                )
        if k > 8.0:
            warnings.append(f"Very high mean-reversion speed: kappa={k:.2f}")
        if s > 1.5:
            warnings.append(f"Very high vol of vol: sigma={s:.2f}")
        if abs(rho) > 0.95:
            warnings.append(f"Extreme correlation: rho={rho:.2f}")
        if v0 > 0.5:
            warnings.append(f"Very high initial variance: v0={v0:.2f}")
        return warnings

    def _store(self, result: CalibrationResult, underlying: str):
        self.db.store_model_parameters(
            model_type="heston",
            underlying=underlying,
            parameters={k: float(getattr(result.params, k)) for k in PARAM_ORDER},
            fit_quality=result.fit_quality,
            maturity=None,
            converged=result.convergence["local_converged"],
            calibration_time_ms=result.convergence["calibration_time_ms"],
        )

    def _load_cached(self, underlying: str) -> Optional[CalibrationResult]:
        cached = self.db.get_latest_model_parameters(
            model_type="heston", underlying=underlying, maturity=None
        )
        if cached and cached.get("converged", False):
            return CalibrationResult(
                params=HestonParams(**{k: cached["parameters"][k] for k in PARAM_ORDER}),
                fit_quality=cached["fit_quality"],
                convergence={"cached": True},
                timestamp=cached["time"],
                warnings=["Using cached parameters"],
            )
        return None

    # ------------------------------------------------------------- fixtures

    @classmethod
    def generate_synthetic_data(
        cls,
        S0: float = 100.0,
        r: float = 0.05,
        q: float = 0.02,
        kappa: float = 2.0,
        theta: float = 0.04,
        sigma: float = 0.3,
        rho: float = -0.7,
        v0: float = 0.04,
        n_strikes: int = 11,
        n_maturities: int = 3,
        noise_std: float = 0.0,
        strikes: Optional[np.ndarray] = None,
        maturities: Optional[np.ndarray] = None,
        seed: int = 0,
        as_dataframe: bool = False,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        """Synthetic surface from known parameters (heston_calibrator.py:736-816),
        priced on ``device`` in ``dtype`` (default: CPU, torch's default
        float)."""
        if strikes is None:
            strikes = np.linspace(0.8 * S0, 1.2 * S0, n_strikes)
        if maturities is None:
            maturities = np.linspace(0.1, 1.0, n_maturities)

        K, T = np.meshgrid(strikes, maturities)
        K, T = K.ravel(), T.ravel()
        params = HestonParams(kappa=kappa, theta=theta, sigma=sigma, rho=rho, v0=v0)
        dtype = dtype or default_float()
        device = device or "cpu"
        priced = heston_model.price_options(
            params, torch.as_tensor(K, dtype=dtype, device=device),
            torch.as_tensor(T, dtype=dtype, device=device), S0, r, q
        )
        prices = priced.cpu().numpy().astype(np.float64)
        # DROP sub-penny quotes instead of flooring them: f32 pricing can go
        # epsilon-negative on deep-OTM short-dated quotes, and a floor
        # fabricates extreme-IV quotes that a spurious basin fits better
        keep = prices >= 0.01
        K, T, prices = K[keep], T[keep], prices[keep]
        if noise_std > 0:
            rng = np.random.default_rng(seed)
            prices = np.maximum(prices * (1 + rng.normal(0, noise_std, len(prices))), 0.01)

        data = {
            "strike": K,
            "maturity": T,
            "mid_price": prices,
            "is_call": np.ones(len(K), dtype=bool),
        }
        if as_dataframe:
            import pandas as pd

            df = pd.DataFrame(data)
            df["option_type"] = "call"
            df["underlying"] = "SYNTHETIC"
            return df
        return data
