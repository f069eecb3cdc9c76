"""Bates jump-diffusion surface calibration, two-stage (DE + multistart LM),
on tensors (twin of ``pde_tpu/calibrate/bates.py``).

Eight parameters (kappa, theta, sigma, rho, v0, lam, mu_j, sigma_j) fitted
to a quote surface with the architecture of the Heston pipeline
(calibrate/heston.py): a differential-evolution global stage that prices
each generation's whole population as one grouped-CF tensor, then a
multistart Levenberg-Marquardt polish with exact ``jacfwd`` Jacobians.
Pricing goes through the Heston quadrature with
:class:`~pde_tpu_torch.models.bates.BatesParams` plugged into its
``cf_reduced_extra`` hook.

Identification: (lam, mu_j, sigma_j) and (sigma, rho, v0) compete for
short-maturity skew, so the pipeline seeds one start from a plain Heston
fit with small jumps attached, beside the top DE members.

Runs on the card unless the caller passes ``device="cpu"``.  The DE draws
come from a ``torch.Generator``, so they differ draw for draw from the
reference's threefry stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.precision import default_float, resolve_device
from ..models import heston as heston_model
from ..models.bates import BatesParams
from .de import differential_evolution
from .lm import levenberg_marquardt

__all__ = ["BatesCalibrationResult", "BatesCalibrator"]

PARAM_ORDER = ("kappa", "theta", "sigma", "rho", "v0", "lam", "mu_j", "sigma_j")


@dataclass
class BatesCalibrationResult:
    params: BatesParams
    fit_quality: Dict[str, float]
    convergence: Dict[str, Any]
    timestamp: datetime
    warnings: List[str] = field(default_factory=list)

    @property
    def success(self) -> bool:
        return bool(self.convergence.get("local_converged", False))

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


def _price_vec(x, strikes, t_idx, unique_T, is_calls, S0, r, q):
    """Prices of parameter vectors ``x`` (..., 8): each field is
    ``x[..., i, None, None]``, so a (P, 8) population broadcasts against
    the pricer's (M, n_u) characteristic-function rows, jump factor
    included, and gives (P, N) prices.

    The CONVERGED composite-GL rule (``heston._accurate_gl_rule``), not the
    reference-parity rectangle sum of the Heston pipeline: Bates has no
    reference grid to reproduce, and the parity rule's truncation bias sits
    in the jump-fattened wings where the jump parameters live.
    """
    p = BatesParams(*(x[..., i, None, None] for i in range(8)))
    return heston_model.price_accurate_gl_grouped(p, strikes, t_idx, unique_T, S0, r, q,
                                                  is_calls)


def _calibrate_pipeline(
    strikes, t_idx, unique_T, is_calls, market_prices, mask, S0, r, q,
    lower, upper, generator: torch.Generator, x0, use_x0: bool,
    global_maxiter: int = 60,
    global_popsize: int = 20,
    local_max_iter: int = 60,
):
    """The full two-stage 8-parameter calibration.

    ``mask`` zeroes padded quote slots out of the objective, the Jacobian
    and the fit metrics, as in the Heston pipeline.  All tensors share one
    device and float dtype; ``generator`` lives on that device.  Returns
    ``(de_x, de_fun, de_n_iter, lm_x, lm_cost, lm_converged, lm_n_iter,
    model_prices)``.
    """

    def objective(pop):  # (P, 8) -> (P,)
        prices = _price_vec(pop, strikes, t_idx, unique_T, is_calls, S0, r, q)
        prices = torch.where(mask > 0, prices, market_prices)
        nan_bad = torch.any(torch.isnan(prices), dim=-1)
        prices = torch.clamp_min(prices, 1e-10)
        errors = mask * (prices - market_prices) / market_prices
        obj = torch.sum(errors * errors, dim=-1)
        return torch.where(nan_bad, torch.full_like(obj, 1e10), obj)

    seed = x0 if use_x0 else 0.5 * (lower + upper)
    de = differential_evolution(objective, lower, upper, generator, x0=seed,
                                popsize=global_popsize, maxiter=global_maxiter,
                                param_tol=1e-2, stagnation_patience=12)

    def residuals(x):
        prices = _price_vec(x, strikes, t_idx, unique_T, is_calls, S0, r, q)
        prices = torch.where(mask > 0, prices, market_prices)
        prices = torch.clamp_min(prices, 1e-10)
        return mask * (prices - market_prices) / market_prices

    k_starts = 4
    order = torch.argsort(de.population_energies)
    # the warm start (a Heston fit plus small jumps) is polished directly
    # even when DE wandered off it
    starts = torch.cat([de.population[order[:k_starts]], seed[None, :]], dim=0)

    # every start polished twice, the second pass with a fresh damping state
    first = levenberg_marquardt(residuals, starts, lower, upper,
                                max_iter=local_max_iter, ftol=1e-8)
    lm_all = levenberg_marquardt(residuals, first.x, lower, upper,
                                 max_iter=local_max_iter, ftol=1e-8)
    best = torch.argmin(lm_all.cost)
    lm_x = lm_all.x[best]
    model_prices = _price_vec(lm_x, strikes, t_idx, unique_T, is_calls, S0, r, q)
    return (de.x, de.fun, de.n_iter, lm_x, lm_all.cost[best],
            lm_all.converged[best], lm_all.n_iter[best], model_prices)


class BatesCalibrator:
    """Two-stage Bates surface calibrator.

    Usage mirrors :class:`~pde_tpu_torch.calibrate.heston.HestonCalibrator`;
    ``warm_start_heston=True`` (default) first runs the 5-parameter Heston
    calibration and seeds the 8-dim search from it with small jumps
    attached.  ``device`` and ``dtype`` set where and in which precision
    both pipelines run (default: the CUDA card, torch's default float;
    ``device="cpu"`` for the CPU).
    """

    DEFAULT_BOUNDS = {
        "kappa": (0.1, 10.0),
        "theta": (0.01, 1.0),
        "sigma": (0.01, 2.0),
        "rho": (-0.99, 0.99),
        "v0": (0.01, 1.0),
        "lam": (0.0, 3.0),
        "mu_j": (-0.5, 0.3),
        "sigma_j": (0.01, 0.8),
    }

    def __init__(
        self,
        bounds: Optional[Dict[str, Tuple[float, float]]] = None,
        global_maxiter: int = 60,
        global_popsize: int = 20,
        local_max_iter: int = 60,
        seed: int = 42,
        warm_start_heston: bool = True,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        self.bounds = bounds or dict(self.DEFAULT_BOUNDS)
        self.global_maxiter = global_maxiter
        self.global_popsize = global_popsize
        self.local_max_iter = local_max_iter
        self.seed = seed
        self.warm_start_heston = warm_start_heston
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()

    def calibrate(
        self,
        strikes,
        maturities,
        market_prices,
        S0: float,
        r: float,
        q: float = 0.0,
        is_calls=None,
        x0: Optional[BatesParams] = None,
    ) -> BatesCalibrationResult:
        strikes = np.asarray(strikes, dtype=np.float64).ravel()
        maturities = np.asarray(maturities, dtype=np.float64).ravel()
        market_prices = np.asarray(market_prices, dtype=np.float64).ravel()
        n = strikes.shape[0]
        if is_calls is None:
            is_calls = np.ones(n, dtype=bool)
        else:
            is_calls = np.asarray(is_calls, dtype=bool).ravel()

        t_start = datetime.now()
        warnings_list: List[str] = []
        dev, dt = self.device, self.dtype

        def tensor(a, dtype=dt):
            return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

        lower = tensor([self.bounds[k][0] for k in PARAM_ORDER])
        upper = tensor([self.bounds[k][1] for k in PARAM_ORDER])

        if x0 is not None:
            seed_x, use_x0 = tensor([float(v) for v in x0]), True
        elif self.warm_start_heston:
            from .heston import HestonCalibrator

            hcal = HestonCalibrator(
                global_maxiter=self.global_maxiter,
                global_popsize=max(8, self.global_popsize // 2),
                local_max_iter=self.local_max_iter,
                seed=self.seed, device=dev, dtype=dt,
            )
            hres = hcal.calibrate(
                {"strike": strikes, "maturity": maturities,
                 "mid_price": market_prices, "is_call": is_calls},
                S0=S0, r=r, q=q,
            )
            hp = hres.params
            seed_x = tensor([
                float(hp.kappa), float(hp.theta), float(hp.sigma),
                float(hp.rho), float(hp.v0),
                0.2, -0.05, 0.15,  # small jumps: near the lam = 0 Heston limit
            ])
            use_x0 = True
            warnings_list.extend(hres.warnings)
        else:
            seed_x, use_x0 = 0.5 * (lower + upper), False

        unique_T, t_idx = heston_model.group_maturities(maturities)
        generator = torch.Generator(device=dev)
        generator.manual_seed(self.seed)
        out = _calibrate_pipeline(
            tensor(strikes), tensor(t_idx, torch.int64), tensor(unique_T),
            tensor(is_calls, torch.bool), tensor(market_prices),
            torch.ones(n, dtype=dt, device=dev), float(S0), float(r), float(q),
            lower, upper, generator, seed_x, use_x0,
            global_maxiter=self.global_maxiter,
            global_popsize=self.global_popsize,
            local_max_iter=self.local_max_iter,
        )
        (de_x, de_fun, de_iter, lm_x, lm_cost, lm_conv, lm_iter,
         model_prices) = (t.cpu().numpy() for t in out)

        params = BatesParams(*(float(v) for v in lm_x))
        model_prices = model_prices.astype(np.float64)
        resid = (model_prices - market_prices) / market_prices
        abs_err = np.abs(model_prices - market_prices)
        ss_res = float(np.sum((model_prices - market_prices) ** 2))
        ss_tot = float(np.sum((market_prices - market_prices.mean()) ** 2))
        fit_quality = {
            "rmse": float(np.sqrt(np.mean(resid**2))),
            "max_error": float(np.max(abs_err)),
            "mean_error": float(np.mean(abs_err)),
            "r_squared": 1.0 - ss_res / ss_tot if ss_tot > 0 else float("nan"),
            "n_options": int(n),
        }
        if not params.feller_satisfied():
            warnings_list.append(
                f"Feller condition violated: 2*kappa*theta - sigma^2 = "
                f"{float(params.feller_value()):.4f} < 0"
            )
        convergence = {
            "global_best_objective": float(de_fun),
            "global_iterations": int(de_iter),
            "local_cost": float(lm_cost),
            "local_converged": bool(lm_conv),
            "local_iterations": int(lm_iter),
            "elapsed_s": (datetime.now() - t_start).total_seconds(),
        }
        return BatesCalibrationResult(
            params=params,
            fit_quality=fit_quality,
            convergence=convergence,
            timestamp=datetime.now(),
            warnings=warnings_list,
        )

    # ------------------------------------------------------------------
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
        lam: float = 0.5,
        mu_j: float = -0.1,
        sigma_j: float = 0.15,
        n_strikes: int = 11,
        n_maturities: int = 3,
        noise_std: float = 0.0,
        seed: int = 0,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ) -> Dict[str, np.ndarray]:
        """Synthetic Bates surface from known parameters, priced on
        ``device`` in ``dtype`` (default: the CUDA card, torch's default
        float)."""
        device = resolve_device(device)
        dtype = dtype or default_float()
        strikes = np.linspace(0.8 * S0, 1.2 * S0, n_strikes)
        maturities = np.linspace(0.1, 1.0, n_maturities)
        K, T = np.meshgrid(strikes, maturities)
        K, T = K.ravel(), T.ravel()
        params = BatesParams(kappa, theta, sigma, rho, v0, lam, mu_j, sigma_j)
        unique_T, t_idx = heston_model.group_maturities(T)
        priced = heston_model.price_accurate_gl_grouped(
            params, torch.as_tensor(K, dtype=dtype, device=device),
            torch.as_tensor(t_idx, dtype=torch.int64, device=device),
            torch.as_tensor(unique_T, dtype=dtype, device=device), S0, r, q, True,
        ).cpu().numpy().astype(np.float64)
        if noise_std > 0:
            rng = np.random.default_rng(seed)
            priced = priced * (1.0 + noise_std * rng.standard_normal(priced.shape))
        # drop sub-premium quotes (deep-OTM short-dated calls under heavy
        # downward jumps price below any realistic tick), as real chains
        # are filtered before calibration
        keep = priced > max(1e-3, 1e-5 * S0)
        return {
            "strike": K[keep],
            "maturity": T[keep],
            "mid_price": priced[keep],
            "is_call": np.ones(int(keep.sum()), dtype=bool),
        }
