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
* :meth:`HestonCalibrator.calibrate_batch` fits U surfaces as one program
  (a surface axis through both stages); :func:`parameter_sensitivities`
  gives each quote's pull on the calibrated parameters.

Runs on the card unless the caller passes ``device="cpu"``; the GPU path
is float32/complex64, the parity tests float64/complex128 on the CPU.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.precision import default_float, device_of, resolve_device, result_dtype
from ..models import black_scholes as bs
from ..models import heston as heston_model
from ..models.heston import HestonParams
from .de import differential_evolution
from .lm import _full_fp32_matmul, levenberg_marquardt

__all__ = ["CalibrationError", "CalibrationResult", "HestonCalibrator",
           "parameter_sensitivities"]

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
                                     n_points=_DE_GL_POINTS, reduce=None):
    """DE-stage objective: sum of squared relative errors per population
    member (reference heston_calibrator.py:486-513) on the corrected-GL
    grid.  ``mask`` zeroes the residuals of padded quote slots.

    DEVIATION (kept from the reference package): non-positive prices are
    clamped to 1e-10, as the reference's own local-stage residuals do
    (:533), instead of the flat 1e10 penalty, which an f32 DE stage would
    hit on deep-OTM short-dated quotes even at the true parameters.  NaN
    still gets the hard penalty.  ``reduce`` (a quote block of a surface
    whose other blocks lie on other ranks) sums the objective and the NaN
    count over the ranks before the penalty is applied."""
    prices = _price_vec_gl_grouped(pop, strikes, t_idx, unique_T, is_calls,
                                   S0, r, q, n_points)          # (..., P, N)
    # neutralize padded slots BEFORE the NaN check: NaN * 0 is NaN
    prices = torch.where(mask > 0, prices, market_prices)
    nan_bad = torch.any(torch.isnan(prices), dim=-1)
    prices = torch.clamp_min(prices, 1e-10)
    errors = mask * (prices - market_prices) / market_prices
    obj = torch.sum(errors * errors, dim=-1)
    if reduce is not None:
        obj, n_bad = reduce(torch.stack([obj, nan_bad.to(obj.dtype)]))
        nan_bad = n_bad > 0
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
    """The full two-stage calibration of one surface: the single-surface
    case of :func:`_calibrate_pipeline_batch`.

    Maturities arrive grouped as ``(t_idx, unique_T)`` from
    :func:`pde_tpu_torch.models.heston.group_maturities`.  ``mask`` (1.0 =
    real quote, 0.0 = padding) weights every residual: padded slots add
    zero to the DE objective, zero rows to the LM Jacobian, and nothing to
    convergence.  All tensors share one device and float dtype;
    ``generator`` lives on that device.

    Returns ``(de_x, de_fun, de_n_iter, lm_x, lm_cost, lm_converged,
    lm_n_iter, model_prices)``, the reference's tuple.
    """
    S0 = torch.as_tensor(S0, dtype=strikes.dtype, device=strikes.device)
    out = _calibrate_pipeline_batch(
        strikes[None], t_idx[None], unique_T[None], is_calls[None],
        market_prices[None], mask[None], S0[None], r, q, lower, upper, generator,
        x0, use_x0, global_maxiter, global_popsize, local_max_iter)
    return tuple(t[0] for t in out)


def _calibrate_pipeline_batch(
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
    shard: Optional["_Shard"] = None,
):
    """The two-stage calibration of U surfaces as one program, the
    reference's ``vmap`` of its pipeline (pde_tpu/calibrate/heston.py:595-610).

    Every quote tensor is (U, N), ``unique_T`` (U, M) (padded to a common
    M), ``S0`` (U,); ``x0`` is (5,) or (U, 5).  The DE runs with a surface
    axis (one objective call a generation prices every surface's
    population); each LM pass is one call on the U x k starts, each start
    given its own surface's quotes through ``data=``; each surface keeps
    the best of its own starts.  Returns the tuple of
    :func:`_calibrate_pipeline`, each entry with a leading U axis.

    ``shard`` runs these U surfaces as one rank's part of a batch laid over
    a mesh (``calibrate_batch(mesh=...)``): the DE draws are the whole
    batch's rows, the objective and the LM's normal equations sum this
    rank's quote block over the quote ranks.
    """
    U = strikes.shape[0]
    qs = slice(None) if shard is None else shard.quotes
    quotes_sum = None if shard is None else shard.quotes_sum

    def objective(pop):  # (U, P, 5) -> (U, P)
        return _objective_population_gl_grouped(
            pop, strikes[:, None, qs], t_idx[:, None, qs], unique_T[:, None],
            is_calls[:, None, qs], market_prices[:, None, qs], mask[:, None, qs],
            S0[:, None, None], r, q, reduce=quotes_sum,
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
        target_energy=1e-4 * torch.sum(mask, dim=-1),
        n_surfaces=U,
        shard=shard,
    )

    def residuals(x, strikes, t_idx, unique_T, is_calls, market_prices, mask, S0):
        prices = _price_vec_gl_grouped(x, strikes, t_idx, unique_T, is_calls, S0, r, q)
        # padded slots must yield an EXACT zero residual even when the CF
        # NaNs there (mask * NaN = NaN would poison the cost and Jacobian)
        prices = torch.where(mask > 0, prices, market_prices)
        prices = torch.clamp_min(prices, 1e-10)  # heston_calibrator.py:533
        return mask * (prices - market_prices) / market_prices

    # MULTISTART local stage: the top-k DE members of each surface (the
    # reference's deviation from a single least_squares, kept) ...
    k_starts = min(4, global_popsize * 5)
    order = torch.argsort(de.population_energies, dim=-1)[:, :k_starts]
    starts = torch.take_along_dim(de.population, order[..., None], dim=1)

    # ... plus one INFORMED start per surface: short-maturity ATM implied
    # variance ~ v0, long-maturity ATM implied variance ~ theta
    T_q = torch.take_along_dim(unique_T, t_idx.long(), dim=-1)
    big = 1e18
    fwd = S0[:, None] * torch.exp((r - q) * T_q)
    # a rough vol level is enough to seed the start — 8 Newton iterations
    iv = bs.implied_vol(market_prices, S0[:, None], strikes, r, q, T_q, is_calls,
                        max_iter=8)
    atm_pen = torch.abs(strikes - fwd) + (1.0 - mask) * big
    t_short = torch.amin(torch.where(mask > 0, T_q, torch.full_like(T_q, big)),
                         dim=-1, keepdim=True)
    t_long = torch.amax(torch.where(mask > 0, T_q, torch.full_like(T_q, -big)),
                        dim=-1, keepdim=True)
    i_short = torch.argmin(atm_pen + big * (T_q != t_short), dim=-1, keepdim=True)
    i_long = torch.argmin(atm_pen + big * (T_q != t_long), dim=-1, keepdim=True)
    const = lambda c: torch.full((U,), c, dtype=strikes.dtype, device=strikes.device)  # noqa: E731
    informed = torch.stack([const(2.0), torch.take_along_dim(iv, i_long, -1)[:, 0] ** 2,
                            const(0.5), const(-0.5),
                            torch.take_along_dim(iv, i_short, -1)[:, 0] ** 2], dim=-1)
    informed = torch.clamp(informed, lower, upper)
    informed = torch.where(torch.isfinite(informed), informed, 0.5 * (lower + upper))
    starts = torch.cat([starts, informed[:, None, :]], dim=1)  # (U, k + 1, 5)
    n_starts = starts.shape[1]

    # two chained LM passes with a FRESH damping state: long descents
    # through the ill-conditioned kappa-sigma ridge inflate lambda; the
    # restart from the first pass's iterate reaches the optimum quickly
    data = tuple(t.repeat_interleave(n_starts, dim=0) for t in
                 (strikes[:, qs], t_idx[:, qs], unique_T, is_calls[:, qs],
                  market_prices[:, qs], mask[:, qs], S0))
    first = levenberg_marquardt(residuals, starts.reshape(U * n_starts, 5), lower, upper,
                                max_iter=local_max_iter, ftol=1e-8, data=data,
                                reduce=quotes_sum)
    lm_all = levenberg_marquardt(residuals, first.x, lower, upper,
                                 max_iter=local_max_iter, ftol=1e-8, data=data,
                                 reduce=quotes_sum)
    best = torch.argmin(lm_all.cost.reshape(U, n_starts), dim=-1)
    rows = torch.arange(U, device=best.device) * n_starts + best
    lm_x = lm_all.x[rows]

    # reported prices stay on the LITERAL reference grid; only the optimizer
    # hot loops use the corrected-GL rule
    model_prices = _price_vec_grouped(lm_x, strikes, t_idx, unique_T, is_calls,
                                      S0[:, None], r, q)
    return (de.x, de.fun, de.n_iter, lm_x, lm_all.cost[rows],
            lm_all.converged[rows], lm_all.n_iter[rows], model_prices)


class _Shard(NamedTuple):
    """One rank's part of a batch of surfaces laid over a (dp, quotes)
    mesh: the rows of the whole batch's DE draws that its surfaces take
    (``draw_rows``, of ``n_surfaces``), its quote block (``quotes``), the
    sum over its quote ranks (``quotes_sum``) and whether a surface of any
    rank is still in its DE (``running``)."""

    n_surfaces: int
    draw_rows: torch.Tensor
    quotes: slice
    quotes_sum: Optional[Callable[[torch.Tensor], torch.Tensor]]
    running: Callable[[torch.Tensor], bool]


def _sensitivities_impl(x, strikes, t_idx, unique_T, is_calls, market_prices,
                        mask, S0, r, q):
    """d(calibrated params)/d(market prices) at the LM optimum, by the
    implicit function theorem on the Gauss-Newton normal equations.

    Residuals are the pipeline's relative errors r_i = m_i(x)/p_i - 1, so
    the stationarity condition J^T r = 0 differentiates to

        dx*/dp = -(J^T J)^{-1} J^T  diag(dr/dp),   dr_i/dp_i = -m_i / p_i^2.

    The Jacobian is exact, by forward-mode AD through the same corrected-GL
    grouped pricer as the LM's residuals.  Returns ``(dxdp (5, N), model
    prices (N,), J^T J (5, 5))``.
    """

    def model(xv):
        return torch.clamp_min(
            _price_vec_gl_grouped(xv, strikes, t_idx, unique_T, is_calls, S0, r, q), 1e-10)

    m = model(x)
    with _full_fp32_matmul():  # TF32 would swamp the ill-conditioned J^T J
        Jm = torch.func.jacfwd(model)(x)             # (N, 5) dm/dx
        J = Jm * (mask / market_prices)[:, None]     # (N, 5) dr/dx
        JTJ = J.T @ J
    drdp = -mask * m / (market_prices ** 2)          # (N,) dr_i/dp_i
    rhs = J.T * drdp[None, :]                        # (5, N)
    ridge = 1e-12 * torch.trace(JTJ) * torch.eye(5, dtype=JTJ.dtype, device=JTJ.device)
    dxdp = -torch.linalg.solve(JTJ + ridge, rhs)     # (5, N)
    return dxdp, m, JTJ


def parameter_sensitivities(params, strikes, maturities, is_calls, market_prices,
                            S0, r, q=0.0, quote_noise_rel: float = 0.0,
                            device=None, dtype: Optional[torch.dtype] = None):
    """Quote-level sensitivities of a calibrated parameter set.

    Returns a dict of numpy arrays:

    * ``dparams_dprice`` — (5, N): first-order response of
      (kappa, theta, sigma, rho, v0) to a unit bump of each market price;
    * ``model_prices`` — (N,): the corrected-GL prices at ``params``;
    * ``influence`` — (N,): L2 norm of each quote's parameter response
      scaled by 1% of its price (which quotes move the calibration);
    * ``param_cov`` / ``param_std`` — Gauss-Newton parameter covariance for
      i.i.d. relative price noise ``quote_noise_rel`` (omitted when 0).

    Computed on ``params``' tensors' device, else on ``device`` (default:
    the CUDA card), in ``dtype`` (default: the fields' type, at least
    torch's default float).
    """
    device = device_of(*params, default=device)
    dtype = dtype or result_dtype(*params)
    strikes = np.asarray(strikes, dtype=np.float64)
    market_prices = np.asarray(market_prices, dtype=np.float64)
    unique_T, t_idx = heston_model.group_maturities(maturities)

    def tensor(a, dt=dtype):
        return torch.as_tensor(np.array(a), dtype=dt, device=device)

    x = torch.stack([torch.as_tensor(getattr(params, k), dtype=dtype, device=device)
                     for k in PARAM_ORDER])
    dxdp, model_prices, _ = _sensitivities_impl(
        x, tensor(strikes), tensor(t_idx, torch.int64), tensor(unique_T),
        tensor(np.asarray(is_calls, dtype=bool), torch.bool), tensor(market_prices),
        torch.ones(len(strikes), dtype=dtype, device=device), S0, r, q)
    dxdp, model_prices = dxdp.cpu().numpy(), model_prices.cpu().numpy()
    out = {
        "dparams_dprice": dxdp,
        "model_prices": model_prices,
        "influence": np.linalg.norm(dxdp * 0.01 * market_prices[None, :], axis=0),
    }
    if quote_noise_rel > 0.0:
        sig = quote_noise_rel * market_prices
        cov = (dxdp * sig[None, :] ** 2) @ dxdp.T
        out["param_cov"] = cov
        out["param_std"] = np.sqrt(np.maximum(np.diag(cov), 0.0))
    return out


class HestonCalibrator:
    """Two-stage Heston calibrator (API parity with the reference class).

    ``db`` is any object exposing ``store_model_parameters`` /
    ``get_latest_model_parameters``.  ``device`` and ``dtype`` set where and
    in which precision the pipeline runs (default: the CUDA card, torch's
    default float; ``device="cpu"`` for the CPU).
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
        self.device = resolve_device(device)
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

    def calibrate_batch(
        self,
        strikes,
        maturities,
        market_prices,
        S0,
        r: float,
        q: float,
        is_calls=None,
        mesh=None,
    ):
        """Calibrate MANY surfaces at once: all inputs carry a leading
        surfaces axis, (U, n_options) and (U,) for ``S0``.

        The U pipelines run as one program (:func:`_calibrate_pipeline_batch`):
        each DE generation prices every surface's population in one call,
        each LM pass polishes all U x k starts in one call.  Returns a dict
        of tensors on the calibrator's device: ``params`` (U, 5), ``cost``,
        ``converged``, ``model_prices`` (U, n_options), and the DE
        generations ``de_n_iter`` and LM iterations ``lm_n_iter`` of each
        surface.

        ``mesh`` (a ``DeviceMesh`` with dimensions ``dp`` and ``quotes``,
        ``parallel.make_mesh``; every rank calls with the same global
        arguments) lays the U surfaces over ``dp`` and each surface's
        quotes over ``quotes``: the DE objective and the LM's normal
        equations are summed over the quote ranks (``all_reduce``), and the
        U rows are gathered over ``dp``, so every rank returns the whole
        batch.  When dp does not divide U the batch is padded with copies
        of the last surface (results sliced back to U), as the reference
        does; n_options must divide by the quotes size.  The DE draws are
        the unmeshed call's rows (a padded copy takes its surface's), and
        every rank runs the same generations, so the meshed fit equals the
        unmeshed one up to the order of the quote sums.  The mesh's device
        must be the calibrator's.
        """
        dev, dt = self.device, self.dtype

        def tensor(a, dtype=dt):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        strikes = np.asarray(strikes, dtype=np.float64)
        if is_calls is None:
            is_calls = np.ones(strikes.shape, dtype=bool)
        U = strikes.shape[0]
        shard, in_mesh = None, contextlib.nullcontext()
        if mesh is not None:
            from ..parallel.mesh import using_mesh  # parallel imports the LM

            shard, (strikes, maturities, market_prices, S0, is_calls) = self._shard_batch(
                mesh, strikes, maturities, market_prices, S0, is_calls)
            in_mesh = using_mesh(mesh)  # the mesh the shard's collectives run over
        lower = tensor([self.bounds[k][0] for k in PARAM_ORDER])
        upper = tensor([self.bounds[k][1] for k in PARAM_ORDER])
        generator = torch.Generator(device=dev)
        generator.manual_seed(self.seed)

        # per-surface maturity grouping, padded to a common M (padded CF
        # rows are priced by no option)
        grouped = [heston_model.group_maturities(m) for m in np.asarray(maturities)]
        max_m = max(len(uT) for uT, _ in grouped)
        unique_T = np.stack([np.concatenate([uT, np.full(max_m - len(uT), uT[-1])])
                             for uT, _ in grouped])
        t_idx = np.stack([idx for _, idx in grouped])
        with in_mesh:
            (_, _, de_iter, lm_x, lm_cost, lm_conv, lm_iter,
             model_prices) = _calibrate_pipeline_batch(
                tensor(strikes), tensor(t_idx, torch.int64), tensor(unique_T),
                tensor(is_calls, torch.bool), tensor(market_prices),
                torch.ones(strikes.shape, dtype=dt, device=dev), tensor(S0), float(r),
                float(q), lower, upper, generator, torch.zeros(5, dtype=dt, device=dev),
                False, global_maxiter=self.global_maxiter,
                global_popsize=self.global_popsize, local_max_iter=self.local_max_iter,
                shard=shard)
        out = {"params": lm_x, "cost": lm_cost, "converged": lm_conv,
               "model_prices": model_prices, "de_n_iter": de_iter, "lm_n_iter": lm_iter}
        if mesh is None:
            return out
        if "dp" in mesh.mesh_dim_names:
            from ..parallel.mesh import all_gather

            # the dp blocks' rows, gathered on every rank
            out = {k: all_gather(v.long() if v.dtype == torch.bool else v, mesh, "dp")
                   .to(v.dtype) for k, v in out.items()}
        return {k: v[:U] for k, v in out.items()}

    def _shard_batch(self, mesh, strikes, maturities, market_prices, S0, is_calls):
        """This rank's surfaces of a batch laid over ``mesh`` (padded as the
        reference pads), and the :class:`_Shard` its pipeline runs with."""
        from ..parallel.mesh import axis_index, axis_size, mesh_device, on_mesh_device, psum

        if not on_mesh_device(mesh, self.device):
            raise ValueError(f"the mesh's device {mesh_device(mesh)} is not the "
                             f"calibrator's {self.device}")
        names = mesh.mesh_dim_names
        n_dp = axis_size(mesh, "dp") if "dp" in names else 1
        n_q = axis_size(mesh, "quotes") if "quotes" in names else 1
        i_dp = axis_index(mesh, "dp") if "dp" in names else 0
        i_q = axis_index(mesh, "quotes") if "quotes" in names else 0
        U, Q = strikes.shape
        if Q % n_q:
            raise ValueError(f"n_options {Q} not divisible by the quotes size {n_q}")
        u_pad = U + (-U) % n_dp
        m_u, m_q = u_pad // n_dp, Q // n_q
        # padded rows are copies of the last surface, with its draws
        rows = np.minimum(np.arange(i_dp * m_u, (i_dp + 1) * m_u), U - 1)

        quotes_sum = (lambda t: psum(t, "quotes")) if n_q > 1 else None  # noqa: E731
        if n_dp > 1:
            running = lambda done: bool(psum((~done).sum().to(self.dtype), "dp") > 0)  # noqa: E731
        else:
            running = lambda done: not bool(torch.all(done))  # noqa: E731
        shard = _Shard(U, torch.as_tensor(rows, device=self.device),
                       slice(i_q * m_q, (i_q + 1) * m_q), quotes_sum, running)
        return shard, tuple(np.asarray(a)[rows] for a in
                            (strikes, maturities, market_prices, S0, is_calls))

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
        priced on ``device`` in ``dtype`` (default: the CUDA card, torch's
        default float)."""
        if strikes is None:
            strikes = np.linspace(0.8 * S0, 1.2 * S0, n_strikes)
        if maturities is None:
            maturities = np.linspace(0.1, 1.0, n_maturities)

        K, T = np.meshgrid(strikes, maturities)
        K, T = K.ravel(), T.ravel()
        params = HestonParams(kappa=kappa, theta=theta, sigma=sigma, rho=rho, v0=v0)
        dtype = dtype or default_float()
        device = resolve_device(device)
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
