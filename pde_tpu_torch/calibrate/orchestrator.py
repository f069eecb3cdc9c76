"""Daily calibration orchestrator (twin of
``pde_tpu/calibrate/orchestrator.py``).

Drives Heston + SABR + OU calibration per underlying with option filtering,
warm starts from the previous run, per-model isolation producing a
SUCCESS/PARTIAL/FAILED status, quality gates, parameter persistence and
cached-parameter retrieval.  Opt-in stages drive the refinement desks
(rough Heston, Bates) and the rates/credit desks: the Hull-White
caplet/swaption fit, the G2++ swaption-panel fit and the CDS hazard
bootstrap, each with the same warm-start/gate/persistence contract, keyed
under model_type 'hull_white' / 'g2pp' / 'cds_hazard' in the store.

Host-side control flow by design: the math runs inside each calibrator on
the orchestrator's ``device`` (default: the CUDA card) in its ``dtype``
(default: each calibrator's own), passed to every calibrator it builds.
A stage's failure is recorded in the run's ``errors`` (its message) and
degrades the run to PARTIAL, as in the reference; ``db`` is duck-typed.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.precision import resolve_device, result_dtype
from ..models.rates import DiscountCurve
from .heston import CalibrationError, HestonCalibrator
from .ou import OUFitter
from .sabr import SABRCalibrator

_log = logging.getLogger(__name__)

__all__ = [
    "CalibrationStatus",
    "CalibrationConfig",
    "CalibrationRunResult",
    "CalibrationOrchestrator",
]


def _stage_failed(errors: List[str], stage: str, exc: Exception) -> None:
    """Record a stage's failure in the run's errors (the run degrades to
    PARTIAL, as in the reference) with the exception's type, and log its
    traceback: a card fault inside a stage shows in both."""
    _log.warning("calibration stage %s failed", stage, exc_info=exc)
    errors.append(f"{stage}: {type(exc).__name__}: {exc}")


class CalibrationStatus(str, Enum):
    SUCCESS = "SUCCESS"
    PARTIAL = "PARTIAL"
    FAILED = "FAILED"


@dataclass
class CalibrationConfig:
    """Run configuration (the reference's fields and defaults)."""

    calibrate_heston: bool = True
    calibrate_sabr: bool = True
    calibrate_ou: bool = False  # needs spread series, opt-in
    calibrate_rough: bool = False  # rough Heston refinement, opt-in
    calibrate_bates: bool = False  # Bates jump-diffusion refinement, opt-in
    calibrate_rates: bool = False  # Hull-White caplet/swaption fit, opt-in
    calibrate_g2: bool = False  # G2++ swaption-panel fit, opt-in
    calibrate_credit: bool = False  # CDS hazard bootstrap, opt-in
    max_options_per_underlying: int = 100
    min_options_required: int = 5
    use_warm_start: bool = True
    use_cached_on_failure: bool = True
    max_rmse: float = 5.0
    min_r_squared: float = 0.5
    # rates/credit quality gates: relative price error on the instrument
    # strip (HW/G2), and the bootstrap's reprice round-trip error (credit,
    # exact by construction: the gate catches non-finite/negative hazards).
    # None = precision-aware default from the curve's dtype: 1e-6 in
    # float64, 5e-4 otherwise (Newton exactness is precision-bound)
    max_rates_rel_error: float = 0.05
    max_credit_roundtrip_error: Optional[float] = None
    risk_free_rate: float = 0.05
    dividend_yield: float = 0.0


@dataclass
class CalibrationRunResult:
    """Per-run outcome."""

    underlying: str
    status: CalibrationStatus
    heston_result: Optional[Any] = None
    sabr_result: Optional[Any] = None
    ou_result: Optional[Any] = None
    rough_result: Optional[Any] = None
    bates_result: Optional[Any] = None
    rates_result: Optional[Any] = None
    g2_result: Optional[Any] = None
    credit_result: Optional[Any] = None
    errors: List[str] = field(default_factory=list)
    run_time: float = 0.0
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    @property
    def success(self) -> bool:
        return self.status == CalibrationStatus.SUCCESS


class CalibrationOrchestrator:
    """Drives per-underlying daily calibration across all models.

    ``device`` and ``dtype`` go to every calibrator the orchestrator builds
    (calibrators passed in keep their own); the credit stage runs on
    ``device`` in ``dtype``, else in its curve's dtype.
    """

    def __init__(
        self,
        config: Optional[CalibrationConfig] = None,
        db=None,
        heston_calibrator: Optional[HestonCalibrator] = None,
        sabr_calibrator: Optional[SABRCalibrator] = None,
        ou_fitter: Optional[OUFitter] = None,
        rough_calibrator=None,
        bates_calibrator=None,
        rates_calibrator=None,
        g2_calibrator=None,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        self.config = config or CalibrationConfig()
        self.db = db
        self.device = resolve_device(device)
        self.dtype = dtype
        where = dict(device=self.device, dtype=dtype)
        self.heston = heston_calibrator or HestonCalibrator(db=db, **where)
        self.sabr = sabr_calibrator or SABRCalibrator(db_session=db, **where)
        self.ou = ou_fitter or OUFitter(db_session=db, **where)
        self.rough = rough_calibrator  # built when the stage first runs
        if self.rough is None and self.config.calibrate_rough:
            self.rough = self._build_rough()
        self.bates = bates_calibrator  # built when the stage first runs
        if self.bates is None and self.config.calibrate_bates:
            self.bates = self._build_bates()
        self.rates = rates_calibrator  # built when the stage first runs
        self.g2 = g2_calibrator  # built when the stage first runs
        # warm-start caches: previous successful parameters per underlying
        self._heston_warm: Dict[str, Dict[str, float]] = {}
        self._sabr_warm: Dict[str, Dict[float, Dict[str, float]]] = {}
        self._hw_warm: Dict[str, tuple] = {}
        self._g2_warm: Dict[str, tuple] = {}

    def _build_rough(self):
        from .rough import RoughHestonCalibrator

        return RoughHestonCalibrator(device=self.device, dtype=self.dtype)

    def _build_bates(self):
        from .bates import BatesCalibrator

        return BatesCalibrator(device=self.device, dtype=self.dtype)

    # ------------------------------------------------------------------ API

    def run_daily_calibration(
        self,
        underlying: str,
        market_options,
        S0: float,
        spread_series: Optional[np.ndarray] = None,
        r: Optional[float] = None,
        q: Optional[float] = None,
        rates_market: Optional[Dict[str, Any]] = None,
        credit_market: Optional[Dict[str, Any]] = None,
    ) -> CalibrationRunResult:
        """Calibrate all enabled models for one underlying.

        ``rates_market`` feeds the opt-in Hull-White/G2++ stages:
        ``{"curve": DiscountCurve, "caplets": {starts, ends, strikes,
        quotes}}`` and/or ``{"swaptions": {expiries, pay_times, strikes,
        quotes}}`` (HW prefers caplets, G2 needs swaptions).
        ``credit_market`` feeds the opt-in CDS hazard bootstrap:
        ``{"curve": DiscountCurve, "pillars": ..., "spreads": ...,
        "recovery": 0.4}`` (curve falls back to rates_market's).
        """
        start = time.time()
        r = self.config.risk_free_rate if r is None else r
        q = self.config.dividend_yield if q is None else q
        errors: List[str] = []
        heston_result = sabr_result = ou_result = None

        options_stages_on = (
            self.config.calibrate_heston or self.config.calibrate_sabr
            or self.config.calibrate_rough or self.config.calibrate_bates
        )
        market_options = self._filter_options(market_options)
        n_options = self._n_options(market_options)
        if options_stages_on and n_options < self.config.min_options_required:
            return CalibrationRunResult(
                underlying=underlying,
                status=CalibrationStatus.FAILED,
                errors=[f"only {n_options} options; need >= {self.config.min_options_required}"],
                run_time=time.time() - start,
            )

        if self.config.calibrate_heston:
            try:
                warm = self._heston_warm.get(underlying) if self.config.use_warm_start else None
                heston_result = self.heston.calibrate(
                    market_options, S0=S0, r=r, q=q, warm_start=warm,
                    use_cached_on_failure=self.config.use_cached_on_failure,
                    underlying=underlying,
                )
                if self._heston_quality_ok(heston_result):
                    self._heston_warm[underlying] = {
                        k: float(getattr(heston_result.params, k))
                        for k in ("kappa", "theta", "sigma", "rho", "v0")
                    }
                else:
                    errors.append(f"heston quality gate failed: rmse={heston_result.rmse:.4f}")
            except (CalibrationError, ValueError) as exc:
                errors.append(f"heston: {exc}")

        if self.config.calibrate_sabr:
            try:
                sabr_input = self._to_sabr_input(market_options, S0, r, q)
                if sabr_input is None:
                    errors.append("sabr: skipped — fewer than 3 valid implied vols "
                                  "after BS inversion")
                else:
                    warm = self._sabr_warm.get(underlying) if self.config.use_warm_start else None
                    sabr_result = self.sabr.calibrate(
                        sabr_input, F0=S0, r=r, q=q, warm_start=warm, underlying=underlying)
                    if sabr_result.success:
                        self._sabr_warm[underlying] = {
                            T: {"alpha": float(p.alpha), "rho": float(p.rho),
                                "nu": float(p.nu)}
                            for T, p in sabr_result.params_by_maturity.items()
                        }
            except Exception as exc:  # noqa: BLE001 - per-model isolation
                _stage_failed(errors, "sabr", exc)

        if self.config.calibrate_ou and spread_series is not None:
            try:
                ou_result = self.ou.fit(spread_series, pair_name=underlying)
                if not ou_result.success:
                    errors.append(f"ou: {ou_result.message}")
            except Exception as exc:  # noqa: BLE001 - per-model isolation
                _stage_failed(errors, "ou", exc)

        rough_result = None
        if self.config.calibrate_rough:
            try:
                if self.rough is None:
                    self.rough = self._build_rough()
                # warm-start the 6-parameter rough fit from today's classic
                # fit (H seeded at 0.25): the rough surface refines the
                # classic one rather than re-searching the whole space
                classic = getattr(heston_result, "params", None)
                rough_result = self.rough.calibrate_quotes(
                    market_options, S0=S0, r=r, q=q, classic_params=classic)
                if rough_result.rmse > self.config.max_rmse:
                    errors.append(f"rough quality gate failed: rmse={rough_result.rmse:.4f}")
            except Exception as exc:  # noqa: BLE001 - per-model isolation
                _stage_failed(errors, "rough", exc)

        bates_result = None
        if self.config.calibrate_bates:
            try:
                if self.bates is None:
                    self.bates = self._build_bates()
                # seed the 8-parameter fit from today's classic fit with
                # small jumps attached (near the lam=0 Heston limit), and
                # skip the calibrator's own warm-start Heston fit
                ks, ts, ps, ic = self._quote_arrays(market_options)
                x0 = None
                classic = getattr(heston_result, "params", None)
                if classic is not None:
                    from ..models.bates import BatesParams

                    x0 = BatesParams(float(classic.kappa), float(classic.theta),
                                     float(classic.sigma), float(classic.rho),
                                     float(classic.v0), 0.2, -0.05, 0.15)
                bates_result = self.bates.calibrate(ks, ts, ps, S0=S0, r=r, q=q,
                                                    is_calls=ic, x0=x0)
                if bates_result.rmse > self.config.max_rmse:
                    errors.append(f"bates quality gate failed: rmse={bates_result.rmse:.4f}")
            except Exception as exc:  # noqa: BLE001 - per-model isolation
                _stage_failed(errors, "bates", exc)

        rates_result = None
        if self.config.calibrate_rates and rates_market is not None:
            try:
                rates_result = self._run_rates_stage(underlying, rates_market, errors)
            except Exception as exc:  # noqa: BLE001 - per-model isolation
                _stage_failed(errors, "rates", exc)

        g2_result = None
        if self.config.calibrate_g2 and rates_market is not None:
            try:
                g2_result = self._run_g2_stage(underlying, rates_market, errors)
            except Exception as exc:  # noqa: BLE001 - per-model isolation
                _stage_failed(errors, "g2", exc)

        credit_result = None
        if self.config.calibrate_credit and credit_market is not None:
            try:
                credit_result = self._run_credit_stage(underlying, credit_market,
                                                       rates_market, errors)
            except Exception as exc:  # noqa: BLE001 - per-model isolation
                _stage_failed(errors, "credit", exc)

        n_requested = (
            int(self.config.calibrate_heston)
            + int(self.config.calibrate_sabr)
            + int(self.config.calibrate_ou and spread_series is not None)
            + int(self.config.calibrate_rough)
            + int(self.config.calibrate_bates)
            + int(self.config.calibrate_rates and rates_market is not None)
            + int(self.config.calibrate_g2 and rates_market is not None)
            + int(self.config.calibrate_credit and credit_market is not None)
        )
        n_ok = sum(x is not None for x in
                   (heston_result, sabr_result, ou_result, rough_result,
                    bates_result, rates_result, g2_result, credit_result))
        if n_ok == n_requested and not errors:
            status = CalibrationStatus.SUCCESS
        elif n_ok > 0:
            status = CalibrationStatus.PARTIAL
        else:
            status = CalibrationStatus.FAILED

        return CalibrationRunResult(
            underlying=underlying, status=status, heston_result=heston_result,
            sabr_result=sabr_result, ou_result=ou_result, rough_result=rough_result,
            bates_result=bates_result, rates_result=rates_result, g2_result=g2_result,
            credit_result=credit_result, errors=errors, run_time=time.time() - start,
        )

    def run_all(self, tasks: Dict[str, Dict], concurrent: bool = False,
                max_workers: int = 4) -> Dict[str, CalibrationRunResult]:
        """Calibrate many underlyings: {name: {market_options, S0, ...}}.

        ``concurrent=True`` runs them on a thread pool, each thread
        launching onto the same device; per-underlying failures degrade
        independently either way.
        """
        if not concurrent:
            return {name: self.run_daily_calibration(underlying=name, **kwargs)
                    for name, kwargs in tasks.items()}
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            futures = {name: pool.submit(self.run_daily_calibration, underlying=name, **kwargs)
                       for name, kwargs in tasks.items()}
            return {name: f.result() for name, f in futures.items()}

    def get_cached_parameters(self, underlying: str, model_type: str = "heston"):
        """Latest stored parameters."""
        if self.db is None:
            return None
        return self.db.get_latest_model_parameters(
            model_type=model_type, underlying=underlying, maturity=None)

    # ------------------------------------------------------------ internals

    def _store(self, model_type, underlying, parameters, fit_quality, converged, t0):
        if self.db is not None:
            self.db.store_model_parameters(
                model_type=model_type, underlying=underlying, parameters=parameters,
                fit_quality=fit_quality, maturity=None, converged=converged,
                calibration_time_ms=int((time.time() - t0) * 1000))

    def _run_rates_stage(self, underlying, rates_market, errors):
        """Hull-White (a, sigma) fit: caplet strip preferred, swaption panel
        otherwise.  Warm-started from the previous successful fit, gated on
        max relative price error, persisted under model_type
        'hull_white'."""
        from .rates import HullWhiteCalibrator

        if self.rates is None:
            self.rates = HullWhiteCalibrator(device=self.device, dtype=self.dtype)
        curve = rates_market["curve"]
        warm = self._hw_warm.get(underlying) if self.config.use_warm_start else None
        t0 = time.time()
        if "caplets" in rates_market:
            c = rates_market["caplets"]
            result = self.rates.calibrate_caplets(curve, c["starts"], c["ends"], c["strikes"],
                                                  c["quotes"], x0=warm)
        elif "swaptions" in rates_market:
            s = rates_market["swaptions"]
            result = self.rates.calibrate_swaptions(curve, s["expiries"], s["pay_times"],
                                                    s["strikes"], s["quotes"], x0=warm)
        else:
            raise ValueError("rates_market needs a 'caplets' or 'swaptions' block")
        if result.max_rel_error <= self.config.max_rates_rel_error:
            a, sigma = float(result.params.a), float(result.params.sigma)
            self._hw_warm[underlying] = (a, sigma)
            self._store("hull_white", underlying, {"a": a, "sigma": sigma},
                        {"rmse": result.rmse, "max_rel_error": result.max_rel_error},
                        result.converged, t0)
        else:
            errors.append(f"rates quality gate failed: "
                          f"max_rel_error={result.max_rel_error:.4f}")
        return result

    def _run_g2_stage(self, underlying, rates_market, errors):
        """G2++ five-parameter swaption-panel fit; warm starts, gate and
        persistence mirror the Hull-White stage (model_type 'g2pp')."""
        from .g2 import G2Calibrator

        if self.g2 is None:
            self.g2 = G2Calibrator(device=self.device, dtype=self.dtype)
        if "swaptions" not in rates_market:
            raise ValueError("g2 stage needs rates_market['swaptions']")
        s = rates_market["swaptions"]
        warm = self._g2_warm.get(underlying) if self.config.use_warm_start else None
        t0 = time.time()
        result = self.g2.calibrate_swaptions(rates_market["curve"], s["expiries"],
                                             s["pay_times"], s["strikes"], s["quotes"], x0=warm)
        if result.max_rel_error <= self.config.max_rates_rel_error:
            names = ("a", "b", "sigma", "eta", "rho")
            fitted = {k: float(getattr(result.params, k)) for k in names}
            self._g2_warm[underlying] = tuple(fitted[k] for k in names)
            self._store("g2pp", underlying, fitted,
                        {"rmse": result.rmse, "max_rel_error": result.max_rel_error},
                        result.converged, t0)
        else:
            errors.append(f"g2 quality gate failed: max_rel_error={result.max_rel_error:.4f}")
        return result

    def _run_credit_stage(self, underlying, credit_market, rates_market, errors):
        """CDS hazard bootstrap (``models/credit.bootstrap_hazard``), exact
        by construction, so the gate is the reprice round-trip plus hazard
        positivity.  Returns ``{"hazard_curve", "hazards",
        "max_roundtrip_error"}``; hazards persist under 'cds_hazard' with
        the pillar grid in the parameter dict."""
        from ..models import credit as credit_mod

        curve = credit_market.get("curve")
        if curve is None and rates_market is not None:
            curve = rates_market.get("curve")
        if curve is None:
            raise ValueError("credit stage needs a discount curve")
        dtype = self.dtype or result_dtype(curve.dfs)
        curve = DiscountCurve(*(torch.as_tensor(v, dtype=dtype, device=self.device)
                                for v in curve))
        pillars = np.asarray(credit_market["pillars"], dtype=float)
        spreads = np.asarray(credit_market["spreads"], dtype=float)
        recovery = float(credit_market.get("recovery", 0.4))
        t0 = time.time()
        hc, hazards = credit_mod.bootstrap_hazard(
            curve, pillars, torch.as_tensor(spreads, dtype=dtype, device=self.device),
            recovery=recovery)
        reprice = credit_mod.cds_par_spreads(curve, hc, pillars, recovery=recovery)
        # one transfer of the pillar strip and the hazards
        reprice, hz = (t.detach().cpu().numpy().astype(np.float64) for t in (reprice, hazards))
        max_rt = float(np.max(np.abs(reprice / spreads - 1.0)))
        tol = self.config.max_credit_roundtrip_error
        if tol is None:
            tol = 1e-6 if dtype == torch.float64 else 5e-4
        ok = bool(np.all(np.isfinite(hz)) and np.all(hz > 0) and max_rt <= tol)
        if ok:
            self._store("cds_hazard", underlying,
                        {"pillars": pillars.tolist(), "hazards": hz.tolist(),
                         "recovery": recovery},
                        {"max_roundtrip_error": max_rt}, True, t0)
        else:
            errors.append(f"credit quality gate failed: max_roundtrip_error={max_rt:.2e}, "
                          f"min_hazard={float(np.min(hz)):.2e}")
        return {"hazard_curve": hc, "hazards": hz, "max_roundtrip_error": max_rt}

    def _heston_quality_ok(self, result) -> bool:
        fq = result.fit_quality
        return (fq.get("rmse", np.inf) <= self.config.max_rmse
                and fq.get("r_squared", 0.0) >= self.config.min_r_squared)

    @staticmethod
    def _n_options(market_options) -> int:
        if hasattr(market_options, "__len__") and not isinstance(market_options, dict):
            return len(market_options)
        return len(np.asarray(market_options["strike"]))

    def _filter_options(self, market_options):
        """Cap the option count: keep the most liquid (by volume if present)
        else the closest-to-money quotes."""
        max_n = self.config.max_options_per_underlying
        n = self._n_options(market_options)
        if n <= max_n:
            return market_options
        if hasattr(market_options, "nlargest") and "volume" in market_options.columns:
            return market_options.nlargest(max_n, "volume")
        if hasattr(market_options, "iloc"):
            # no liquidity info: keep the closest-to-money quotes, where the
            # calibration signal is
            spot_proxy = float(np.median(market_options["strike"]))
            dist = (market_options["strike"] - spot_proxy).abs()
            return market_options.loc[dist.nsmallest(max_n).index]
        strikes = np.asarray(market_options["strike"], dtype=float)
        spot_proxy = float(np.median(strikes))
        keep = np.argsort(np.abs(strikes - spot_proxy))[:max_n]
        return {
            k: (np.asarray(v)[keep] if np.ndim(v) >= 1
                and np.shape(np.asarray(v))[0] == len(strikes) else v)
            for k, v in market_options.items()
        }

    @staticmethod
    def _quote_arrays(market_options):
        """Flat (strikes, maturities, mid_prices, is_calls) arrays from a
        quote table (DataFrame or dict-of-arrays)."""
        if hasattr(market_options, "columns"):
            get = lambda c: market_options[c].to_numpy()  # noqa: E731
            has = lambda c: c in market_options.columns  # noqa: E731
        else:
            get = lambda c: np.asarray(market_options[c])  # noqa: E731
            has = lambda c: c in market_options  # noqa: E731
        strikes = get("strike").astype(float)
        mats = get("maturity").astype(float)
        prices = get("mid_price").astype(float)
        is_calls = (get("is_call").astype(bool) if has("is_call")
                    else np.ones(len(strikes), dtype=bool))
        return strikes, mats, prices, is_calls

    def _to_sabr_input(self, market_options, S0, r, q):
        """The SABR (strike, T, implied_vol) table from option prices by BS
        inversion (on the orchestrator's device) when implied vols are not
        provided."""
        from ..models import black_scholes as bs_mod

        if hasattr(market_options, "columns"):
            if "implied_vol" in market_options.columns:
                df = market_options.rename(columns={"maturity": "T"})
                return df[["strike", "T", "implied_vol"]]
        elif "implied_vol" in market_options:
            return {
                "strike": market_options["strike"],
                "T": market_options.get("T", market_options.get("maturity")),
                "implied_vol": market_options["implied_vol"],
            }
        strikes, mats, prices, is_call = self._quote_arrays(market_options)
        dtype = self.dtype or torch.get_default_dtype()

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        iv = bs_mod.implied_vol(t(prices), S0, t(strikes), r, q, t(mats),
                                torch.as_tensor(is_call, device=self.device))
        iv = iv.cpu().numpy()
        ok = np.isfinite(iv) & (iv > 1e-3) & (iv < 4.9)
        if ok.sum() < 3:
            return None
        return {"strike": strikes[ok], "T": mats[ok], "implied_vol": iv[ok]}
