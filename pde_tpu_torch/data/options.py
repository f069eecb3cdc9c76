"""Options data stack: IV calculation, volatility surface, SVI fit, chain
processing (twin of ``pde_tpu/data/options.py``).

The implied-vol calculator inverts a whole chain in one call of the
vectorized Newton of :func:`pde_tpu_torch.models.black_scholes.implied_vol`
(Brenner-Subrahmanyam start), the Greeks calculator evaluates
:func:`~pde_tpu_torch.models.black_scholes.greeks` over a chain, and
Gatheral's SVI is fitted with the port's bounded Levenberg-Marquardt
(:func:`pde_tpu_torch.calibrate.lm.levenberg_marquardt`, the reference's
bounds, infinite upper bounds included): each on ``device`` (the card
unless the caller names another), in the inputs' own precision (float64
for numpy chains).  The VolatilitySurface's per-expiry cubic splines,
ATM vol and 25-delta skew stay scipy on the host, as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import date
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..calibrate.lm import levenberg_marquardt
from ..core.precision import host_tensor, resolve_device
from ..models import black_scholes as bs

__all__ = [
    "OptionQuote",
    "VolatilitySurfacePoint",
    "ImpliedVolatilityCalculator",
    "GreeksCalculator",
    "VolatilitySurface",
    "SVIParameterization",
    "OptionsChainProcessor",
]


@dataclass
class OptionQuote:
    """One option quote from a chain."""

    strike: float
    expiration: date
    option_type: str  # 'call' | 'put'
    bid: float = 0.0
    ask: float = 0.0
    last: float = 0.0
    volume: int = 0
    open_interest: int = 0
    implied_vol: Optional[float] = None

    @property
    def mid(self) -> float:
        if self.bid > 0 and self.ask > 0:
            return 0.5 * (self.bid + self.ask)
        return self.last


@dataclass
class VolatilitySurfacePoint:
    strike: float
    expiration: date
    implied_vol: float
    time_to_expiry: float = 0.0
    volume: int = 0
    option_type: str = "call"


def _flags(is_calls, device) -> torch.Tensor:
    """Call flags (a bool or an array of them) as a bool tensor on ``device``."""
    return torch.as_tensor(np.asarray(is_calls, dtype=bool), device=device)


class ImpliedVolatilityCalculator:
    """Vectorized Newton IV over whole chains, on ``device``."""

    def __init__(self, risk_free_rate: float = 0.05, dividend_yield: float = 0.0, device=None):
        self.risk_free_rate = risk_free_rate
        self.dividend_yield = dividend_yield
        self.device = device

    def calculate(self, price, spot, strike, time_to_expiry, is_call=True) -> float:
        return float(self.calculate_chain(price, spot, strike, time_to_expiry, is_call))

    def calculate_chain(self, prices, spot, strikes, times, is_calls) -> np.ndarray:
        """An entire chain inverted in one call, read back in one copy."""
        dev = resolve_device(self.device)
        t = lambda a: host_tensor(np.asarray(a, dtype=np.float64), dev)  # noqa: E731
        return bs.implied_vol(
            t(prices), spot, t(strikes), self.risk_free_rate, self.dividend_yield,
            t(times), _flags(is_calls, dev),
        ).cpu().numpy()


class GreeksCalculator:
    """Chain-wide BS Greeks, on ``device``."""

    def __init__(self, risk_free_rate: float = 0.05, dividend_yield: float = 0.0, device=None):
        self.r = risk_free_rate
        self.q = dividend_yield
        self.device = device

    def calculate(self, spot, strikes, times, vols, is_calls=True) -> Dict[str, np.ndarray]:
        dev = resolve_device(self.device)
        t = lambda a: host_tensor(np.asarray(a, dtype=np.float64), dev)  # noqa: E731
        out = bs.greeks(spot, t(strikes), self.r, self.q, t(times), t(vols),
                        _flags(is_calls, dev))
        return {k: v.cpu().numpy() for k, v in out.items()}


class VolatilitySurface:
    """Per-expiry smile interpolation + ATM/skew analytics
    (options.py:549-706)."""

    def __init__(
        self,
        points: List[VolatilitySurfacePoint],
        spot_price: float,
        risk_free_rate: float = 0.05,
        dividend_yield: float = 0.0,
        as_of: Optional[date] = None,
    ):
        self.points = points
        self.spot_price = spot_price
        self.risk_free_rate = risk_free_rate
        self.dividend_yield = dividend_yield
        self.as_of = as_of or date.today()
        self._build()

    def _build(self) -> None:
        from scipy import interpolate

        by_expiry: Dict[date, List[VolatilitySurfacePoint]] = {}
        for p in self.points:
            by_expiry.setdefault(p.expiration, []).append(p)

        self._smiles: Dict[date, Callable] = {}
        for expiry, pts in by_expiry.items():
            # real chains carry a call AND a put per strike; collapse
            # duplicate strikes to the OTM quote (puts below spot, calls
            # above — the liquid side), else the IV average.  CubicSpline
            # demands strictly increasing x, so duplicates would crash.
            by_strike: Dict[float, List[VolatilitySurfacePoint]] = {}
            for p in pts:
                by_strike.setdefault(round(p.strike, 10), []).append(p)
            strikes, vols = [], []
            for k in sorted(by_strike):
                group = by_strike[k]
                if len(group) == 1:
                    iv = group[0].implied_vol
                else:
                    want = "put" if k < self.spot_price else "call"
                    otm = [p for p in group if p.option_type.lower() == want]
                    iv = (otm[0].implied_vol if otm
                          else float(np.mean([p.implied_vol for p in group])))
                strikes.append(k)
                vols.append(iv)
            if len(strikes) >= 4:
                self._smiles[expiry] = interpolate.CubicSpline(strikes, vols, bc_type="natural")
        self._expirations = sorted(by_expiry)
        self._expiry_times = {
            e: max((e - self.as_of).days, 0) / 365.0 for e in self._expirations
        }

    def get_vol(self, strike: float, expiration: date) -> Optional[float]:
        if expiration in self._smiles:
            return float(self._smiles[expiration](strike))
        if self._expirations:
            nearest = min(self._expirations, key=lambda e: abs((e - expiration).days))
            if nearest in self._smiles:
                return float(self._smiles[nearest](strike))
        if self.points:
            return float(np.mean([p.implied_vol for p in self.points]))
        return None

    def get_atm_vol(self, expiration: date) -> Optional[float]:
        return self.get_vol(self.spot_price, expiration)

    def get_skew(self, expiration: date) -> Optional[float]:
        """~25-delta put vol minus call vol (options.py:657-695)."""
        atm = self.get_atm_vol(expiration)
        if atm is None:
            return None
        T = self._expiry_times.get(expiration, 0.25)
        if T <= 0:
            return None
        put_k = self.spot_price * np.exp(-0.5 * atm * np.sqrt(T))
        call_k = self.spot_price * np.exp(0.5 * atm * np.sqrt(T))
        pv, cv = self.get_vol(put_k, expiration), self.get_vol(call_k, expiration)
        if pv is None or cv is None:
            return None
        return pv - cv

    def get_term_structure(self) -> Dict[date, float]:
        return {e: self.get_atm_vol(e) for e in self._expirations}

    def to_records(self) -> List[Dict]:
        return [
            {
                "strike": p.strike,
                "expiration": p.expiration.isoformat(),
                "implied_vol": p.implied_vol,
                "time_to_expiry": p.time_to_expiry,
            }
            for p in self.points
        ]


class SVIParameterization:
    """Gatheral SVI total-variance fit.

    w(k) = a + b (rho (k-m) + sqrt((k-m)^2 + sigma^2)), fitted with the
    bounded LM on ``device``.
    """

    def __init__(self, device=None):
        self.params: Optional[Dict[str, float]] = None
        self.device = device

    @staticmethod
    def _svi(k, a, b, rho, m, sigma):
        return a + b * (rho * (k - m) + torch.sqrt((k - m) ** 2 + sigma**2))

    def fit(self, log_moneyness, total_variance, time_to_expiry: float) -> Dict[str, float]:
        dev = resolve_device(self.device)
        k = host_tensor(np.asarray(log_moneyness, dtype=np.float64), dev)
        w = host_tensor(np.asarray(total_variance, dtype=np.float64), dev)

        def residuals(x):
            return self._svi(k, x[0], x[1], x[2], x[3], x[4]) - w

        vec = lambda *v: torch.tensor(v, dtype=w.dtype, device=dev)  # noqa: E731
        lower = vec(0.0, 0.0, -0.999, -2.0, 1e-3)
        upper = vec(math.inf, math.inf, 0.999, 2.0, 2.0)
        x0 = vec(float(torch.mean(w)), 0.1, -0.5, 0.0, 0.1)
        res = levenberg_marquardt(residuals, x0, lower, upper, max_iter=100)
        a, b, rho, m, sigma = (float(v) for v in res.x.cpu())
        self.params = {
            "a": a, "b": b, "rho": rho, "m": m, "sigma": sigma,
            "time_to_expiry": time_to_expiry,
        }
        return self.params

    def get_total_variance(self, log_moneyness) -> float:
        if self.params is None:
            raise ValueError("SVI not fitted. Call fit() first.")
        p = self.params
        k = host_tensor(np.asarray(log_moneyness, dtype=np.float64), self.device)
        return float(self._svi(k, p["a"], p["b"], p["rho"], p["m"], p["sigma"]))

    def get_implied_vol(self, log_moneyness) -> float:
        if self.params is None:
            raise ValueError("SVI not fitted. Call fit() first.")
        T = self.params["time_to_expiry"]
        w = self.get_total_variance(log_moneyness)
        return float(np.sqrt(w / T)) if w > 0 and T > 0 else 0.0


class OptionsChainProcessor:
    """Quote chain -> IVs -> VolatilitySurface (options.py:813-1063)."""

    def __init__(self, risk_free_rate: float = 0.05, dividend_yield: float = 0.0, device=None):
        self.iv_calc = ImpliedVolatilityCalculator(risk_free_rate, dividend_yield, device)
        self.risk_free_rate = risk_free_rate
        self.dividend_yield = dividend_yield
        self.device = device

    def build_surface(
        self,
        quotes: List[OptionQuote],
        spot_price: float,
        as_of: Optional[date] = None,
        min_volume: int = 0,
        max_spread_pct: float = 0.5,
    ) -> VolatilitySurface:
        as_of = as_of or date.today()
        usable = []
        for q in quotes:
            if q.volume < min_volume:
                continue
            mid = q.mid
            if mid <= 0:
                continue
            if q.bid > 0 and q.ask > 0 and (q.ask - q.bid) / mid > max_spread_pct:
                continue
            usable.append(q)
        if not usable:
            return VolatilitySurface([], spot_price, self.risk_free_rate, self.dividend_yield, as_of)

        prices = np.array([q.mid for q in usable])
        strikes = np.array([q.strike for q in usable])
        times = np.array([max((q.expiration - as_of).days, 1) / 365.0 for q in usable])
        is_calls = np.array([q.option_type.lower() == "call" for q in usable])
        ivs = self.iv_calc.calculate_chain(prices, spot_price, strikes, times, is_calls)

        points = [
            VolatilitySurfacePoint(
                strike=float(q.strike),
                expiration=q.expiration,
                implied_vol=float(iv),
                time_to_expiry=float(t),
                volume=q.volume,
                option_type=q.option_type,
            )
            for q, iv, t in zip(usable, ivs, times)
            if np.isfinite(iv) and 1e-3 < iv < 4.9
        ]
        return VolatilitySurface(points, spot_price, self.risk_free_rate, self.dividend_yield, as_of)

    def fit_svi_smile(
        self, surface: VolatilitySurface, expiration: date
    ) -> Optional[SVIParameterization]:
        pts = [p for p in surface.points if p.expiration == expiration]
        if len(pts) < 5:
            return None
        T = surface._expiry_times.get(expiration, pts[0].time_to_expiry)
        F = surface.spot_price * np.exp(
            (surface.risk_free_rate - surface.dividend_yield) * T
        )
        k = np.log(np.array([p.strike for p in pts]) / F)
        w = np.array([p.implied_vol**2 * T for p in pts])
        svi = SVIParameterization(self.device)
        svi.fit(k, w, T)
        return svi
