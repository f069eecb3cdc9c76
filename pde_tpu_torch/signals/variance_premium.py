"""Variance-risk-premium (VRP) trading signal.

A strategy the reference cannot express (its signal layer compares per-option
IVs only, signals/vol_surface_arbitrage.py): compare the **model-free implied
variance** extracted from the whole OTM chain (models/varswap.py, CBOE-2003
strip) against an **expected realized variance** forecast — either a
statistical estimator over recent returns (risk/position_sizer.py
VolatilityEstimator: realized / EWMA / GARCH(1,1)) or the calibrated model's
own physical-measure forecast (fair_variance_strike on today's calibrated
Heston/Bates parameters).

VRP = implied − expected is persistently positive (the variance seller's
premium); the signal fires

* SELL variance when VRP exceeds its entry threshold by more than the usual
  premium (rich implied vol — sell straddles/var swaps, delta-hedged), and
* BUY variance when VRP is negative (implied below even the physical
  forecast — cheap convexity),

with confidence scaled by the threshold exceedance and a chain-quality score
(strike coverage of the strip, which bounds the replication truncation
error).  The numeric core is one strip evaluation per maturity on
``device`` (default: the CUDA card) in ``dtype`` (default: torch's default
float); the host side is thin signal-object assembly, the same split as
the other signal modules.  Port of ``pde_tpu/signals/variance_premium.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.precision import default_float, resolve_device
from ..models import varswap

__all__ = [
    "VarianceSignalType",
    "VariancePremiumSignal",
    "VariancePremiumConfig",
    "VariancePremiumStrategy",
]


class VarianceSignalType(str, enum.Enum):
    SELL_VARIANCE = "sell_variance"
    BUY_VARIANCE = "buy_variance"


@dataclass
class VariancePremiumSignal:
    """One actionable variance-premium dislocation."""

    underlying: str
    maturity: float
    signal_type: VarianceSignalType
    confidence: float
    implied_variance: float
    expected_variance: float
    vrp: float                       # implied − expected, variance points
    implied_vol: float               # sqrt(implied), vol points
    expected_vol: float
    rationale: str
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    def to_dict(self) -> Dict:
        return {
            "underlying": self.underlying,
            "maturity": self.maturity,
            "signal_type": self.signal_type.value,
            "confidence": self.confidence,
            "implied_variance": self.implied_variance,
            "expected_variance": self.expected_variance,
            "vrp": self.vrp,
            "implied_vol": self.implied_vol,
            "expected_vol": self.expected_vol,
            "rationale": self.rationale,
            "timestamp": self.timestamp.isoformat(),
        }


@dataclass
class VariancePremiumConfig:
    """Entry thresholds in annualized VARIANCE points (vol² units):
    0.01 variance points ≈ 2-3 vol points at a 20-vol base."""

    sell_entry_vrp: float = 0.015    # implied above expected by >= this
    buy_entry_vrp: float = -0.005    # implied BELOW expected by >= this
    min_strikes: int = 8             # thinner chains replicate too poorly
    min_moneyness_span: float = 0.5  # require K-range to span F*(1±span/2)
    max_confidence_vrp: float = 0.05 # VRP at which confidence saturates
    annualization: float = 252.0


class VariancePremiumStrategy:
    """Computes VRP signals per (underlying, maturity) from an OTM chain and
    a realized-variance forecast."""

    def __init__(self, config: Optional[VariancePremiumConfig] = None,
                 vol_estimator=None, device=None, dtype=None):
        self.config = config or VariancePremiumConfig()
        self.device = device
        self.dtype = dtype
        if vol_estimator is None:
            from ..risk.position_sizer import VolatilityEstimator

            vol_estimator = VolatilityEstimator(method="ewma", device=device, dtype=dtype)
        self.vol_estimator = vol_estimator

    def _tensor(self, x):
        """A host number or array on the strategy's device and dtype."""
        return torch.as_tensor(x, dtype=self.dtype or default_float(),
                               device=resolve_device(self.device))

    # ------------------------------------------------------------------ API

    def expected_variance(self, returns=None, model_params=None,
                          maturity: float = 30.0 / 365.0) -> float:
        """Physical-measure variance forecast: calibrated-model term
        variance when params are given, else the statistical estimator
        annualized from recent returns."""
        if model_params is not None:
            return float(varswap.fair_variance_strike(model_params, self._tensor(maturity)))
        if returns is None:
            raise ValueError("need returns or model_params")
        vol = float(self.vol_estimator.estimate(np.asarray(returns, float)))
        return vol * vol

    def evaluate_chain(
        self,
        underlying: str,
        strikes,
        otm_prices,
        forward: float,
        maturity: float,
        rate: float,
        *,
        returns=None,
        model_params=None,
    ) -> Optional[VariancePremiumSignal]:
        """One (underlying, maturity) chain -> at most one signal."""
        cfg = self.config
        strikes = np.asarray(strikes, float)
        otm_prices = np.asarray(otm_prices, float)
        ok = np.isfinite(otm_prices) & (otm_prices > 0) & np.isfinite(strikes)
        strikes, otm_prices = strikes[ok], otm_prices[ok]
        if strikes.size < cfg.min_strikes:
            return None
        order = np.argsort(strikes)
        strikes, otm_prices = strikes[order], otm_prices[order]
        span = (strikes[-1] - strikes[0]) / forward
        if span < cfg.min_moneyness_span:
            return None

        implied = float(varswap.strip_variance(
            self._tensor(strikes), self._tensor(otm_prices), forward, maturity, rate))
        if not np.isfinite(implied) or implied <= 0:
            return None
        expected = self.expected_variance(
            returns=returns, model_params=model_params, maturity=maturity)
        vrp = implied - expected

        if vrp >= cfg.sell_entry_vrp:
            stype = VarianceSignalType.SELL_VARIANCE
            exceed = (vrp - cfg.sell_entry_vrp) / max(
                cfg.max_confidence_vrp - cfg.sell_entry_vrp, 1e-12)
        elif vrp <= cfg.buy_entry_vrp:
            stype = VarianceSignalType.BUY_VARIANCE
            exceed = (cfg.buy_entry_vrp - vrp) / max(
                cfg.max_confidence_vrp + cfg.buy_entry_vrp, 1e-12)
        else:
            return None

        # chain quality: how much of the ±2 "sigma" log-strike range the
        # strip covers (truncation bounds the replication error)
        sigma_T = np.sqrt(implied * maturity)
        lo_cov = min(1.0, max(0.0, np.log(forward / strikes[0]) / (2 * sigma_T)))
        hi_cov = min(1.0, max(0.0, np.log(strikes[-1] / forward) / (2 * sigma_T)))
        quality = 0.5 * (lo_cov + hi_cov)
        confidence = float(np.clip(exceed, 0.0, 1.0) * 0.7 + quality * 0.3)

        return VariancePremiumSignal(
            underlying=underlying,
            maturity=float(maturity),
            signal_type=stype,
            confidence=confidence,
            implied_variance=implied,
            expected_variance=expected,
            vrp=vrp,
            implied_vol=float(np.sqrt(implied)),
            expected_vol=float(np.sqrt(max(expected, 0.0))),
            rationale=(
                f"implied var {implied:.4f} vs expected {expected:.4f} "
                f"(VRP {vrp:+.4f}); strip of {strikes.size} strikes "
                f"covering {span:.0%} of forward"
            ),
        )

    def evaluate_surface(self, underlying: str, chains: List[Dict],
                         **forecast_kwargs) -> List[VariancePremiumSignal]:
        """Many maturities: ``chains`` is a list of dicts with keys
        strike/otm_price/forward/maturity/rate."""
        out: List[VariancePremiumSignal] = []
        for ch in chains:
            sig = self.evaluate_chain(
                underlying, ch["strike"], ch["otm_price"], ch["forward"],
                ch["maturity"], ch.get("rate", 0.0), **forecast_kwargs)
            if sig is not None:
                out.append(sig)
        return out
