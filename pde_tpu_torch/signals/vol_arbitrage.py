"""Volatility-surface arbitrage signals (twin of
``pde_tpu/signals/vol_arbitrage.py``).

Model-vs-market IV comparison with maturity/liquidity/volume filters,
min/max divergence thresholds and the 40/40/20 fit-quality/liquidity/
maturity confidence score.  The filters, the confidence and the signal
objects are numpy, as in the reference; the model IVs for the whole chain
are one evaluation on ``device`` (the card unless the caller names
another), read back in one copy: rough Heston
(:func:`~pde_tpu_torch.models.rough_heston.implied_vol_rough`, one smile
a unique maturity), SABR (parameters interpolated per maturity by
:class:`~pde_tpu_torch.calibrate.sabr.SABRCalibrator`) or Heston (price
inversion on the grouped converged pricer).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np
import torch

from ..calibrate.sabr import SABRCalibrator
from ..core.precision import default_float, resolve_device
from ..models import heston as heston_mod
from ..models import sabr as sabr_mod
from ..models.rough_heston import implied_vol_rough

__all__ = ["SignalType", "VolArbitrageSignal", "VolArbitrageConfig", "VolSurfaceArbitrageSignal"]


class SignalType(str, enum.Enum):
    BUY = "buy"
    SELL = "sell"


@dataclass
class VolArbitrageSignal:
    """One actionable mispricing (mirrors vol_surface_arbitrage.py:40-88)."""

    underlying: str
    strike: float
    expiration: Optional[object]
    option_type: str
    signal_type: SignalType
    confidence: float
    model_iv: float
    market_iv: float
    divergence_pct: float
    rationale: str
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    bid: Optional[float] = None
    ask: Optional[float] = None
    model_price: Optional[float] = None
    market_price: Optional[float] = None
    delta: Optional[float] = None
    vega: Optional[float] = None

    def to_dict(self) -> Dict:
        return {
            "underlying": self.underlying,
            "strike": self.strike,
            "expiration": str(self.expiration) if self.expiration is not None else None,
            "option_type": self.option_type,
            "signal_type": self.signal_type.value,
            "confidence": self.confidence,
            "model_iv": self.model_iv,
            "market_iv": self.market_iv,
            "divergence_pct": self.divergence_pct,
            "rationale": self.rationale,
            "timestamp": self.timestamp.isoformat(),
            "bid": self.bid,
            "ask": self.ask,
            "model_price": self.model_price,
            "market_price": self.market_price,
            "delta": self.delta,
            "vega": self.vega,
        }


@dataclass
class VolArbitrageConfig:
    """Thresholds (defaults match vol_surface_arbitrage.py:91-117)."""

    min_divergence_pct: float = 0.10
    max_divergence_pct: float = 0.50
    min_confidence: float = 0.6
    max_bid_ask_spread_pct: float = 0.10
    min_volume: int = 100
    min_days_to_expiry: int = 7
    max_days_to_expiry: int = 180
    preferred_min_days: int = 30
    preferred_max_days: int = 90
    max_model_rmse: float = 0.05


class VolSurfaceArbitrageSignal:
    """Model-vs-market IV mispricing detector.

    ``device`` (default: the CUDA card) and ``dtype`` (default: torch's
    default float) set where and in which precision the model IVs are
    computed; the filters and scores are numpy."""

    def __init__(self, config: Optional[VolArbitrageConfig] = None, use_sabr=True,
                 use_heston=True, use_rough=True, device=None,
                 dtype: Optional[torch.dtype] = None):
        self.config = config or VolArbitrageConfig()
        self.use_sabr = use_sabr
        self.use_heston = use_heston
        self.use_rough = use_rough  # active only when a rough_result is passed
        self.device = device
        self.dtype = dtype

    # ------------------------------------------------------------------ API

    def generate_signals(
        self,
        market_data,
        S0: float,
        r: float,
        q: float,
        heston_result=None,
        sabr_result=None,
        rough_result=None,
    ) -> List[VolArbitrageSignal]:
        """Evaluate a whole option chain in one vectorized pass.

        ``market_data``: DataFrame or dict with 'strike', 'T', 'implied_vol'
        and optional 'underlying'/'expiration'/'option_type'/'bid'/'ask'/
        'volume' (same schema as the reference).
        """
        if heston_result is None and sabr_result is None and rough_result is None:
            raise ValueError(
                "At least one model result (heston, sabr or rough) required")

        col = self._getter(market_data)
        strikes = np.asarray(col("strike"), dtype=np.float64)
        T = np.asarray(col("T"), dtype=np.float64)
        market_iv = np.asarray(col("implied_vol"), dtype=np.float64)
        n = len(strikes)

        bid = np.asarray(col("bid"), dtype=np.float64) if self._has(market_data, "bid") else None
        ask = np.asarray(col("ask"), dtype=np.float64) if self._has(market_data, "ask") else None
        volume = np.asarray(col("volume"), dtype=np.float64) if self._has(market_data, "volume") else None
        is_call = (
            np.asarray([str(t).lower() == "call" for t in col("option_type")])
            if self._has(market_data, "option_type")
            else np.ones(n, dtype=bool)
        )

        # ---- filters as masks (vol_surface_arbitrage.py:317-341) ----
        days = T * 365.0
        mask = (days >= self.config.min_days_to_expiry) & (days <= self.config.max_days_to_expiry)
        if bid is not None and ask is not None:
            mid = 0.5 * (bid + ask)
            spread_pct = np.where(mid > 0, (ask - bid) / np.where(mid > 0, mid, 1.0), 1.0)
            mask &= ~((bid > 0) & (spread_pct > self.config.max_bid_ask_spread_pct))
        if volume is not None:
            mask &= volume >= self.config.min_volume

        # ---- model IV for the whole chain ----
        model_iv = self._model_iv_vector(
            strikes, T, is_call, S0, r, q, heston_result, sabr_result,
            rough_result,
        )
        mask &= np.isfinite(model_iv) & (model_iv > 0)

        divergence = model_iv - market_iv
        div_pct = np.where(market_iv > 0, divergence / np.where(market_iv > 0, market_iv, 1.0), 0.0)
        mask &= (np.abs(div_pct) >= self.config.min_divergence_pct) & (
            np.abs(div_pct) <= self.config.max_divergence_pct
        )

        # ---- confidence (40% fit, 40% liquidity, 20% maturity) ----
        rmse = self._calibration_rmse(heston_result, sabr_result, rough_result)
        fit_score = 1.0 - min(rmse, self.config.max_model_rmse) / self.config.max_model_rmse
        if bid is not None and ask is not None:
            mid = 0.5 * (bid + ask)
            spread_pct = np.where(mid > 0, (ask - bid) / np.where(mid > 0, mid, 1.0), 0.1)
            liq_score = np.where(bid > 0, np.maximum(0.0, 1.0 - spread_pct / self.config.max_bid_ask_spread_pct), 0.5)
        else:
            liq_score = np.full(n, 0.5)
        mat_score = np.select(
            [
                days < self.config.min_days_to_expiry,
                (days >= self.config.preferred_min_days) & (days <= self.config.preferred_max_days),
                days > self.config.max_days_to_expiry,
            ],
            [0.3, 1.0, 0.5],
            default=0.7,
        )
        confidence = 0.4 * fit_score + 0.4 * liq_score + 0.2 * mat_score
        mask &= confidence >= self.config.min_confidence

        # ---- materialize surviving rows ----
        underlying = col("underlying") if self._has(market_data, "underlying") else ["UNKNOWN"] * n
        expiration = col("expiration") if self._has(market_data, "expiration") else [None] * n
        opt_type = col("option_type") if self._has(market_data, "option_type") else ["call"] * n

        signals = []
        for i in np.nonzero(mask)[0]:
            buy = divergence[i] > 0
            rationale = (
                f"Market IV {market_iv[i]:.1%}, Model IV {model_iv[i]:.1%}, "
                + (f"underpriced by {div_pct[i]:.1%}" if buy else f"overpriced by {abs(div_pct[i]):.1%}")
            )
            signals.append(
                VolArbitrageSignal(
                    underlying=str(underlying[i]),
                    strike=float(strikes[i]),
                    expiration=expiration[i],
                    option_type=str(opt_type[i]),
                    signal_type=SignalType.BUY if buy else SignalType.SELL,
                    confidence=float(confidence[i]),
                    model_iv=float(model_iv[i]),
                    market_iv=float(market_iv[i]),
                    divergence_pct=float(div_pct[i]),
                    rationale=rationale,
                    bid=float(bid[i]) if bid is not None else None,
                    ask=float(ask[i]) if ask is not None else None,
                )
            )
        return signals

    def filter_signals(self, signals: List[VolArbitrageSignal], top_n: Optional[int] = None):
        """Highest-confidence first, optionally truncated."""
        out = sorted(signals, key=lambda s: s.confidence, reverse=True)
        return out[:top_n] if top_n else out

    # ------------------------------------------------------------ internals

    def _model_iv_vector(self, strikes, T, is_call, S0, r, q, heston_result,
                         sabr_result, rough_result=None):
        """Model IV for every quote, on the signal's device, read back in
        one copy.

        Rough Heston wins when its calibration is supplied (one smile a
        unique maturity); otherwise SABR params are interpolated per
        maturity (as the reference does); Heston IVs come from true price
        inversion on the grouped converged pricer.
        """
        device = resolve_device(self.device)
        dtype = self.dtype or default_float()

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

        def per_maturity(smile):
            """``smile(t, mask)`` for each unique maturity, scattered back
            into chain order."""
            uniq = np.unique(T)
            masks = [T == u for u in uniq]
            flat = torch.cat([smile(float(u), m) for u, m in zip(uniq, masks)])
            flat = flat.cpu().numpy().astype(np.float64)
            out = np.empty_like(T)
            start = 0
            for m in masks:
                out[m] = flat[start:start + int(m.sum())]
                start += int(m.sum())
            return out

        if self.use_rough and rough_result is not None:
            return per_maturity(lambda u, m: implied_vol_rough(
                rough_result.params, t(strikes[m]), u, S0, r, q,
                is_call=torch.as_tensor(is_call[m], device=device)))

        if self.use_sabr and sabr_result is not None and sabr_result.params_by_maturity:
            cal = SABRCalibrator(
                beta=float(next(iter(sabr_result.params_by_maturity.values())).beta),
                device=device, dtype=dtype,
            )

            def smile(u, m):
                p = cal.interpolate_parameters(u, sabr_result.params_by_maturity)
                F = S0 * np.exp((r - q) * u)
                return sabr_mod.implied_volatilities(t(strikes[m]), F, u, p)

            return per_maturity(smile)

        if self.use_heston and heston_result is not None:
            # grouped CF: a chain has few unique maturities and many strikes,
            # so the converged quadrature's CF is paid per maturity, not per
            # quote (models/heston.py group_maturities)
            unique_T, t_idx = heston_mod.group_maturities(T)
            iv = heston_mod.implied_volatility_grouped(
                heston_result.params, t(strikes), torch.as_tensor(t_idx, device=device),
                t(unique_T), S0, r, q, torch.as_tensor(is_call, device=device),
                accurate=True,
            )
            return iv.cpu().numpy().astype(np.float64)

        return np.full(len(strikes), np.nan)

    @staticmethod
    def _calibration_rmse(heston_result, sabr_result, rough_result=None) -> float:
        if rough_result is not None:
            return float(rough_result.rmse)
        if sabr_result is not None:
            return float(sabr_result.total_rmse)
        if heston_result is not None:
            return float(heston_result.rmse)
        return 0.05

    @staticmethod
    def _getter(data):
        if hasattr(data, "columns"):
            return lambda c: data[c].to_numpy()
        return lambda c: np.asarray(data[c])

    @staticmethod
    def _has(data, c) -> bool:
        return c in (data.columns if hasattr(data, "columns") else data)
