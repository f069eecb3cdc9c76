"""Sector universe, confidence metrics, and confidence-weighted portfolios.

Plain copy of ``pde_tpu/backtest/sectors.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.

Mirrors the reference backtesting/sector_portfolio.py: the Sector taxonomy
and symbol universe (:40-324 — trimmed here to a representative map; extend
via ``register_symbols``), the ConfidenceMetrics blend (:355-441, the exact
20/15/15/20/10/20 and 25/20/15/25/15 weightings), the ConfidenceCalculator
(momentum / trend-alignment / vol-percentile / strategy-agreement inputs,
:443-682) and confidence-scaled position sizing (:683-715).

The calculator's per-symbol feature math is vectorized; a whole universe
evaluates in one pass via ``calculate_batch``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "Sector",
    "SECTOR_STOCKS",
    "get_sector",
    "get_all_stocks",
    "get_stocks_by_sector",
    "register_symbols",
    "ConfidenceMetrics",
    "ConfidenceCalculator",
    "calculate_position_size",
]


class Sector(str, enum.Enum):
    TECHNOLOGY = "technology"
    FINANCIALS = "financials"
    HEALTHCARE = "healthcare"
    CONSUMER_DISCRETIONARY = "consumer_discretionary"
    CONSUMER_STAPLES = "consumer_staples"
    ENERGY = "energy"
    INDUSTRIALS = "industrials"
    MATERIALS = "materials"
    UTILITIES = "utilities"
    REAL_ESTATE = "real_estate"
    COMMUNICATION = "communication"
    ETF_INDEX = "etf_index"
    ETF_SECTOR = "etf_sector"


SECTOR_STOCKS: Dict[Sector, List[str]] = {
    Sector.TECHNOLOGY: [
        "AAPL", "MSFT", "NVDA", "AVGO", "ORCL", "CSCO", "ADBE", "CRM", "AMD",
        "INTC", "QCOM", "TXN", "MU", "NOW", "INTU", "PANW", "IBM", "ANET",
    ],
    Sector.FINANCIALS: [
        "JPM", "BAC", "WFC", "C", "GS", "MS", "USB", "PNC", "BLK", "SCHW",
        "AXP", "V", "MA", "SPGI",
    ],
    Sector.HEALTHCARE: [
        "UNH", "JNJ", "LLY", "PFE", "ABBV", "MRK", "TMO", "ABT", "DHR", "AMGN",
    ],
    Sector.CONSUMER_DISCRETIONARY: [
        "AMZN", "TSLA", "HD", "MCD", "NKE", "LOW", "SBUX", "TJX", "BKNG",
    ],
    Sector.CONSUMER_STAPLES: ["PG", "KO", "PEP", "COST", "WMT", "MDLZ", "CL"],
    Sector.ENERGY: ["XOM", "CVX", "COP", "SLB", "EOG", "MPC", "PSX", "VLO"],
    Sector.INDUSTRIALS: ["CAT", "DE", "UNP", "HON", "GE", "BA", "LMT", "RTX", "UPS"],
    Sector.MATERIALS: ["LIN", "APD", "SHW", "FCX", "NEM", "DOW"],
    Sector.UTILITIES: ["NEE", "DUK", "SO", "D", "AEP", "EXC"],
    Sector.REAL_ESTATE: ["PLD", "AMT", "EQIX", "CCI", "PSA", "O"],
    Sector.COMMUNICATION: ["GOOGL", "META", "NFLX", "DIS", "CMCSA", "T", "VZ"],
    Sector.ETF_INDEX: ["SPY", "QQQ", "IWM", "DIA", "VTI"],
    Sector.ETF_SECTOR: ["XLK", "XLF", "XLV", "XLE", "XLI", "XLY", "XLP", "XLU", "XLB"],
}

_SYMBOL_TO_SECTOR: Dict[str, Sector] = {
    sym: sector for sector, symbols in SECTOR_STOCKS.items() for sym in symbols
}


def get_sector(symbol: str) -> Sector:
    """Sector for a symbol; unknown names default to ETF_INDEX like the
    reference (sector_portfolio.py:325-329)."""
    return _SYMBOL_TO_SECTOR.get(symbol.upper(), Sector.ETF_INDEX)


def get_all_stocks() -> List[str]:
    return sorted(_SYMBOL_TO_SECTOR)


def get_stocks_by_sector(sector: Sector) -> List[str]:
    return list(SECTOR_STOCKS.get(sector, []))


def register_symbols(sector: Sector, symbols: List[str]) -> None:
    """Extend the universe (the reference ships 400+ names inline)."""
    SECTOR_STOCKS.setdefault(sector, []).extend(symbols)
    for s in symbols:
        _SYMBOL_TO_SECTOR[s.upper()] = sector


@dataclass
class ConfidenceMetrics:
    """Blended sizing confidence (sector_portfolio.py:355-441)."""

    symbol: str
    sector: Sector
    momentum_strength: float = 0.0  # [-1, 1]
    trend_alignment: float = 0.0  # [0, 1]
    half_life_days: float = float("inf")
    mean_reversion_score: float = 0.0
    z_score: float = 0.0
    realized_volatility: float = 0.0
    volatility_percentile: float = 0.5
    signal_strength: float = 0.0
    strategy_agreement: float = 0.0
    sector_algorithm_fitness: float = 0.5
    confidence: float = 0.0

    def calculate_confidence(self, use_fitness: bool = True) -> float:
        trend = (self.momentum_strength + 1.0) / 2.0
        vol = 1.0 - self.volatility_percentile
        if use_fitness and self.sector_algorithm_fitness != 0.5:
            self.confidence = (
                0.20 * trend
                + 0.15 * self.mean_reversion_score
                + 0.15 * vol
                + 0.20 * self.signal_strength
                + 0.10 * self.strategy_agreement
                + 0.20 * self.sector_algorithm_fitness
            )
        else:
            self.confidence = (
                0.25 * trend
                + 0.20 * self.mean_reversion_score
                + 0.15 * vol
                + 0.25 * self.signal_strength
                + 0.15 * self.strategy_agreement
            )
        return self.confidence


class ConfidenceCalculator:
    """Computes ConfidenceMetrics from price history
    (sector_portfolio.py:443-682)."""

    def __init__(self, momentum_lookback: int = 60, vol_lookback: int = 20):
        self.momentum_lookback = momentum_lookback
        self.vol_lookback = vol_lookback
        self._fitness: Dict[Sector, float] = {}

    def set_optimization_results(self, fitness_by_sector: Dict[Sector, float]) -> None:
        """Feed sector-algorithm fitness from the StrategyOptimizer."""
        self._fitness = dict(fitness_by_sector)

    def calculate(
        self,
        symbol: str,
        prices: np.ndarray,
        signal_strength: float = 0.5,
        strategy_agreement: float = 0.5,
        ou_half_life_days: Optional[float] = None,
    ) -> ConfidenceMetrics:
        p = np.asarray(prices, dtype=np.float64)
        sector = get_sector(symbol)
        m = ConfidenceMetrics(symbol=symbol, sector=sector)

        m.momentum_strength = self._momentum(p)
        m.trend_alignment = self._trend_alignment(p)
        m.realized_volatility = self._realized_vol(p)
        m.volatility_percentile = self._vol_percentile(p)
        m.signal_strength = float(np.clip(signal_strength, 0.0, 1.0))
        m.strategy_agreement = float(np.clip(strategy_agreement, 0.0, 1.0))
        if ou_half_life_days is not None:
            m.half_life_days = ou_half_life_days
            # 5..60-day half-life maps to [1..0] quality (reference heuristic)
            m.mean_reversion_score = float(np.clip(1.0 - (ou_half_life_days - 5.0) / 55.0, 0.0, 1.0))
        m.sector_algorithm_fitness = self._fitness.get(sector, 0.5)
        m.calculate_confidence(use_fitness=bool(self._fitness))
        return m

    def calculate_batch(self, prices_by_symbol: Dict[str, np.ndarray], **kwargs) -> Dict[str, ConfidenceMetrics]:
        return {s: self.calculate(s, p, **kwargs) for s, p in prices_by_symbol.items()}

    # ------------------------------------------------------------ features

    def _momentum(self, p: np.ndarray) -> float:
        lb = min(len(p) - 1, self.momentum_lookback)
        if lb < 5:
            return 0.0
        raw = p[-1] / p[-1 - lb] - 1.0
        return float(np.tanh(raw * 5.0))  # squashed to [-1, 1]

    def _trend_alignment(self, p: np.ndarray) -> float:
        """Fraction of (price > MA20 > MA50) alignment conditions met."""
        if len(p) < 50:
            return 0.5
        ma20 = p[-20:].mean()
        ma50 = p[-50:].mean()
        checks = [p[-1] > ma20, ma20 > ma50, p[-1] > ma50]
        return sum(checks) / 3.0

    def _realized_vol(self, p: np.ndarray) -> float:
        lb = min(len(p) - 1, self.vol_lookback)
        if lb < 5:
            return 0.0
        r = np.diff(np.log(p[-(lb + 1) :]))
        return float(np.std(r, ddof=1) * np.sqrt(252))

    def _vol_percentile(self, p: np.ndarray) -> float:
        """Current vol's percentile in its own rolling history."""
        r = np.diff(np.log(p))
        w = self.vol_lookback
        if len(r) < 3 * w:
            return 0.5
        # range end len(r)+1 so the LAST window includes today's return —
        # otherwise the "current" vol lags one observation and a spike on
        # the latest bar is invisible to the percentile
        vols = np.array([r[i - w : i].std(ddof=1) for i in range(w, len(r) + 1)])
        return float(np.mean(vols <= vols[-1]))


def calculate_position_size(
    confidence: float,
    capital: float,
    max_position_pct: float = 0.10,
    min_confidence: float = 0.3,
) -> float:
    """Confidence-scaled size; zero below the floor
    (sector_portfolio.py:683-715)."""
    if confidence < min_confidence:
        return 0.0
    return capital * max_position_pct * confidence
