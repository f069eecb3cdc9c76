"""Alternative data: macro series, corporate events, sentiment.

Plain copy of ``pde_tpu/data/alternative.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference data/alternative.py: the FRED macro provider (:109-300),
corporate-event and sentiment providers (:301-643) and the
AlternativeDataManager facade (:644-780).  REST providers share the
rate-limited plumbing from data/providers; deterministic simulated providers
are first-class for zero-egress environments.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import date, datetime, timedelta, timezone
from typing import Dict, List, Optional

import numpy as np

from .providers import _stable_hash

from .providers import RateLimiter

__all__ = [
    "MacroSeries",
    "CorporateEvent",
    "SentimentScore",
    "FREDProvider",
    "SimulatedMacroProvider",
    "SimulatedEventProvider",
    "SimulatedSentimentProvider",
    "AlternativeDataManager",
]


@dataclass
class MacroSeries:
    series_id: str
    dates: List[date]
    values: np.ndarray
    title: str = ""
    units: str = ""

    def latest(self) -> Optional[float]:
        return float(self.values[-1]) if len(self.values) else None


class EventType(str, enum.Enum):
    EARNINGS = "earnings"
    DIVIDEND = "dividend"
    SPLIT = "split"
    GUIDANCE = "guidance"
    MA = "m&a"


@dataclass
class CorporateEvent:
    symbol: str
    event_type: EventType
    event_date: date
    details: Dict = field(default_factory=dict)


@dataclass
class SentimentScore:
    symbol: str
    score: float  # [-1, 1]
    n_sources: int
    as_of: datetime = field(default_factory=lambda: datetime.now(timezone.utc))


class FREDProvider:
    """St. Louis Fed FRED REST adapter (alternative.py:109-300)."""

    BASE = "https://api.stlouisfed.org/fred/series/observations"

    def __init__(self, api_key: str, rate_limiter: Optional[RateLimiter] = None):
        self.api_key = api_key
        self.rate_limiter = rate_limiter or RateLimiter(rate=2, period=1.0)

    def get_series(self, series_id: str, start: date, end: date) -> MacroSeries:  # pragma: no cover - network
        import requests

        self.rate_limiter.acquire()
        resp = requests.get(
            self.BASE,
            params={
                "series_id": series_id,
                "api_key": self.api_key,
                "file_type": "json",
                "observation_start": start.isoformat(),
                "observation_end": end.isoformat(),
            },
            timeout=10,
        )
        resp.raise_for_status()
        obs = resp.json()["observations"]
        rows = [(date.fromisoformat(o["date"]), float(o["value"]))
                for o in obs if o["value"] not in (".", "")]
        return MacroSeries(
            series_id=series_id,
            dates=[d for d, _ in rows],
            values=np.array([v for _, v in rows]),
        )


class SimulatedMacroProvider:
    """Deterministic macro series (mean-reverting around plausible levels)."""

    LEVELS = {"DFF": 5.25, "CPIAUCSL": 310.0, "UNRATE": 4.0, "VIXCLS": 16.0, "DGS10": 4.2}

    def __init__(self, seed: int = 42):
        self.seed = seed

    def get_series(self, series_id: str, start: date, end: date) -> MacroSeries:
        n = max((end - start).days, 1)
        rng = np.random.default_rng(self.seed + (_stable_hash(series_id) % 1000))
        level = self.LEVELS.get(series_id, 100.0)
        noise = rng.normal(0, 0.01 * level, n).cumsum() * 0.05
        values = level + noise - noise.mean()
        return MacroSeries(
            series_id=series_id,
            dates=[start + timedelta(days=i) for i in range(n)],
            values=values,
            title=f"simulated {series_id}",
        )


class SimulatedEventProvider:
    """Deterministic quarterly earnings calendar."""

    def get_events(self, symbol: str, start: date, end: date) -> List[CorporateEvent]:
        events = []
        # quarterly earnings ~3rd week of Jan/Apr/Jul/Oct, offset per symbol
        offset = _stable_hash(symbol) % 10
        for year in range(start.year, end.year + 1):
            for month in (1, 4, 7, 10):
                d = date(year, month, 15 + offset % 10)
                if start <= d <= end:
                    events.append(CorporateEvent(symbol, EventType.EARNINGS, d))
        return events


class SimulatedSentimentProvider:
    """Deterministic sentiment in [-1, 1]."""

    def __init__(self, seed: int = 42):
        self.seed = seed

    def get_sentiment(self, symbol: str) -> SentimentScore:
        rng = np.random.default_rng(self.seed + (_stable_hash(symbol) % 1000))
        return SentimentScore(symbol=symbol, score=float(np.tanh(rng.normal(0, 0.5))),
                              n_sources=int(rng.integers(5, 50)))


class AlternativeDataManager:
    """Facade over macro/events/sentiment (alternative.py:644-780)."""

    def __init__(self, macro=None, events=None, sentiment=None):
        self.macro = macro or SimulatedMacroProvider()
        self.events = events or SimulatedEventProvider()
        self.sentiment = sentiment or SimulatedSentimentProvider()

    def market_context(self, symbols: List[str], as_of: Optional[date] = None) -> Dict:
        """One call bundling rates/vol regime, upcoming events and sentiment."""
        as_of = as_of or date.today()
        start = as_of - timedelta(days=90)
        rates = self.macro.get_series("DFF", start, as_of)
        vix = self.macro.get_series("VIXCLS", start, as_of)
        upcoming = {
            s: [e for e in self.events.get_events(s, as_of, as_of + timedelta(days=30))]
            for s in symbols
        }
        return {
            "as_of": as_of.isoformat(),
            "fed_funds": rates.latest(),
            "vix": vix.latest(),
            "upcoming_events": {
                s: [{"type": e.event_type.value, "date": e.event_date.isoformat()} for e in evs]
                for s, evs in upcoming.items()
            },
            "sentiment": {s: self.sentiment.get_sentiment(s).score for s in symbols},
        }

    def earnings_blackout(self, symbol: str, as_of: date, window_days: int = 3) -> bool:
        """True when an earnings event falls within the blackout window."""
        events = self.events.get_events(
            symbol, as_of - timedelta(days=window_days), as_of + timedelta(days=window_days)
        )
        return any(e.event_type == EventType.EARNINGS for e in events)
