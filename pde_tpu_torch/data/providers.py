"""Market-data providers: ABC, token-bucket rate limiting, REST adapters.

Port of ``pde_tpu/data/providers.py``: the reference file with one change,
:meth:`SimulatedDataProvider.get_options_chain` prices its chain through the
port's :func:`pde_tpu_torch.models.black_scholes.price` on the provider's
``device`` (default: the CUDA card) in its ``dtype`` (default: torch's
default float).  The bars are the reference's numpy arithmetic, so the
simulated prices equal the reference's.

Mirrors the reference data/providers.py: the DataProvider ABC with
get_bars/get_quote/get_options_chain (:126-288), the token-bucket
RateLimiter (:56-115), Yahoo/AlphaVantage/Polygon/IEX REST providers
(:289-939) and the factory (:940-984).  A seeded SimulatedDataProvider is
first-class here (the reference buries its fake feed in data/streaming.py) —
it is the test/dev substitute in a zero-egress environment.
"""
from __future__ import annotations

import abc
import threading
import time
import zlib
from dataclasses import dataclass, field
from datetime import date, datetime, timedelta, timezone
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "RateLimiter",
    "Bar",
    "Quote",
    "DataProvider",
    "SimulatedDataProvider",
    "YahooProvider",
    "AlphaVantageProvider",
    "PolygonProvider",
    "IEXProvider",
    "create_provider",
]


def _stable_hash(text: str) -> int:
    """Process-stable symbol hash (str ``hash`` is randomized per process,
    which would make the "deterministic" simulated data differ between
    runs)."""
    return zlib.crc32(text.encode())


class RateLimiter:
    """Token bucket (providers.py:56-115): ``rate`` requests per ``period``
    seconds, blocking acquire."""

    def __init__(self, rate: int = 5, period: float = 1.0):
        self.rate = rate
        self.period = period
        self._tokens = float(rate)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    float(self.rate), self._tokens + (now - self._last) * self.rate / self.period
                )
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(self.period / self.rate / 4)


@dataclass
class Bar:
    time: datetime
    open: float
    high: float
    low: float
    close: float
    volume: float = 0.0
    symbol: str = ""


@dataclass
class Quote:
    symbol: str
    bid: float
    ask: float
    last: float
    time: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    @property
    def mid(self) -> float:
        return 0.5 * (self.bid + self.ask)


class DataProvider(abc.ABC):
    """Provider interface (providers.py:126-288)."""

    name = "base"

    def __init__(self, rate_limiter: Optional[RateLimiter] = None):
        self.rate_limiter = rate_limiter or RateLimiter()

    @abc.abstractmethod
    def get_bars(self, symbol: str, start: date, end: date, interval: str = "1d") -> List[Bar]:
        ...

    @abc.abstractmethod
    def get_quote(self, symbol: str) -> Quote:
        ...

    def get_options_chain(self, underlying: str, expiration: Optional[date] = None) -> List[Dict]:
        raise NotImplementedError(f"{self.name} has no options data")

    def is_available(self) -> bool:
        try:
            self.get_quote("SPY")
            return True
        except Exception:  # noqa: BLE001
            return False


class SimulatedDataProvider(DataProvider):
    """Deterministic GBM provider for tests/dev (zero-network substitute for
    the reference's SimulatedStreamProvider, streaming.py:272)."""

    name = "simulated"

    def __init__(self, seed: int = 42, annual_vol: float = 0.2, annual_drift: float = 0.07,
                 base_prices: Optional[Dict[str, float]] = None, device=None, dtype=None):
        super().__init__(RateLimiter(rate=10_000))
        self.device = device
        self.dtype = dtype
        self.seed = seed
        self.annual_vol = annual_vol
        self.annual_drift = annual_drift
        self.base_prices = base_prices or {}

    def _base(self, symbol: str) -> float:
        if symbol in self.base_prices:
            return self.base_prices[symbol]
        return 50.0 + (_stable_hash(symbol) % 400)

    def get_bars(self, symbol, start, end, interval="1d") -> List[Bar]:
        self.rate_limiter.acquire()
        n = max((end - start).days, 1)
        rng = np.random.default_rng(self.seed + (_stable_hash(symbol) % 10_000))
        dt = 1.0 / 252.0
        rets = (self.annual_drift - 0.5 * self.annual_vol**2) * dt + self.annual_vol * np.sqrt(
            dt
        ) * rng.standard_normal(n)
        closes = self._base(symbol) * np.exp(np.cumsum(rets))
        bars = []
        for i in range(n):
            c = closes[i]
            o = closes[i - 1] if i else self._base(symbol)
            hi = max(o, c) * (1 + 0.002 * abs(rng.standard_normal()))
            lo = min(o, c) * (1 - 0.002 * abs(rng.standard_normal()))
            bars.append(
                Bar(
                    time=datetime.combine(start + timedelta(days=i), datetime.min.time()),
                    open=float(o), high=float(hi), low=float(lo), close=float(c),
                    volume=float(rng.integers(1e5, 5e6)), symbol=symbol,
                )
            )
        return bars

    def get_quote(self, symbol) -> Quote:
        self.rate_limiter.acquire()
        px = self._base(symbol)
        return Quote(symbol=symbol, bid=px * 0.9995, ask=px * 1.0005, last=px)

    def get_options_chain(self, underlying, expiration=None) -> List[Dict]:
        self.rate_limiter.acquire()
        spot = self._base(underlying)
        exp = expiration or (date.today() + timedelta(days=30))
        T = max((exp - date.today()).days, 1) / 365.0
        import torch

        from ..core.precision import default_float, resolve_device
        from ..models import black_scholes as bs_mod

        # one vectorized pricing call for the whole chain on the device, and
        # one copy back: scalar per-option calls would pay a launch and a
        # copy EACH
        strikes = np.round(spot * np.linspace(0.8, 1.2, 9), 1)
        both = np.concatenate([strikes, strikes])
        is_call = np.concatenate([np.ones(9, bool), np.zeros(9, bool)])
        device = resolve_device(self.device)
        mids = bs_mod.price(
            spot, torch.as_tensor(both, dtype=self.dtype or default_float(), device=device),
            0.05, 0.0, T, 0.22, torch.as_tensor(is_call, device=device)).cpu().numpy()

        rows = []
        for strike, call_flag, mid in zip(both, is_call, mids):
            mid = float(mid)
            rows.append(
                {
                    "underlying": underlying, "strike": float(strike),
                    "expiration": exp,
                    "option_type": "call" if call_flag else "put",
                    "bid": max(mid * 0.98, 0.01),
                    "ask": mid * 1.02 + 0.01, "last": mid, "volume": 500,
                    "open_interest": 1000,
                }
            )
        return rows


class _RESTProvider(DataProvider):
    """Shared REST plumbing for the external providers.  Network access is
    environment-dependent; constructors never touch the network."""

    base_url = ""

    def __init__(self, api_key: Optional[str] = None, rate_limiter: Optional[RateLimiter] = None):
        super().__init__(rate_limiter)
        self.api_key = api_key

    def _get(self, url: str, params: Optional[Dict] = None) -> Any:
        import requests

        self.rate_limiter.acquire()
        resp = requests.get(url, params=params or {}, timeout=10)
        resp.raise_for_status()
        return resp.json()


class YahooProvider(_RESTProvider):
    """Yahoo chart API (providers.py:289-466)."""

    name = "yahoo"
    base_url = "https://query1.finance.yahoo.com"

    def get_bars(self, symbol, start, end, interval="1d") -> List[Bar]:
        data = self._get(
            f"{self.base_url}/v8/finance/chart/{symbol}",
            {
                "period1": int(datetime.combine(start, datetime.min.time()).timestamp()),
                "period2": int(datetime.combine(end, datetime.min.time()).timestamp()),
                "interval": interval,
            },
        )
        result = data["chart"]["result"][0]
        ts = result["timestamp"]
        q = result["indicators"]["quote"][0]
        return [
            Bar(
                time=datetime.fromtimestamp(t, tz=timezone.utc),
                open=q["open"][i], high=q["high"][i], low=q["low"][i],
                close=q["close"][i], volume=q["volume"][i] or 0.0, symbol=symbol,
            )
            for i, t in enumerate(ts)
            if q["close"][i] is not None
        ]

    def get_quote(self, symbol) -> Quote:
        data = self._get(
            f"{self.base_url}/v8/finance/chart/{symbol}", {"interval": "1d", "range": "1d"}
        )
        meta = data["chart"]["result"][0]["meta"]
        px = meta["regularMarketPrice"]
        return Quote(symbol=symbol, bid=px, ask=px, last=px)


class AlphaVantageProvider(_RESTProvider):
    """Alpha Vantage daily series (providers.py:467-634)."""

    name = "alphavantage"
    base_url = "https://www.alphavantage.co/query"

    def get_bars(self, symbol, start, end, interval="1d") -> List[Bar]:
        data = self._get(
            self.base_url,
            {"function": "TIME_SERIES_DAILY", "symbol": symbol, "apikey": self.api_key,
             "outputsize": "full"},
        )
        series = data.get("Time Series (Daily)", {})
        bars = []
        for day, row in sorted(series.items()):
            d = date.fromisoformat(day)
            if start <= d <= end:
                bars.append(
                    Bar(
                        time=datetime.combine(d, datetime.min.time()),
                        open=float(row["1. open"]), high=float(row["2. high"]),
                        low=float(row["3. low"]), close=float(row["4. close"]),
                        volume=float(row["5. volume"]), symbol=symbol,
                    )
                )
        return bars

    def get_quote(self, symbol) -> Quote:
        data = self._get(
            self.base_url, {"function": "GLOBAL_QUOTE", "symbol": symbol, "apikey": self.api_key}
        )
        px = float(data["Global Quote"]["05. price"])
        return Quote(symbol=symbol, bid=px, ask=px, last=px)


class PolygonProvider(_RESTProvider):
    """Polygon aggregates (providers.py:635-819)."""

    name = "polygon"
    base_url = "https://api.polygon.io"

    def get_bars(self, symbol, start, end, interval="1d") -> List[Bar]:
        data = self._get(
            f"{self.base_url}/v2/aggs/ticker/{symbol}/range/1/day/{start}/{end}",
            {"apiKey": self.api_key},
        )
        return [
            Bar(
                time=datetime.fromtimestamp(r["t"] / 1000, tz=timezone.utc),
                open=r["o"], high=r["h"], low=r["l"], close=r["c"],
                volume=r.get("v", 0.0), symbol=symbol,
            )
            for r in data.get("results", [])
        ]

    def get_quote(self, symbol) -> Quote:
        data = self._get(f"{self.base_url}/v2/last/trade/{symbol}", {"apiKey": self.api_key})
        px = data["results"]["p"]
        return Quote(symbol=symbol, bid=px, ask=px, last=px)


class IEXProvider(_RESTProvider):
    """IEX Cloud (providers.py:820-939)."""

    name = "iex"
    base_url = "https://cloud.iexapis.com/stable"

    def get_bars(self, symbol, start, end, interval="1d") -> List[Bar]:
        data = self._get(
            f"{self.base_url}/stock/{symbol}/chart/1y", {"token": self.api_key}
        )
        bars = []
        for r in data:
            d = date.fromisoformat(r["date"])
            if start <= d <= end:
                bars.append(
                    Bar(
                        time=datetime.combine(d, datetime.min.time()),
                        open=r["open"], high=r["high"], low=r["low"],
                        close=r["close"], volume=r.get("volume", 0.0), symbol=symbol,
                    )
                )
        return bars

    def get_quote(self, symbol) -> Quote:
        data = self._get(f"{self.base_url}/stock/{symbol}/quote", {"token": self.api_key})
        return Quote(
            symbol=symbol,
            bid=data.get("iexBidPrice") or data["latestPrice"],
            ask=data.get("iexAskPrice") or data["latestPrice"],
            last=data["latestPrice"],
        )


_PROVIDERS = {
    "simulated": SimulatedDataProvider,
    "yahoo": YahooProvider,
    "alphavantage": AlphaVantageProvider,
    "polygon": PolygonProvider,
    "iex": IEXProvider,
}


def create_provider(name: str, **kwargs) -> DataProvider:
    """Provider factory (providers.py:940-984)."""
    if name not in _PROVIDERS:
        raise ValueError(f"Unknown provider '{name}'. Available: {sorted(_PROVIDERS)}")
    return _PROVIDERS[name](**kwargs)
