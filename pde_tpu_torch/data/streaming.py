"""Streaming market data: event model, simulated feed, bar aggregation.

Plain copy of ``pde_tpu/data/streaming.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference data/streaming.py: the stream event taxonomy
(quote/trade/bar; :40-183), the DataStreamProvider ABC (:184-271), the
seeded random-walk SimulatedStreamProvider (:272-397), the time-bucket
BarAggregator (:598-714), the fixed-size RingBuffer (:715-776) and the
StreamManager fan-out (:777-906).  The Polygon websocket provider is
represented by a thin adapter over ``websockets`` (zero-egress here, so it
is constructed but never connected in tests).
"""

from __future__ import annotations

import abc
import enum
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "StreamEventType",
    "StreamQuote",
    "StreamTrade",
    "StreamBar",
    "DataStreamProvider",
    "SimulatedStreamProvider",
    "PolygonStreamProvider",
    "BarAggregator",
    "RingBuffer",
    "StreamManager",
]


class StreamEventType(str, enum.Enum):
    QUOTE = "quote"
    TRADE = "trade"
    BAR = "bar"
    ORDERBOOK = "orderbook"


@dataclass
class StreamQuote:
    symbol: str
    bid: float
    ask: float
    bid_size: float = 0.0
    ask_size: float = 0.0
    time: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    event_type: StreamEventType = StreamEventType.QUOTE


@dataclass
class StreamTrade:
    symbol: str
    price: float
    size: float
    time: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    event_type: StreamEventType = StreamEventType.TRADE


@dataclass
class StreamBar:
    symbol: str
    open: float
    high: float
    low: float
    close: float
    volume: float
    start_time: datetime
    end_time: datetime
    event_type: StreamEventType = StreamEventType.BAR


class DataStreamProvider(abc.ABC):
    """Streaming provider interface (streaming.py:184-271)."""

    def __init__(self):
        self._callbacks: List[Callable] = []
        self._running = False

    def subscribe(self, callback: Callable) -> None:
        self._callbacks.append(callback)

    def _emit(self, event) -> None:
        for cb in self._callbacks:
            cb(event)

    @abc.abstractmethod
    def start(self, symbols: List[str]) -> None:
        ...

    def stop(self) -> None:
        self._running = False

    @property
    def is_running(self) -> bool:
        return self._running


class SimulatedStreamProvider(DataStreamProvider):
    """Seeded random-walk tick feed (streaming.py:272-397).

    ``step()`` produces one tick per symbol deterministically;
    ``start()`` spawns a background thread emitting at ``tick_interval``.
    """

    def __init__(self, seed: int = 42, tick_interval: float = 0.01, vol_per_tick: float = 5e-4,
                 base_prices: Optional[Dict[str, float]] = None):
        super().__init__()
        self.rng = np.random.default_rng(seed)
        self.tick_interval = tick_interval
        self.vol_per_tick = vol_per_tick
        self.prices: Dict[str, float] = dict(base_prices or {})
        self._thread: Optional[threading.Thread] = None

    def step(self, symbols: Optional[List[str]] = None) -> List[StreamTrade]:
        events = []
        for s in symbols or list(self.prices):
            px = self.prices.setdefault(s, 100.0)
            px *= float(np.exp(self.vol_per_tick * self.rng.standard_normal()))
            self.prices[s] = px
            trade = StreamTrade(symbol=s, price=px, size=float(self.rng.integers(1, 500)))
            events.append(trade)
            self._emit(trade)
            spread = px * 2e-4
            self._emit(StreamQuote(symbol=s, bid=px - spread, ask=px + spread))
        return events

    def start(self, symbols: List[str]) -> None:
        for s in symbols:
            self.prices.setdefault(s, 100.0)
        self._running = True

        def loop():
            while self._running:
                self.step(symbols)
                time.sleep(self.tick_interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        super().stop()
        if self._thread:
            self._thread.join(timeout=1.0)


class PolygonStreamProvider(DataStreamProvider):
    """Polygon websocket adapter (streaming.py:398-597).  Connection happens
    lazily in start(); requires network + API key."""

    WS_URL = "wss://socket.polygon.io/stocks"

    def __init__(self, api_key: str):
        super().__init__()
        self.api_key = api_key

    def start(self, symbols: List[str]) -> None:  # pragma: no cover - network
        import asyncio
        import json

        import websockets

        async def run():
            async with websockets.connect(self.WS_URL) as ws:
                await ws.send(json.dumps({"action": "auth", "params": self.api_key}))
                await ws.send(
                    json.dumps({"action": "subscribe", "params": ",".join(f"T.{s}" for s in symbols)})
                )
                self._running = True
                while self._running:
                    for msg in json.loads(await ws.recv()):
                        if msg.get("ev") == "T":
                            self._emit(
                                StreamTrade(symbol=msg["sym"], price=msg["p"], size=msg["s"])
                            )

        asyncio.get_event_loop().run_until_complete(run())


class BarAggregator:
    """Trades -> time-bucket OHLCV bars (streaming.py:598-714)."""

    def __init__(self, bar_seconds: float = 60.0, on_bar: Optional[Callable] = None):
        self.bar_seconds = bar_seconds
        self.on_bar = on_bar
        self._current: Dict[str, Dict] = {}

    def _bucket(self, ts: datetime) -> int:
        return int(ts.timestamp() // self.bar_seconds)

    def add_trade(self, trade: StreamTrade) -> Optional[StreamBar]:
        """Returns a completed bar when the trade rolls into a new bucket."""
        b = self._bucket(trade.time)
        cur = self._current.get(trade.symbol)
        completed = None
        if cur is not None and cur["bucket"] != b:
            completed = self._finalize(trade.symbol)
        cur = self._current.get(trade.symbol)
        if cur is None or cur["bucket"] != b:
            self._current[trade.symbol] = {
                "bucket": b, "open": trade.price, "high": trade.price,
                "low": trade.price, "close": trade.price, "volume": trade.size,
                "start": trade.time,
            }
        else:
            cur["high"] = max(cur["high"], trade.price)
            cur["low"] = min(cur["low"], trade.price)
            cur["close"] = trade.price
            cur["volume"] += trade.size
        return completed

    def _finalize(self, symbol: str) -> Optional[StreamBar]:
        cur = self._current.pop(symbol, None)
        if cur is None:
            return None
        bar = StreamBar(
            symbol=symbol, open=cur["open"], high=cur["high"], low=cur["low"],
            close=cur["close"], volume=cur["volume"], start_time=cur["start"],
            # bucket boundary, NOT the wall clock: a bar finalized by the
            # first trade after a pause (or during historical replay) must
            # not inherit the arrival time
            end_time=cur["start"] + timedelta(seconds=self.bar_seconds),
        )
        if self.on_bar:
            self.on_bar(bar)
        return bar

    def flush(self) -> List[StreamBar]:
        return [b for s in list(self._current) if (b := self._finalize(s))]


class RingBuffer:
    """Fixed-capacity event buffer (streaming.py:715-776)."""

    def __init__(self, capacity: int = 10_000):
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def append(self, item) -> None:
        with self._lock:
            self._buf.append(item)

    def latest(self, n: int = 1) -> List:
        with self._lock:
            return list(self._buf)[-n:]

    def __len__(self) -> int:
        return len(self._buf)


class StreamManager:
    """Provider fan-out + per-symbol buffers + bar aggregation
    (streaming.py:777-906)."""

    def __init__(self, provider: DataStreamProvider, bar_seconds: float = 60.0, buffer_capacity: int = 10_000):
        self.provider = provider
        self.aggregator = BarAggregator(bar_seconds)
        self.buffers: Dict[str, RingBuffer] = {}
        self.bars: Dict[str, List[StreamBar]] = {}
        self._capacity = buffer_capacity
        provider.subscribe(self._on_event)

    def _on_event(self, event) -> None:
        buf = self.buffers.setdefault(event.symbol, RingBuffer(self._capacity))
        buf.append(event)
        if isinstance(event, StreamTrade):
            bar = self.aggregator.add_trade(event)
            if bar is not None:
                self.bars.setdefault(bar.symbol, []).append(bar)

    def start(self, symbols: List[str]) -> None:
        self.provider.start(symbols)

    def stop(self) -> None:
        self.provider.stop()

    def latest_price(self, symbol: str) -> Optional[float]:
        buf = self.buffers.get(symbol)
        if not buf or len(buf) == 0:
            return None
        ev = buf.latest(1)[0]
        if isinstance(ev, StreamTrade):
            return ev.price
        if isinstance(ev, StreamQuote):
            return 0.5 * (ev.bid + ev.ask)
        return None
