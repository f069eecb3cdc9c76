"""Event taxonomy for the event-driven backtester (plain copy of
``pde_tpu/backtest/events.py``).

MARKET/SIGNAL/ORDER/FILL typed events with bid/ask conveniences, order
types/directions, and fill cost accounting.  Events are plain dataclasses
on the host; the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, Optional

__all__ = [
    "EventType",
    "SignalType",
    "OrderType",
    "Direction",
    "Event",
    "MarketEvent",
    "SignalEvent",
    "OrderEvent",
    "FillEvent",
]


class EventType(str, enum.Enum):
    MARKET = "MARKET"
    SIGNAL = "SIGNAL"
    ORDER = "ORDER"
    FILL = "FILL"


class SignalType(str, enum.Enum):
    LONG = "LONG"
    SHORT = "SHORT"
    EXIT_LONG = "EXIT_LONG"
    EXIT_SHORT = "EXIT_SHORT"
    EXIT = "EXIT"


class OrderType(str, enum.Enum):
    MARKET = "MARKET"
    LIMIT = "LIMIT"
    STOP = "STOP"
    STOP_LIMIT = "STOP_LIMIT"


class Direction(str, enum.Enum):
    BUY = "BUY"
    SELL = "SELL"


@dataclass
class Event:
    event_type: EventType
    timestamp: datetime


@dataclass
class MarketEvent(Event):
    """New price bar (events.py:73-126)."""

    symbol: str = ""
    price: float = 0.0
    volume: float = 0.0
    bid: Optional[float] = None
    ask: Optional[float] = None
    open: Optional[float] = None
    high: Optional[float] = None
    low: Optional[float] = None
    market_data: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.event_type = EventType.MARKET

    @property
    def mid_price(self) -> float:
        if self.bid is not None and self.ask is not None:
            return 0.5 * (self.bid + self.ask)
        return self.price

    @property
    def spread(self) -> float:
        if self.bid is not None and self.ask is not None:
            return self.ask - self.bid
        return 0.0

    @property
    def spread_pct(self) -> float:
        mid = self.mid_price
        return self.spread / mid if mid > 0 else 0.0


@dataclass
class SignalEvent(Event):
    """Strategy output (events.py:128-165)."""

    symbol: str = ""
    signal_type: SignalType = SignalType.EXIT
    strength: float = 1.0
    strategy_id: str = ""
    target_pct: Optional[float] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.event_type = EventType.SIGNAL


@dataclass
class OrderEvent(Event):
    """Order to be executed (events.py:167-208)."""

    symbol: str = ""
    order_type: OrderType = OrderType.MARKET
    direction: Direction = Direction.BUY
    quantity: float = 0.0
    limit_price: Optional[float] = None
    stop_price: Optional[float] = None
    order_id: Optional[str] = None

    def __post_init__(self):
        self.event_type = EventType.ORDER

    def notional_value(self, price: float) -> float:
        return abs(self.quantity) * price


@dataclass
class FillEvent(Event):
    """Executed fill with costs (events.py:210-257)."""

    symbol: str = ""
    direction: Direction = Direction.BUY
    quantity: float = 0.0
    fill_price: float = 0.0
    commission: float = 0.0
    slippage: float = 0.0
    order_id: Optional[str] = None
    exchange: str = "SIM"

    def __post_init__(self):
        self.event_type = EventType.FILL

    @property
    def total_cost(self) -> float:
        return self.commission + self.slippage

    @property
    def notional_value(self) -> float:
        return abs(self.quantity) * self.fill_price

    @property
    def cost_bps(self) -> float:
        nv = self.notional_value
        return (self.total_cost / nv) * 1e4 if nv > 0 else 0.0
