"""Emergency controls: kill switch, position flattener, trading hours.

Plain copy of ``pde_tpu/execution/emergency.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.

Mirrors the reference execution/emergency.py: the KillSwitch (cancel-all +
halt + notification, :88-248), the PositionFlattener that unwinds the book
with market orders (:250-406) and the TradingHoursController (:408-520).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, time, timezone
from typing import Callable, Dict, List, Optional

from .order import Order, OrderSide, OrderType

__all__ = ["KillSwitchState", "KillSwitchEvent", "KillSwitch", "PositionFlattener", "TradingHoursController"]


class KillSwitchState(str, enum.Enum):
    ARMED = "armed"
    ENGAGED = "engaged"
    DISARMED = "disarmed"


@dataclass
class KillSwitchEvent:
    action: str
    reason: str
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))


class KillSwitch:
    """Hard trading halt (emergency.py:88-248): cancels everything, blocks
    new orders, notifies, and requires explicit two-step disarm."""

    def __init__(self, order_manager=None, broker=None,
                 notifiers: Optional[List[Callable[[str], None]]] = None):
        self.order_manager = order_manager
        self.broker = broker
        self.notifiers = notifiers or []
        self.state = KillSwitchState.ARMED
        self.events: List[KillSwitchEvent] = []
        self._engage_reason: Optional[str] = None

    @property
    def is_engaged(self) -> bool:
        return self.state == KillSwitchState.ENGAGED

    def engage(self, reason: str) -> Dict[str, int]:
        """Cancel all orders and halt (emergency.py:114-180)."""
        self.state = KillSwitchState.ENGAGED
        self._engage_reason = reason
        self.events.append(KillSwitchEvent("engage", reason))
        cancelled = 0
        if self.order_manager is not None:
            cancelled += self.order_manager.cancel_all()
        if self.broker is not None and hasattr(self.broker, "cancel_all"):
            cancelled += self.broker.cancel_all()
        self._notify(f"KILL SWITCH ENGAGED: {reason} ({cancelled} orders cancelled)")
        return {"orders_cancelled": cancelled}

    def check_allowed(self) -> bool:
        """Gate for new orders; False while engaged."""
        return not self.is_engaged

    def disarm(self, operator: str, confirmation: str) -> bool:
        """Two-step disarm: confirmation must echo 'DISARM' (emergency.py:200-248)."""
        if confirmation != "DISARM":
            self.events.append(KillSwitchEvent("disarm_rejected", f"bad confirmation by {operator}"))
            return False
        self.state = KillSwitchState.ARMED
        self.events.append(KillSwitchEvent("disarm", f"by {operator}"))
        self._notify(f"Kill switch disarmed by {operator}")
        return True

    def _notify(self, message: str) -> None:
        for n in self.notifiers:
            try:
                n(message)
            except Exception:  # noqa: BLE001 - notification must never block the halt
                pass


class PositionFlattener:
    """Unwind every open position with market orders (emergency.py:250-406)."""

    def __init__(self, broker, order_manager=None):
        self.broker = broker
        self.order_manager = order_manager

    def flatten_all(self, reason: str = "emergency flatten") -> List[Order]:
        orders = []
        for symbol, qty in self.broker.get_positions().items():
            if abs(qty) < 1e-9:
                continue
            side = OrderSide.SELL if qty > 0 else OrderSide.COVER
            order = Order(
                symbol=symbol, side=side, quantity=abs(qty),
                order_type=OrderType.MARKET, strategy_id="flattener",
                metadata={"reason": reason},
            )
            if self.order_manager is not None:
                self.order_manager.submit_order(
                    order, reference_price=self.broker.prices.get(symbol)
                )
            else:
                self.broker.submit_order(order)
            orders.append(order)
        return orders

    def flatten_symbol(self, symbol: str, reason: str = "") -> Optional[Order]:
        qty = self.broker.get_positions().get(symbol, 0.0)
        if abs(qty) < 1e-9:
            return None
        side = OrderSide.SELL if qty > 0 else OrderSide.COVER
        order = Order(symbol=symbol, side=side, quantity=abs(qty),
                      order_type=OrderType.MARKET, metadata={"reason": reason})
        self.broker.submit_order(order)
        return order


class TradingHoursController:
    """US-market session gate (emergency.py:408-520)."""

    def __init__(
        self,
        open_time: time = time(9, 30),
        close_time: time = time(16, 0),
        allow_premarket: bool = False,
        premarket_open: time = time(4, 0),
        allow_afterhours: bool = False,
        afterhours_close: time = time(20, 0),
        calendar=None,
        exchange_tz: str = "America/New_York",
    ):
        from ..data.reference import TradingCalendar

        self.exchange_tz = exchange_tz
        self.open_time = open_time
        self.close_time = close_time
        self.allow_premarket = allow_premarket
        self.premarket_open = premarket_open
        self.allow_afterhours = allow_afterhours
        self.afterhours_close = afterhours_close
        self.calendar = calendar or TradingCalendar()

    def _local(self, now: Optional[datetime]) -> datetime:
        """Session times are exchange-local; convert the (UTC) clock first
        — comparing a UTC wall time against 9:30-16:00 ET would block
        mid-session orders and open the gate overnight."""
        from zoneinfo import ZoneInfo

        now = now or datetime.now(timezone.utc)
        if now.tzinfo is None:
            return now  # caller already supplies exchange-local naive times
        return now.astimezone(ZoneInfo(self.exchange_tz))

    def is_market_open(self, now: Optional[datetime] = None) -> bool:
        now = self._local(now)
        if not self.calendar.is_trading_day(now.date()):
            return False
        t = now.time()
        lo = self.premarket_open if self.allow_premarket else self.open_time
        hi = self.afterhours_close if self.allow_afterhours else self.close_time
        return lo <= t < hi

    def session(self, now: Optional[datetime] = None) -> str:
        now = self._local(now)
        if not self.calendar.is_trading_day(now.date()):
            return "closed"
        t = now.time()
        if self.open_time <= t < self.close_time:
            return "regular"
        if self.premarket_open <= t < self.open_time:
            return "premarket"
        if self.close_time <= t < self.afterhours_close:
            return "afterhours"
        return "closed"
