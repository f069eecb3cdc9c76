"""Broker gateway: ABC, simulated broker, reconnecting connection manager.

Plain copy of ``pde_tpu/execution/broker.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.

Mirrors the reference execution/broker.py: the BrokerGateway interface
(:50-302), the SimulatedBroker with slippage fills, account/margin tracking
and fill callbacks (:303-650), and the auto-reconnecting
BrokerConnectionManager (:652-784).
"""

from __future__ import annotations

import abc
import threading
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Callable, Dict, List, Optional

from .order import Fill, Order, OrderSide, OrderStatus, OrderType

__all__ = ["AccountState", "BrokerGateway", "SimulatedBroker", "BrokerConnectionManager"]


@dataclass
class AccountState:
    cash: float = 1_000_000.0
    buying_power: float = 2_000_000.0
    positions: Dict[str, float] = field(default_factory=dict)
    avg_prices: Dict[str, float] = field(default_factory=dict)

    @property
    def position_value(self) -> float:
        return sum(q * self.avg_prices.get(s, 0.0) for s, q in self.positions.items())


class BrokerGateway(abc.ABC):
    """Broker interface (broker.py:50-302)."""

    def __init__(self):
        self._fill_callbacks: List[Callable[[Fill], None]] = []
        self.connected = False

    def on_fill(self, callback: Callable[[Fill], None]) -> None:
        self._fill_callbacks.append(callback)

    def _notify_fill(self, fill: Fill) -> None:
        for cb in self._fill_callbacks:
            cb(fill)

    @abc.abstractmethod
    def connect(self) -> bool:
        ...

    @abc.abstractmethod
    def disconnect(self) -> None:
        ...

    @abc.abstractmethod
    def submit_order(self, order: Order) -> str:
        ...

    @abc.abstractmethod
    def cancel_order(self, order_id: str) -> bool:
        ...

    @abc.abstractmethod
    def get_positions(self) -> Dict[str, float]:
        ...

    @abc.abstractmethod
    def get_account(self) -> AccountState:
        ...


class SimulatedBroker(BrokerGateway):
    """In-memory broker with immediate slippage fills (broker.py:303-650).

    Market orders fill instantly at price * (1 +/- slippage); limit orders
    rest until ``update_price`` crosses them.  Margin: buys must fit within
    buying power.
    """

    def __init__(self, initial_cash: float = 1_000_000.0, slippage_pct: float = 0.0005,
                 commission_per_share: float = 0.005, margin_ratio: float = 2.0):
        super().__init__()
        self.account = AccountState(cash=initial_cash, buying_power=initial_cash * margin_ratio)
        self.slippage_pct = slippage_pct
        self.commission_per_share = commission_per_share
        self.margin_ratio = margin_ratio
        self.prices: Dict[str, float] = {}
        self.open_orders: Dict[str, Order] = {}
        self.fill_history: List[Fill] = []

    # -------------------------------------------------------------- admin

    def connect(self) -> bool:
        self.connected = True
        return True

    def disconnect(self) -> None:
        self.connected = False

    def set_price(self, symbol: str, price: float) -> None:
        self.prices[symbol] = price

    def update_price(self, symbol: str, price: float) -> List[Fill]:
        """New market price: fill any resting limit/stop orders it crosses."""
        self.set_price(symbol, price)
        fills = []
        for order in list(self.open_orders.values()):
            if order.symbol != symbol or not order.is_active:
                continue
            if self._is_marketable(order, price):
                if not self._margin_ok(order, price):
                    self.open_orders.pop(order.order_id, None)
                    order.transition(OrderStatus.REJECTED)
                    continue
                fills.append(self._fill(order, price))
        return fills

    # -------------------------------------------------------------- orders

    def submit_order(self, order: Order) -> str:
        if not self.connected:
            raise ConnectionError("broker not connected")
        price = self.prices.get(order.symbol)
        if order.status == OrderStatus.PENDING:
            order.transition(OrderStatus.SUBMITTED)
        order.transition(OrderStatus.ACKNOWLEDGED)

        if order.order_type == OrderType.MARKET:
            if price is None:
                order.transition(OrderStatus.REJECTED)
                raise ValueError(f"no market price for {order.symbol}")
            if not self._margin_ok(order, price):
                order.transition(OrderStatus.REJECTED)
                return order.order_id
            self._fill(order, price)
        else:
            if price is not None and self._is_marketable(order, price):
                if not self._margin_ok(order, price):
                    order.transition(OrderStatus.REJECTED)
                    return order.order_id
                self._fill(order, price)
            else:
                self.open_orders[order.order_id] = order
        return order.order_id

    def cancel_order(self, order_id: str) -> bool:
        order = self.open_orders.pop(order_id, None)
        if order is None or order.is_terminal:
            return False
        if order.status in (OrderStatus.SUBMITTED, OrderStatus.ACKNOWLEDGED,
                            OrderStatus.PARTIALLY_FILLED):
            order.transition(OrderStatus.CANCELLING)
        order.transition(OrderStatus.CANCELLED)
        return True

    def cancel_all(self) -> int:
        ids = list(self.open_orders)
        return sum(self.cancel_order(i) for i in ids)

    # ------------------------------------------------------------ queries

    def get_positions(self) -> Dict[str, float]:
        return dict(self.account.positions)

    def get_account(self) -> AccountState:
        return self.account

    # ----------------------------------------------------------- internal

    def _is_marketable(self, order: Order, price: float) -> bool:
        if order.order_type == OrderType.MARKET:
            return True
        if order.order_type == OrderType.LIMIT:
            return price <= order.limit_price if order.side.is_buy else price >= order.limit_price
        if order.order_type == OrderType.STOP:
            return price >= order.stop_price if order.side.is_buy else price <= order.stop_price
        return False

    def _margin_ok(self, order: Order, price: float) -> bool:
        if not order.side.is_buy:
            return True
        return order.quantity * price <= self.account.buying_power

    def _fill(self, order: Order, price: float) -> Fill:
        sign = 1.0 if order.side.is_buy else -1.0
        fill_price = price * (1.0 + sign * self.slippage_pct)
        qty = order.remaining_quantity
        commission = max(1.0, qty * self.commission_per_share)

        fill = Fill(
            order_id=order.order_id, symbol=order.symbol, side=order.side,
            quantity=qty, price=fill_price, commission=commission,
        )
        order.add_fill(fill)
        self.open_orders.pop(order.order_id, None)

        pos_delta = qty * sign
        prev = self.account.positions.get(order.symbol, 0.0)
        new = prev + pos_delta
        if abs(new) < 1e-9:
            self.account.positions.pop(order.symbol, None)
            self.account.avg_prices.pop(order.symbol, None)
        else:
            self.account.positions[order.symbol] = new
            if prev == 0 or (prev > 0) != (new > 0):
                # fresh position or flip: basis resets to this fill
                self.account.avg_prices[order.symbol] = fill_price
            elif abs(new) > abs(prev):
                # adding to a position: volume-weighted average cost
                old_avg = self.account.avg_prices.get(order.symbol, fill_price)
                added = abs(new) - abs(prev)
                self.account.avg_prices[order.symbol] = (
                    old_avg * abs(prev) + fill_price * added
                ) / abs(new)
        self.account.cash -= pos_delta * fill_price + commission
        self.account.buying_power = self.account.cash * self.margin_ratio

        self.fill_history.append(fill)
        # submit-to-fill latency, per symbol and per venue (reference
        # metrics.py:352-359 + the per-venue breakdown)
        from ..monitoring import metrics as _mt

        latency = max(
            (fill.timestamp - order.created_at).total_seconds(), 0.0)
        _mt.order_fill_latency.labels(symbol=order.symbol).observe(latency)
        _mt.fill_latency_by_venue.labels(venue=fill.venue).observe(latency)
        _mt.orders_total.labels(status="filled").inc()
        self._notify_fill(fill)
        return fill


class BrokerConnectionManager:
    """Monitors the gateway and reconnects with backoff (broker.py:652-784)."""

    def __init__(self, broker: BrokerGateway, check_interval: float = 1.0,
                 max_backoff: float = 60.0, on_reconnect: Optional[Callable] = None):
        self.broker = broker
        self.check_interval = check_interval
        self.max_backoff = max_backoff
        self.on_reconnect = on_reconnect
        self.reconnect_count = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def ensure_connected(self) -> bool:
        """One reconnect attempt cycle with exponential backoff."""
        if self.broker.connected:
            return True
        backoff = self.check_interval
        for _ in range(8):
            if self.broker.connect():
                self.reconnect_count += 1
                if self.on_reconnect:
                    self.on_reconnect()
                return True
            time.sleep(min(backoff, self.max_backoff))
            backoff *= 2
        return False

    def start(self) -> None:
        self._running = True

        def monitor():
            while self._running:
                if not self.broker.connected:
                    self.ensure_connected()
                time.sleep(self.check_interval)

        self._thread = threading.Thread(target=monitor, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=2.0)
