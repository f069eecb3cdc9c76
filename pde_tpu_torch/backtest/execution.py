"""Simulated execution: commission models + slippage fills.

Plain copy of ``pde_tpu/backtest/execution.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.

Mirrors the reference backtesting/execution.py: the commission-model family
(Zero / Fixed / PerShare / Tiered / IBKR, :31-199) and the simulated handler
with proportional slippage and square-root market impact plus limit/stop
trigger logic (:249-480), and the frictionless InstantExecutionHandler
(:482-528).
"""

from __future__ import annotations

import abc
from dataclasses import replace
from typing import Dict, Optional

import numpy as np

from .events import Direction, FillEvent, MarketEvent, OrderEvent, OrderType

__all__ = [
    "CommissionModel",
    "ZeroCommission",
    "FixedCommission",
    "PerShareCommission",
    "TieredCommission",
    "IBKRCommission",
    "ExecutionHandler",
    "SimulatedExecutionHandler",
    "InstantExecutionHandler",
]


class CommissionModel(abc.ABC):
    """Commission models accept the fill timestamp so time-dependent models
    (TieredCommission's monthly reset) follow *simulated* time in backtests
    rather than the wall clock; stateless models ignore it."""

    @abc.abstractmethod
    def calculate(self, quantity: float, price: float, timestamp=None) -> float:
        ...


class ZeroCommission(CommissionModel):
    def calculate(self, quantity, price, timestamp=None):
        return 0.0


class FixedCommission(CommissionModel):
    def __init__(self, commission: float = 1.0):
        self.commission = commission

    def calculate(self, quantity, price, timestamp=None):
        return self.commission


class PerShareCommission(CommissionModel):
    def __init__(self, rate: float = 0.005, minimum: float = 1.0):
        self.rate = rate
        self.minimum = minimum

    def calculate(self, quantity, price, timestamp=None):
        return max(self.minimum, abs(quantity) * self.rate)


class TieredCommission(CommissionModel):
    """Volume-tiered per-share rates (execution.py:117-156)."""

    def __init__(self, tiers=None, minimum: float = 0.35):
        # (threshold_shares, rate) sorted ascending
        self.tiers = tiers or [(300_000, 0.0035), (3_000_000, 0.002), (float("inf"), 0.0015)]
        self.minimum = minimum
        self._monthly_volume = 0.0
        self._month = None  # (year, month) the running volume belongs to

    def calculate(self, quantity, price, timestamp=None):
        from datetime import datetime, timezone

        # "monthly" volume resets at the month boundary; without the reset a
        # long backtest drifts permanently into the cheapest tier.  The
        # execution handler passes the ORDER timestamp, so simulated runs
        # reset on simulated month boundaries; wall clock is only a fallback
        # for direct live use.
        now = timestamp if timestamp is not None else datetime.now(timezone.utc)
        month = (now.year, now.month)
        if self._month != month:
            self._month = month
            self._monthly_volume = 0.0
        q = abs(quantity)
        for threshold, rate in self.tiers:
            if self._monthly_volume <= threshold:
                self._monthly_volume += q
                return max(self.minimum, q * rate)
        return max(self.minimum, q * self.tiers[-1][1])


class IBKRCommission(CommissionModel):
    """IBKR-style: $0.005/share, min $1, max 1% of trade value
    (execution.py:158-199)."""

    def calculate(self, quantity, price, timestamp=None):
        q = abs(quantity)
        raw = q * 0.005
        return float(np.clip(raw, 1.0, 0.01 * q * price))


class ExecutionHandler(abc.ABC):
    @abc.abstractmethod
    def execute_order(self, order: OrderEvent, events_queue) -> Optional[FillEvent]:
        ...

    def update_market_data(self, event: MarketEvent) -> None:  # noqa: B027
        pass


class SimulatedExecutionHandler(ExecutionHandler):
    """Slippage + market-impact fills with limit/stop logic
    (execution.py:249-480).

    fill = price * (1 +/- slippage_pct +/- impact), impact ~ k sqrt(Q/ADV).
    """

    def __init__(
        self,
        commission_model: Optional[CommissionModel] = None,
        slippage_pct: float = 0.0005,
        market_impact_coeff: float = 0.1,
        adv: float = 1e6,
    ):
        self.commission_model = commission_model or IBKRCommission()
        self.slippage_pct = slippage_pct
        self.market_impact_coeff = market_impact_coeff
        self.adv = adv
        self.current_prices: Dict[str, float] = {}
        self.current_times: Dict[str, object] = {}
        self.pending_orders: list[OrderEvent] = []

    def update_market_data(self, event: MarketEvent) -> None:
        self.current_prices[event.symbol] = event.price
        self.current_times[event.symbol] = event.timestamp

    def _fill_price(self, order: OrderEvent, price: float) -> tuple[float, float]:
        sign = 1.0 if order.direction == Direction.BUY else -1.0
        impact = self.market_impact_coeff * np.sqrt(abs(order.quantity) / self.adv)
        fill = price * (1.0 + sign * (self.slippage_pct + impact))
        slippage_cost = abs(fill - price) * abs(order.quantity)
        return float(fill), float(slippage_cost)

    def execute_order(self, order: OrderEvent, events_queue=None) -> Optional[FillEvent]:
        price = self.current_prices.get(order.symbol)
        if price is None or price <= 0:
            return None

        is_buy = order.direction == Direction.BUY

        def limit_ok():
            return (is_buy and price <= order.limit_price) or (
                not is_buy and price >= order.limit_price
            )

        def stop_hit():
            return (is_buy and price >= order.stop_price) or (
                not is_buy and price <= order.stop_price
            )

        # limit/stop/stop-limit triggering (execution.py:376-460)
        enforce_limit = False
        if order.order_type == OrderType.LIMIT:
            enforce_limit = True
            if not limit_ok():
                self.pending_orders.append(order)
                return None
        elif order.order_type == OrderType.STOP:
            if not stop_hit():
                self.pending_orders.append(order)
                return None
        elif order.order_type == OrderType.STOP_LIMIT:
            # stop leg arms the order; once armed it becomes a resting
            # LIMIT (standard semantics) so the limit leg keeps protecting
            # the fill price on later bars
            if not stop_hit():
                self.pending_orders.append(order)
                return None
            order = replace(order, order_type=OrderType.LIMIT)
            enforce_limit = True
            if not limit_ok():
                self.pending_orders.append(order)
                return None

        fill_price, slippage = self._fill_price(order, price)
        if enforce_limit:
            # a limit order can never fill through its limit: slippage /
            # impact is capped at the limit price (the maker's protection)
            capped = (
                min(fill_price, order.limit_price)
                if is_buy
                else max(fill_price, order.limit_price)
            )
            if capped != fill_price:
                fill_price = float(capped)
                slippage = abs(fill_price - price) * abs(order.quantity)
        # stamp the fill with the bar that TRIGGERED it, not the submission
        # time — a resting order can fill months later
        fill_time = self.current_times.get(order.symbol, order.timestamp)
        commission = self.commission_model.calculate(
            order.quantity, fill_price, timestamp=fill_time
        )
        fill = FillEvent(
            event_type=None,
            timestamp=fill_time,
            symbol=order.symbol,
            direction=order.direction,
            quantity=order.quantity,
            fill_price=fill_price,
            commission=commission,
            slippage=slippage,
            order_id=order.order_id,
        )
        if events_queue is not None:
            events_queue.put(fill)
        return fill

    def process_pending(self, events_queue=None) -> list[FillEvent]:
        """Re-check resting limit/stop orders against latest prices.

        Called by BacktestEngine on every MARKET event, so a limit/stop
        order placed on one bar fills on the first later bar that crosses
        its trigger.  execute_order re-queues any still-unmarketable order
        into self.pending_orders itself.
        """
        fills = []
        orders, self.pending_orders = self.pending_orders, []
        for order in orders:
            fill = self.execute_order(order, events_queue)
            if fill is not None:
                fills.append(fill)
        return fills


class InstantExecutionHandler(ExecutionHandler):
    """Frictionless fills at the current price (execution.py:482-528)."""

    def __init__(self):
        self.current_prices: Dict[str, float] = {}

    def update_market_data(self, event: MarketEvent) -> None:
        self.current_prices[event.symbol] = event.price

    def execute_order(self, order: OrderEvent, events_queue=None) -> Optional[FillEvent]:
        price = self.current_prices.get(order.symbol)
        if price is None or price <= 0:
            return None
        fill = FillEvent(
            event_type=None,
            timestamp=order.timestamp,
            symbol=order.symbol,
            direction=order.direction,
            quantity=order.quantity,
            fill_price=price,
            commission=0.0,
            slippage=0.0,
        )
        if events_queue is not None:
            events_queue.put(fill)
        return fill
