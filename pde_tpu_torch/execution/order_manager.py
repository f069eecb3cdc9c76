"""Order lifecycle management: validation, submission, state, event log.

Plain copy of ``pde_tpu/execution/order_manager.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.

Mirrors the reference execution/order_manager.py: the OrderValidator with
fat-finger and limit checks (:118-241) and the OrderManager driving
validation -> submission -> fills -> terminal states with a complete event
log (:242-816).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from .order import Fill, Order, OrderStatus

__all__ = ["ValidationError", "OrderValidator", "OrderManager"]


@dataclass
class ValidationError:
    rule: str
    message: str


class OrderValidator:
    """Pre-submission checks (order_manager.py:118-241)."""

    def __init__(
        self,
        max_order_value: float = 1_000_000.0,
        max_quantity: float = 100_000.0,
        max_price_deviation_pct: float = 0.10,
        allowed_symbols: Optional[set] = None,
    ):
        self.max_order_value = max_order_value
        self.max_quantity = max_quantity
        self.max_price_deviation_pct = max_price_deviation_pct
        self.allowed_symbols = allowed_symbols

    def validate(self, order: Order, reference_price: Optional[float] = None) -> List[ValidationError]:
        errors: List[ValidationError] = []
        if self.allowed_symbols is not None and order.symbol not in self.allowed_symbols:
            errors.append(ValidationError("symbol_whitelist", f"{order.symbol} not tradeable"))
        if order.quantity > self.max_quantity:
            errors.append(
                ValidationError("fat_finger_quantity",
                                f"quantity {order.quantity:,.0f} > max {self.max_quantity:,.0f}")
            )
        ref = order.limit_price or reference_price
        if ref is not None:
            value = order.quantity * ref
            if value > self.max_order_value:
                errors.append(
                    ValidationError("fat_finger_value",
                                    f"order value {value:,.0f} > max {self.max_order_value:,.0f}")
                )
        if order.limit_price is not None and reference_price is not None and reference_price > 0:
            dev = abs(order.limit_price - reference_price) / reference_price
            if dev > self.max_price_deviation_pct:
                errors.append(
                    ValidationError("price_deviation",
                                    f"limit {order.limit_price} deviates {dev:.1%} from market")
                )
        return errors


class OrderManager:
    """Order book-keeping and lifecycle driving (order_manager.py:242-816)."""

    def __init__(self, validator: Optional[OrderValidator] = None, risk_manager=None, broker=None):
        self.validator = validator or OrderValidator()
        self.risk_manager = risk_manager
        self.broker = broker
        self.orders: Dict[str, Order] = {}
        self.event_log: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------ API

    def submit_order(self, order: Order, reference_price: Optional[float] = None) -> Order:
        """Validate then submit (to the broker if attached)."""
        self.orders[order.order_id] = order
        order.transition(OrderStatus.VALIDATING)
        self._log(order, "validating")

        errors = self.validator.validate(order, reference_price)
        if self.risk_manager is not None and reference_price:
            check = self.risk_manager.check_position_allowed(
                order.symbol,
                order.quantity if order.side.is_buy else -order.quantity,
                reference_price,
            )
            if not check.is_allowed:
                errors.extend(ValidationError("risk_limit", b) for b in check.breached_limits)

        if errors:
            order.transition(OrderStatus.REJECTED)
            order.metadata["rejections"] = [e.__dict__ for e in errors]
            self._log(order, "rejected", errors=[e.message for e in errors])
            return order

        order.transition(OrderStatus.SUBMITTED)
        self._log(order, "submitted")
        if self.broker is not None:
            self.broker.submit_order(order)
        return order

    def acknowledge(self, order_id: str) -> None:
        order = self.orders[order_id]
        order.transition(OrderStatus.ACKNOWLEDGED)
        self._log(order, "acknowledged")

    def process_fill(self, fill: Fill) -> Order:
        order = self.orders[fill.order_id]
        order.add_fill(fill)
        self._log(order, "fill", quantity=fill.quantity, price=fill.price)
        return order

    def cancel_order(self, order_id: str) -> Order:
        order = self.orders[order_id]
        if order.is_terminal:
            return order
        if order.status in (OrderStatus.SUBMITTED, OrderStatus.ACKNOWLEDGED,
                            OrderStatus.PARTIALLY_FILLED):
            order.transition(OrderStatus.CANCELLING)
            if self.broker is not None and not self.broker.cancel_order(order_id):
                # broker refused — typically the order already filled there;
                # marking it CANCELLED anyway would diverge the book from
                # the broker (position drift FillReconciler would only catch
                # later).  Leave it CANCELLING for the broker callbacks /
                # reconciliation to resolve.
                self._log(order, "cancel_rejected")
                return order
            order.transition(OrderStatus.CANCELLED)
        else:
            order.transition(OrderStatus.CANCELLED)
        self._log(order, "cancelled")
        return order

    def cancel_all(self, symbol: Optional[str] = None) -> int:
        n = 0
        for order in list(self.orders.values()):
            if order.is_active and (symbol is None or order.symbol == symbol):
                self.cancel_order(order.order_id)
                n += 1
        return n

    # ----------------------------------------------------------- queries

    def get_order(self, order_id: str) -> Optional[Order]:
        return self.orders.get(order_id)

    def active_orders(self, symbol: Optional[str] = None) -> List[Order]:
        return [
            o for o in self.orders.values()
            if o.is_active and (symbol is None or o.symbol == symbol)
        ]

    def get_events(self, order_id: Optional[str] = None) -> List[Dict[str, Any]]:
        if order_id is None:
            return list(self.event_log)
        return [e for e in self.event_log if e["order_id"] == order_id]

    # ----------------------------------------------------------- internal

    def _log(self, order: Order, event: str, **extra) -> None:
        self.event_log.append(
            {
                "time": datetime.now(timezone.utc).isoformat(),
                "order_id": order.order_id,
                "symbol": order.symbol,
                "event": event,
                "status": order.status.value,
                **extra,
            }
        )
