"""Order and fill domain model with a FIX-compatible state machine.

Plain copy of ``pde_tpu/execution/order.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference execution/order.py: the OrderStatus lifecycle (:28-44),
order types / sides / time-in-force / capacity enums (:45-92), the Fill
record with cost accounting (:93-147) and the Order aggregate with
state-transition validation and fill application (:148-493).
"""

from __future__ import annotations

import enum
import itertools
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

__all__ = ["OrderStatus", "OrderType", "OrderSide", "TimeInForce", "OrderCapacity", "Fill", "Order"]


class OrderStatus(str, enum.Enum):
    PENDING = "PENDING"
    VALIDATING = "VALIDATING"
    SUBMITTED = "SUBMITTED"
    ACKNOWLEDGED = "ACKNOWLEDGED"
    PARTIALLY_FILLED = "PARTIALLY_FILLED"
    FILLED = "FILLED"
    CANCELLING = "CANCELLING"
    CANCELLED = "CANCELLED"
    REJECTED = "REJECTED"
    EXPIRED = "EXPIRED"
    REPLACED = "REPLACED"
    SUSPENDED = "SUSPENDED"


# legal state transitions (order.py state machine)
_TRANSITIONS: Dict[OrderStatus, set] = {
    OrderStatus.PENDING: {OrderStatus.VALIDATING, OrderStatus.SUBMITTED, OrderStatus.REJECTED,
                          OrderStatus.CANCELLED},
    OrderStatus.VALIDATING: {OrderStatus.SUBMITTED, OrderStatus.REJECTED},
    OrderStatus.SUBMITTED: {OrderStatus.ACKNOWLEDGED, OrderStatus.PARTIALLY_FILLED,
                            OrderStatus.FILLED, OrderStatus.REJECTED, OrderStatus.CANCELLING,
                            OrderStatus.CANCELLED, OrderStatus.EXPIRED},
    OrderStatus.ACKNOWLEDGED: {OrderStatus.PARTIALLY_FILLED, OrderStatus.FILLED,
                               OrderStatus.CANCELLING, OrderStatus.CANCELLED,
                               OrderStatus.REJECTED, OrderStatus.EXPIRED,
                               OrderStatus.REPLACED, OrderStatus.SUSPENDED},
    OrderStatus.PARTIALLY_FILLED: {OrderStatus.PARTIALLY_FILLED, OrderStatus.FILLED,
                                   OrderStatus.CANCELLING, OrderStatus.CANCELLED,
                                   OrderStatus.EXPIRED, OrderStatus.REPLACED},
    OrderStatus.CANCELLING: {OrderStatus.CANCELLED, OrderStatus.PARTIALLY_FILLED,
                             OrderStatus.FILLED},
    OrderStatus.SUSPENDED: {OrderStatus.ACKNOWLEDGED, OrderStatus.CANCELLED},
    # terminal states
    OrderStatus.FILLED: set(),
    OrderStatus.CANCELLED: set(),
    OrderStatus.REJECTED: set(),
    OrderStatus.EXPIRED: set(),
    OrderStatus.REPLACED: set(),
}

TERMINAL_STATES = {s for s, nxt in _TRANSITIONS.items() if not nxt}


class OrderType(str, enum.Enum):
    MARKET = "MARKET"
    LIMIT = "LIMIT"
    STOP = "STOP"
    STOP_LIMIT = "STOP_LIMIT"
    TRAILING_STOP = "TRAILING_STOP"
    MARKET_ON_CLOSE = "MOC"
    LIMIT_ON_CLOSE = "LOC"
    ICEBERG = "ICEBERG"
    TWAP = "TWAP"
    VWAP = "VWAP"
    PEG = "PEG"


class OrderSide(str, enum.Enum):
    BUY = "BUY"
    SELL = "SELL"
    SHORT = "SHORT"
    COVER = "COVER"

    @property
    def is_buy(self) -> bool:
        return self in (OrderSide.BUY, OrderSide.COVER)


class TimeInForce(str, enum.Enum):
    DAY = "DAY"
    GTC = "GTC"
    IOC = "IOC"
    FOK = "FOK"
    GTD = "GTD"
    OPG = "OPG"
    CLS = "CLS"


class OrderCapacity(str, enum.Enum):
    AGENCY = "AGENCY"
    PRINCIPAL = "PRINCIPAL"
    RISKLESS_PRINCIPAL = "RISKLESS_PRINCIPAL"


@dataclass
class Fill:
    """Execution fill (order.py:93-147)."""

    order_id: str
    symbol: str
    side: OrderSide
    quantity: float
    price: float
    commission: float = 0.0
    fees: float = 0.0
    venue: str = "SIM"
    fill_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    @property
    def notional_value(self) -> float:
        return abs(self.quantity) * self.price

    @property
    def total_cost(self) -> float:
        return self.commission + self.fees

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["side"] = self.side.value
        d["timestamp"] = self.timestamp.isoformat()
        return d


class InvalidTransition(Exception):
    pass


@dataclass
class Order:
    """Order aggregate with lifecycle enforcement (order.py:148-493)."""

    symbol: str
    side: OrderSide
    quantity: float
    order_type: OrderType = OrderType.MARKET
    limit_price: Optional[float] = None
    stop_price: Optional[float] = None
    time_in_force: TimeInForce = TimeInForce.DAY
    capacity: OrderCapacity = OrderCapacity.PRINCIPAL
    strategy_id: str = ""
    order_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    parent_order_id: Optional[str] = None
    child_order_ids: List[str] = field(default_factory=list)
    status: OrderStatus = OrderStatus.PENDING
    filled_quantity: float = 0.0
    avg_fill_price: float = 0.0
    fills: List[Fill] = field(default_factory=list)
    status_history: List[tuple] = field(default_factory=list)
    created_at: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    metadata: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.quantity <= 0:
            raise ValueError("quantity must be positive")
        if self.order_type in (OrderType.LIMIT, OrderType.STOP_LIMIT) and self.limit_price is None:
            raise ValueError(f"{self.order_type.value} order requires limit_price")
        if self.order_type in (OrderType.STOP, OrderType.STOP_LIMIT) and self.stop_price is None:
            raise ValueError(f"{self.order_type.value} order requires stop_price")
        self.status_history.append((self.status, self.created_at))

    # ------------------------------------------------------------- state

    @property
    def is_filled(self) -> bool:
        return self.status == OrderStatus.FILLED

    @property
    def is_active(self) -> bool:
        return self.status not in TERMINAL_STATES

    @property
    def is_terminal(self) -> bool:
        return self.status in TERMINAL_STATES

    @property
    def remaining_quantity(self) -> float:
        return max(0.0, self.quantity - self.filled_quantity)

    @property
    def fill_rate(self) -> float:
        return self.filled_quantity / self.quantity if self.quantity > 0 else 0.0

    @property
    def notional_value(self) -> float:
        ref = self.limit_price or self.avg_fill_price or 0.0
        return self.quantity * ref

    @property
    def total_cost(self) -> float:
        return sum(f.total_cost for f in self.fills)

    @property
    def has_children(self) -> bool:
        return bool(self.child_order_ids)

    @property
    def is_child(self) -> bool:
        return self.parent_order_id is not None

    def transition(self, new_status: OrderStatus, when: Optional[datetime] = None) -> None:
        """Enforce the FIX-style lifecycle (order.py:325-420)."""
        if new_status not in _TRANSITIONS.get(self.status, set()):
            raise InvalidTransition(f"{self.status.value} -> {new_status.value} not allowed")
        self.status = new_status
        self.status_history.append((new_status, when or datetime.now(timezone.utc)))

    def add_fill(self, fill: Fill) -> None:
        """Apply a fill, updating VWAP and status (order.py:325-380)."""
        if fill.quantity <= 0:
            raise ValueError("fill quantity must be positive")
        if fill.quantity > self.remaining_quantity + 1e-9:
            raise ValueError("fill exceeds remaining quantity")
        # validate the status transition BEFORE mutating fill state, so an
        # illegal fill (e.g. on a PENDING order) cannot leave the order
        # half-updated
        total = self.filled_quantity + fill.quantity
        target = (OrderStatus.FILLED if self.quantity - total <= 1e-9
                  else OrderStatus.PARTIALLY_FILLED)
        if target not in _TRANSITIONS.get(self.status, set()) and target != self.status:
            raise InvalidTransition(f"cannot fill from {self.status}")
        self.avg_fill_price = (
            self.avg_fill_price * self.filled_quantity + fill.price * fill.quantity
        ) / total
        self.filled_quantity = total
        self.fills.append(fill)
        if self.remaining_quantity <= 1e-9:
            self.transition(OrderStatus.FILLED, fill.timestamp)
        else:
            self.transition(OrderStatus.PARTIALLY_FILLED, fill.timestamp)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "order_id": self.order_id,
            "symbol": self.symbol,
            "side": self.side.value,
            "quantity": self.quantity,
            "order_type": self.order_type.value,
            "limit_price": self.limit_price,
            "stop_price": self.stop_price,
            "time_in_force": self.time_in_force.value,
            "status": self.status.value,
            "filled_quantity": self.filled_quantity,
            "avg_fill_price": self.avg_fill_price,
            "created_at": self.created_at.isoformat(),
            "strategy_id": self.strategy_id,
        }
