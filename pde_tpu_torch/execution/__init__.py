"""Live-trading execution: orders, the simulated broker, the order manager
and the kill switch (the reference's algorithms, routing, TCA and
reconciliation modules are not ported yet)."""

from . import broker, emergency, order, order_manager  # noqa: F401
from .broker import SimulatedBroker  # noqa: F401
from .emergency import KillSwitch  # noqa: F401
from .order import Fill, Order, OrderSide, OrderStatus, OrderType  # noqa: F401
from .order_manager import OrderManager  # noqa: F401
