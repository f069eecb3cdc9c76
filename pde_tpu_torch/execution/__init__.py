"""Live-trading execution: orders, algorithms, routing, the simulated
broker, the order manager, the kill switch, transaction-cost analysis and
reconciliation."""

from . import algorithms, broker, emergency, order, order_manager, reconciliation, routing, tca  # noqa: F401
from .broker import SimulatedBroker  # noqa: F401
from .emergency import KillSwitch  # noqa: F401
from .order import Fill, Order, OrderSide, OrderStatus, OrderType  # noqa: F401
from .order_manager import OrderManager  # noqa: F401
