"""Trading signals: vol-surface arbitrage."""

from . import vol_arbitrage  # noqa: F401
from .vol_arbitrage import VolSurfaceArbitrageSignal  # noqa: F401
