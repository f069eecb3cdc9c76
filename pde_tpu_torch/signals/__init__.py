"""Trading signals: vol-surface arbitrage, mean reversion, variance
premium, aggregation."""

from . import aggregator, mean_reversion, variance_premium, vol_arbitrage  # noqa: F401
from .aggregator import AggregatedSignal, SignalAggregator  # noqa: F401
from .mean_reversion import MeanReversionSignalGenerator  # noqa: F401
from .variance_premium import VariancePremiumStrategy  # noqa: F401
from .vol_arbitrage import VolSurfaceArbitrageSignal  # noqa: F401
