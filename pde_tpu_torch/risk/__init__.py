"""Risk layer: volatility-managed sizing and VaR (the reference's limits,
Greeks, correlation and drawdown monitors are pure Python and are left out
of the port)."""

from . import position_sizer, var_calculator  # noqa: F401
from .position_sizer import (KellyPositionSizer, VolatilityEstimator,  # noqa: F401
                             VolatilityScaledPositionSizer)
from .var_calculator import StressTester, VaRBacktester, VaRCalculator  # noqa: F401
