"""Risk layer: sizing, limits, VaR, Greeks, correlation and drawdown
control."""

from . import (  # noqa: F401
    correlation_monitor,
    drawdown_controller,
    greeks_monitor,
    position_sizer,
    risk_manager,
    var_calculator,
)
from .drawdown_controller import DrawdownController  # noqa: F401
from .greeks_monitor import GreeksRiskMonitor  # noqa: F401
from .position_sizer import (KellyPositionSizer, VolatilityEstimator,  # noqa: F401
                             VolatilityScaledPositionSizer)
from .risk_manager import RiskManager  # noqa: F401
from .var_calculator import StressTester, VaRBacktester, VaRCalculator  # noqa: F401
