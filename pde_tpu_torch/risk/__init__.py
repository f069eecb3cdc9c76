"""Risk layer: sizing, limits, VaR and drawdown control (the reference's
Greeks and correlation monitors are pure Python and are left out of the
port)."""

from . import drawdown_controller, position_sizer, risk_manager, var_calculator  # noqa: F401
from .drawdown_controller import DrawdownController  # noqa: F401
from .position_sizer import (KellyPositionSizer, VolatilityEstimator,  # noqa: F401
                             VolatilityScaledPositionSizer)
from .risk_manager import RiskManager  # noqa: F401
from .var_calculator import StressTester, VaRBacktester, VaRCalculator  # noqa: F401
