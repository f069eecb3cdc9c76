"""Calibration engine: batched DE + batched-start LM, the Heston and SABR
calibrators, and the OU fitter."""

from . import de, heston, lm, ou, sabr  # noqa: F401
from .heston import HestonCalibrator  # noqa: F401
from .ou import OUFitter  # noqa: F401
from .sabr import SABRCalibrator  # noqa: F401
