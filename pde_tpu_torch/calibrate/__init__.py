"""Calibration engine: batched DE + batched-start LM, the Heston and SABR
calibrators."""

from . import de, heston, lm, sabr  # noqa: F401
from .heston import HestonCalibrator  # noqa: F401
from .sabr import SABRCalibrator  # noqa: F401
