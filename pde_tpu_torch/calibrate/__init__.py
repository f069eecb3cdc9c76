"""Calibration engine: batched DE + batched-start LM, the Heston calibrator."""

from . import de, heston, lm  # noqa: F401
from .heston import HestonCalibrator  # noqa: F401
