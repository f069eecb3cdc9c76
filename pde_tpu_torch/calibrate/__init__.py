"""Calibration engine: batched DE + batched-start LM, the Heston, Bates,
rough Heston and SABR calibrators, and the OU fitter."""

from . import bates, de, heston, lm, ou, rough, sabr  # noqa: F401
from .bates import BatesCalibrator  # noqa: F401
from .heston import HestonCalibrator  # noqa: F401
from .ou import OUFitter  # noqa: F401
from .rough import RoughHestonCalibrator  # noqa: F401
from .sabr import SABRCalibrator  # noqa: F401
