"""Calibration engine: batched DE + batched-start LM, the Heston, Bates,
rough Heston, SABR, Hull-White and G2++ calibrators, the OU fitter and the
daily orchestrator."""

from . import bates, de, g2, heston, lm, orchestrator, ou, rates, rough, sabr  # noqa: F401
from .bates import BatesCalibrator  # noqa: F401
from .g2 import G2Calibrator  # noqa: F401
from .heston import HestonCalibrator  # noqa: F401
from .orchestrator import CalibrationOrchestrator  # noqa: F401
from .ou import OUFitter  # noqa: F401
from .rates import HullWhiteCalibrator  # noqa: F401
from .rough import RoughHestonCalibrator  # noqa: F401
from .sabr import SABRCalibrator  # noqa: F401
