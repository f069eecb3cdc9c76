"""Strategy validation: statistical tests and stress testing (the
reference's model validators, walk-forward splitters and benchmark
comparators are pure Python and are left out of the port)."""

from . import statistical_tests, stress_testing  # noqa: F401
from .statistical_tests import BootstrapAnalysis, OverfittingDetector, StrategyStatisticalTests  # noqa: F401
