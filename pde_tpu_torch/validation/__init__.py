"""Model and strategy validation: SR 11-7 checks, statistical tests,
walk-forward, stress testing, benchmarks."""

from . import benchmarks, model_validation, statistical_tests, stress_testing, walk_forward  # noqa: F401
from .model_validation import HestonModelValidator, OUModelValidator, SABRModelValidator  # noqa: F401
from .statistical_tests import BootstrapAnalysis, OverfittingDetector, StrategyStatisticalTests  # noqa: F401
