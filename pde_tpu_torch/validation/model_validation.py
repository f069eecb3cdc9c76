"""SR 11-7-style model validation framework.

Plain copy of ``pde_tpu/validation/model_validation.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference validation/model_validation.py: the check framework
(ValidationCheck / ThresholdCheck / ParameterBoundsCheck, :118-231),
ModelValidator with report aggregation (:232-309), and the per-model
validators with their built-in check sets — Heston incl. the Feller
condition check (:310-390), SABR (:391-422) and OU (:423-519).
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "ValidationStatus",
    "ValidationSeverity",
    "ValidationResult",
    "ValidationReport",
    "ValidationCheck",
    "ThresholdCheck",
    "ParameterBoundsCheck",
    "FellerConditionCheck",
    "ModelValidator",
    "HestonModelValidator",
    "SABRModelValidator",
    "OUModelValidator",
]


class ValidationStatus(str, enum.Enum):
    PASSED = "passed"
    FAILED = "failed"
    WARNING = "warning"
    SKIPPED = "skipped"


class ValidationSeverity(str, enum.Enum):
    INFO = "info"
    WARNING = "warning"
    ERROR = "error"
    CRITICAL = "critical"


@dataclass
class ValidationResult:
    check_name: str
    status: ValidationStatus
    severity: ValidationSeverity
    message: str
    details: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "check_name": self.check_name,
            "status": self.status.value,
            "severity": self.severity.value,
            "message": self.message,
            "details": self.details,
        }


@dataclass
class ValidationReport:
    model_name: str
    model_version: str
    results: List[ValidationResult] = field(default_factory=list)
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    @property
    def passed(self) -> bool:
        """Fails on any ERROR/CRITICAL failure (model_validation.py:79-87)."""
        return not any(
            r.status == ValidationStatus.FAILED
            and r.severity in (ValidationSeverity.ERROR, ValidationSeverity.CRITICAL)
            for r in self.results
        )

    @property
    def total_tests(self) -> int:
        return len(self.results)

    @property
    def passed_tests(self) -> int:
        return sum(r.status == ValidationStatus.PASSED for r in self.results)

    @property
    def failed_tests(self) -> int:
        return sum(r.status == ValidationStatus.FAILED for r in self.results)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "model_name": self.model_name,
            "model_version": self.model_version,
            "passed": self.passed,
            "total_tests": self.total_tests,
            "passed_tests": self.passed_tests,
            "failed_tests": self.failed_tests,
            "results": [r.to_dict() for r in self.results],
            "timestamp": self.timestamp.isoformat(),
        }


class ValidationCheck(abc.ABC):
    def __init__(self, name: str, severity: ValidationSeverity = ValidationSeverity.ERROR):
        self.name = name
        self.severity = severity

    @abc.abstractmethod
    def run(self, model: Any, data: Dict[str, Any]) -> ValidationResult:
        ...


class ThresholdCheck(ValidationCheck):
    """metric <=/>= threshold (model_validation.py:137-191)."""

    def __init__(
        self,
        name: str,
        metric_key: str,
        threshold: float,
        direction: str = "below",  # metric must be below/above threshold
        severity: ValidationSeverity = ValidationSeverity.ERROR,
    ):
        super().__init__(name, severity)
        self.metric_key = metric_key
        self.threshold = threshold
        self.direction = direction

    def run(self, model, data) -> ValidationResult:
        if self.metric_key not in data:
            return ValidationResult(
                self.name, ValidationStatus.SKIPPED, self.severity,
                f"metric '{self.metric_key}' not provided",
            )
        value = float(data[self.metric_key])
        ok = value <= self.threshold if self.direction == "below" else value >= self.threshold
        return ValidationResult(
            self.name,
            ValidationStatus.PASSED if ok else ValidationStatus.FAILED,
            self.severity,
            f"{self.metric_key}={value:.6g} {'<=' if self.direction == 'below' else '>='} "
            f"{self.threshold:.6g}: {'ok' if ok else 'violated'}",
            details={"value": value, "threshold": self.threshold},
        )


class ParameterBoundsCheck(ValidationCheck):
    """Every named parameter within [lo, hi] (model_validation.py:192-231)."""

    def __init__(self, bounds: Dict[str, tuple], severity=ValidationSeverity.ERROR):
        super().__init__("parameter_bounds", severity)
        self.bounds = bounds

    def run(self, model, data) -> ValidationResult:
        violations = []
        for name, (lo, hi) in self.bounds.items():
            value = data.get(name, getattr(model, name, None))
            if value is None:
                continue
            v = float(value)
            if not (lo <= v <= hi):
                violations.append(f"{name}={v:.6g} outside [{lo}, {hi}]")
        if violations:
            return ValidationResult(
                self.name, ValidationStatus.FAILED, self.severity, "; ".join(violations)
            )
        return ValidationResult(
            self.name, ValidationStatus.PASSED, self.severity, "all parameters in bounds"
        )


class FellerConditionCheck(ValidationCheck):
    """2 kappa theta >= sigma^2 (model_validation.py:355-390); WARNING
    severity — a violated Feller condition is suspicious, not fatal."""

    def __init__(self):
        super().__init__("feller_condition", ValidationSeverity.WARNING)

    def run(self, model, data) -> ValidationResult:
        get = lambda k: float(data.get(k, getattr(model, k, 0.0)))
        kappa, theta, sigma = get("kappa"), get("theta"), get("sigma")
        value = 2.0 * kappa * theta - sigma * sigma
        ok = value >= 0.0
        return ValidationResult(
            self.name,
            ValidationStatus.PASSED if ok else ValidationStatus.WARNING,
            self.severity,
            f"2*kappa*theta - sigma^2 = {value:.6g} ({'satisfied' if ok else 'violated'})",
            details={"feller_value": value},
        )


class ModelValidator:
    """Runs a registered check list and aggregates a report
    (model_validation.py:232-309)."""

    def __init__(self, model_name: str, model_version: str = "1.0"):
        self.model_name = model_name
        self.model_version = model_version
        self.checks: List[ValidationCheck] = []

    def add_check(self, check: ValidationCheck) -> None:
        self.checks.append(check)

    def add_threshold_check(self, name, metric_key, threshold, direction="below",
                            severity=ValidationSeverity.ERROR) -> None:
        self.add_check(ThresholdCheck(name, metric_key, threshold, direction, severity))

    def validate(self, model: Any = None, data: Optional[Dict[str, Any]] = None) -> ValidationReport:
        report = ValidationReport(self.model_name, self.model_version)
        data = data or {}
        for check in self.checks:
            try:
                report.results.append(check.run(model, data))
            except Exception as exc:  # noqa: BLE001 - checks are isolated
                report.results.append(
                    ValidationResult(
                        check.name, ValidationStatus.FAILED, check.severity,
                        f"check raised: {exc}",
                    )
                )
        return report


class HestonModelValidator(ModelValidator):
    """Built-in Heston checks (model_validation.py:310-354)."""

    def __init__(self, model_version: str = "1.0"):
        super().__init__("heston", model_version)
        self.add_check(FellerConditionCheck())
        self.add_check(
            ParameterBoundsCheck(
                {
                    "kappa": (0.01, 20.0),
                    "theta": (0.001, 2.0),
                    "sigma": (0.001, 3.0),
                    "rho": (-1.0, 1.0),
                    "v0": (0.001, 2.0),
                }
            )
        )
        self.add_threshold_check("calibration_rmse", "rmse", 0.5)
        self.add_threshold_check("fit_r_squared", "r_squared", 0.9, direction="above",
                                 severity=ValidationSeverity.WARNING)


class SABRModelValidator(ModelValidator):
    """Built-in SABR checks (model_validation.py:391-422)."""

    def __init__(self, model_version: str = "1.0"):
        super().__init__("sabr", model_version)
        self.add_check(
            ParameterBoundsCheck(
                {
                    "alpha": (1e-4, 5.0),
                    "beta": (0.0, 1.0),
                    "rho": (-1.0, 1.0),
                    "nu": (0.0, 5.0),
                }
            )
        )
        self.add_threshold_check("smile_rmse", "rmse", 0.05)


class OUModelValidator(ModelValidator):
    """Built-in OU checks (model_validation.py:423-519)."""

    def __init__(self, model_version: str = "1.0"):
        super().__init__("ou", model_version)
        self.add_check(
            ParameterBoundsCheck({"mu": (0.01, 100.0), "sigma": (1e-6, 100.0)})
        )
        self.add_threshold_check("half_life_days", "half_life_days", 250.0)
        self.add_threshold_check(
            "ljung_box_white_residuals", "ljung_box_p", 0.01, direction="above",
            severity=ValidationSeverity.WARNING,
        )
