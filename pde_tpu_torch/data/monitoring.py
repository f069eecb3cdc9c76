"""Data-quality monitoring: metrics, per-symbol/provider health, reports.

Plain copy of ``pde_tpu/data/monitoring.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference data/monitoring.py: quality metric records and alert
thresholds, per-symbol freshness/completeness trackers, per-provider error
trackers and the DataQualityMonitor facade with report generation
(:498-892).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional

__all__ = ["QualityLevel", "QualityMetric", "SymbolHealth", "ProviderHealth", "DataQualityMonitor"]


class QualityLevel(str, enum.Enum):
    GOOD = "good"
    DEGRADED = "degraded"
    BAD = "bad"


@dataclass
class QualityMetric:
    name: str
    value: float
    level: QualityLevel
    threshold: float
    message: str = ""
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))


@dataclass
class SymbolHealth:
    symbol: str
    last_update: Optional[datetime] = None
    n_records_today: int = 0
    completeness: float = 1.0
    n_validation_errors: int = 0
    level: QualityLevel = QualityLevel.GOOD


@dataclass
class ProviderHealth:
    provider: str
    n_requests: int = 0
    n_errors: int = 0
    avg_latency_ms: float = 0.0
    consecutive_errors: int = 0
    level: QualityLevel = QualityLevel.GOOD

    @property
    def error_rate(self) -> float:
        return self.n_errors / self.n_requests if self.n_requests else 0.0


class DataQualityMonitor:
    """Freshness / completeness / error-rate monitoring (monitoring.py:498-892)."""

    def __init__(
        self,
        staleness_warning: timedelta = timedelta(hours=24),
        staleness_critical: timedelta = timedelta(hours=72),
        max_error_rate: float = 0.05,
        min_completeness: float = 0.95,
    ):
        self.staleness_warning = staleness_warning
        self.staleness_critical = staleness_critical
        self.max_error_rate = max_error_rate
        self.min_completeness = min_completeness
        self.symbols: Dict[str, SymbolHealth] = {}
        self.providers: Dict[str, ProviderHealth] = {}

    # ------------------------------------------------------------- updates

    def record_update(self, symbol: str, n_records: int = 1,
                      n_validation_errors: int = 0,
                      time: Optional[datetime] = None) -> None:
        h = self.symbols.setdefault(symbol, SymbolHealth(symbol))
        now = time or datetime.now(timezone.utc)
        # "today" means today: reset the daily counter at the day boundary
        if h.last_update is not None and h.last_update.date() != now.date():
            h.n_records_today = 0
        h.last_update = now
        h.n_records_today += n_records
        h.n_validation_errors += n_validation_errors

    def record_completeness(self, symbol: str, completeness: float) -> None:
        self.symbols.setdefault(symbol, SymbolHealth(symbol)).completeness = completeness

    def record_request(self, provider: str, ok: bool, latency_ms: float = 0.0) -> None:
        p = self.providers.setdefault(provider, ProviderHealth(provider))
        p.n_requests += 1
        if ok:
            p.consecutive_errors = 0
        else:
            p.n_errors += 1
            p.consecutive_errors += 1
        # incremental mean
        p.avg_latency_ms += (latency_ms - p.avg_latency_ms) / p.n_requests

    # ------------------------------------------------------------- checks

    def check_symbol(self, symbol: str, now: Optional[datetime] = None) -> List[QualityMetric]:
        h = self.symbols.get(symbol)
        if h is None:
            return [QualityMetric("known_symbol", 0.0, QualityLevel.BAD, 1.0,
                                  f"{symbol} never updated")]
        now = now or datetime.now(timezone.utc)
        metrics = []
        if h.last_update is not None:
            age = now - h.last_update
            if age > self.staleness_critical:
                lvl = QualityLevel.BAD
            elif age > self.staleness_warning:
                lvl = QualityLevel.DEGRADED
            else:
                lvl = QualityLevel.GOOD
            metrics.append(
                QualityMetric("staleness_hours", age.total_seconds() / 3600, lvl,
                              self.staleness_warning.total_seconds() / 3600,
                              f"{symbol} last update {h.last_update.isoformat()}")
            )
        lvl = QualityLevel.GOOD if h.completeness >= self.min_completeness else QualityLevel.DEGRADED
        metrics.append(
            QualityMetric("completeness", h.completeness, lvl, self.min_completeness)
        )
        h.level = max((m.level for m in metrics), key=lambda l: list(QualityLevel).index(l))
        return metrics

    def check_provider(self, provider: str) -> List[QualityMetric]:
        p = self.providers.get(provider)
        if p is None:
            return []
        lvl = QualityLevel.GOOD
        if p.error_rate > self.max_error_rate:
            lvl = QualityLevel.DEGRADED
        if p.consecutive_errors >= 5:
            lvl = QualityLevel.BAD
        p.level = lvl
        return [
            QualityMetric("error_rate", p.error_rate, lvl, self.max_error_rate,
                          f"{provider}: {p.n_errors}/{p.n_requests} errors"),
            QualityMetric("avg_latency_ms", p.avg_latency_ms, QualityLevel.GOOD, 0.0),
        ]

    # ------------------------------------------------------------- report

    def report(self) -> Dict:
        symbol_status = {s: self.check_symbol(s) for s in self.symbols}
        provider_status = {p: self.check_provider(p) for p in self.providers}
        worst = QualityLevel.GOOD
        for metrics in list(symbol_status.values()) + list(provider_status.values()):
            for m in metrics:
                if list(QualityLevel).index(m.level) > list(QualityLevel).index(worst):
                    worst = m.level
        return {
            "overall": worst.value,
            "n_symbols": len(self.symbols),
            "n_providers": len(self.providers),
            "symbols": {
                s: {"level": self.symbols[s].level.value,
                    "metrics": [m.__dict__ for m in ms]}
                for s, ms in symbol_status.items()
            },
            "providers": {
                p: {"level": self.providers[p].level.value,
                    "metrics": [m.__dict__ for m in ms]}
                for p, ms in provider_status.items()
            },
        }
