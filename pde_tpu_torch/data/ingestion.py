"""Batch data ingestion: provider -> validate -> store.

Plain copy of ``pde_tpu/data/ingestion.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference data/ingestion.py: the DataIngestionPipeline
(provider fetch, validation gate, DB persistence, per-symbol status/result
tracking; :110-562) and IncrementalIngestion (resume from the last stored
bar; :563-680).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from datetime import date, datetime, timedelta, timezone
from typing import Dict, List, Optional

import numpy as np

from .providers import DataProvider
from .validation import ValidationLevel, MarketDataValidator

__all__ = ["IngestionStatus", "IngestionResult", "DataIngestionPipeline", "IncrementalIngestion"]


class IngestionStatus(str, enum.Enum):
    SUCCESS = "success"
    PARTIAL = "partial"
    FAILED = "failed"
    SKIPPED = "skipped"


@dataclass
class IngestionResult:
    symbol: str
    status: IngestionStatus
    n_fetched: int = 0
    n_stored: int = 0
    n_rejected: int = 0
    errors: List[str] = field(default_factory=list)
    elapsed_s: float = 0.0


class DataIngestionPipeline:
    """provider -> validate -> store (ingestion.py:110-562)."""

    def __init__(
        self,
        provider: DataProvider,
        db,
        validator: Optional[MarketDataValidator] = None,
        reject_on_error: bool = True,
    ):
        self.provider = provider
        self.db = db
        self.validator = validator or MarketDataValidator()
        self.reject_on_error = reject_on_error

    def ingest_symbol(self, symbol: str, start: date, end: date) -> IngestionResult:
        from ..monitoring import metrics as _mt

        t0 = time.time()
        try:
            bars = self.provider.get_bars(symbol, start, end)
        except Exception as exc:  # noqa: BLE001 - per-symbol isolation
            _mt.provider_requests.labels(
                provider=self.provider.name, status="error").inc()
            return IngestionResult(
                symbol, IngestionStatus.FAILED, errors=[str(exc)], elapsed_s=time.time() - t0
            )
        # per-provider fetch breakdowns (reference metrics.py:389-417)
        _mt.provider_latency.labels(
            provider=self.provider.name).observe(time.time() - t0)
        _mt.provider_requests.labels(
            provider=self.provider.name, status="ok").inc()
        if not bars:
            return IngestionResult(symbol, IngestionStatus.SKIPPED, elapsed_s=time.time() - t0)

        frame = {
            "time": [b.time for b in bars],
            "open": np.array([b.open for b in bars]),
            "high": np.array([b.high for b in bars]),
            "low": np.array([b.low for b in bars]),
            "close": np.array([b.close for b in bars]),
            "volume": np.array([b.volume for b in bars]),
        }
        # staleness is judged against the REQUESTED window end, not wall
        # clock — a historical backfill is not "stale"
        as_of = datetime.combine(end, datetime.min.time(), tzinfo=timezone.utc)
        report = self.validator.validate(frame, as_of=as_of)
        # per-provider data-quality exporters (reference metrics.py:389-417)
        for issue in report.issues:
            _mt.data_validation_failures.labels(
                provider=self.provider.name, check=issue.check).inc()
        if report.n_records:
            _mt.data_completeness_percent.labels(
                symbol=symbol, provider=self.provider.name
            ).set(100.0 * (report.n_records - report.n_flagged)
                  / report.n_records)
        if not report.passed and self.reject_on_error:
            return IngestionResult(
                symbol,
                IngestionStatus.FAILED,
                n_fetched=len(bars),
                n_rejected=len(bars),
                errors=[i.message for i in report.errors],
                elapsed_s=time.time() - t0,
            )

        # only ERROR-severity rows are dropped; WARNING flags (outlier
        # jumps, volume floors) describe legitimate data — deleting a real
        # crash day would leave a permanent gap that backfill re-fetches
        # and re-drops forever
        flagged = {
            i for issue in report.issues
            if issue.level == ValidationLevel.ERROR
            for i in issue.indices
        }
        rows = [
            {
                "time": b.time, "symbol": symbol, "open": b.open, "high": b.high,
                "low": b.low, "close": b.close, "volume": b.volume,
            }
            for i, b in enumerate(bars)
            if i not in flagged
        ]
        self.db.insert_market_prices(rows)
        status = IngestionStatus.SUCCESS if len(rows) == len(bars) else IngestionStatus.PARTIAL
        return IngestionResult(
            symbol, status,
            n_fetched=len(bars), n_stored=len(rows), n_rejected=len(bars) - len(rows),
            errors=[i.message for i in report.issues],
            elapsed_s=time.time() - t0,
        )

    def ingest(self, symbols: List[str], start: date, end: date) -> Dict[str, IngestionResult]:
        return {s: self.ingest_symbol(s, start, end) for s in symbols}


class IncrementalIngestion:
    """Resume each symbol from its last stored bar (ingestion.py:563-680)."""

    def __init__(self, pipeline: DataIngestionPipeline):
        self.pipeline = pipeline

    def last_stored_date(self, symbol: str) -> Optional[date]:
        rows = self.pipeline.db.query_market_prices(symbol)
        if not rows:
            return None
        last = rows[-1]["time"]
        return datetime.fromisoformat(last).date()

    def ingest(self, symbols: List[str], end: Optional[date] = None,
               default_lookback_days: int = 365) -> Dict[str, IngestionResult]:
        end = end or date.today()
        out = {}
        for s in symbols:
            last = self.last_stored_date(s)
            start = (last + timedelta(days=1)) if last else (end - timedelta(days=default_lookback_days))
            if start > end:
                out[s] = IngestionResult(s, IngestionStatus.SKIPPED)
                continue
            out[s] = self.pipeline.ingest_symbol(s, start, end)
        return out
