"""Data gap detection, prioritized backfill, cross-provider reconciliation.

Plain copy of ``pde_tpu/data/recovery.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference data/recovery.py: GapDetector over the trading
calendar (:113-390), the priority-queue BackfillManager (:391-750) and the
cross-provider DataReconciler (:751-880).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from datetime import date, datetime, timedelta
from typing import Dict, List, Optional, Tuple

import numpy as np

from .reference import TradingCalendar

__all__ = ["DataGap", "GapDetector", "BackfillTask", "BackfillManager", "DataReconciler"]


@dataclass
class DataGap:
    symbol: str
    start: date
    end: date

    @property
    def n_days(self) -> int:
        return (self.end - self.start).days + 1


class GapDetector:
    """Find missing trading days in stored history (recovery.py:113-390)."""

    def __init__(self, db, calendar: Optional[TradingCalendar] = None):
        self.db = db
        self.calendar = calendar or TradingCalendar()

    def detect(self, symbol: str, start: date, end: date) -> List[DataGap]:
        rows = self.db.query_market_prices(symbol, start=start.isoformat(), end=(end + timedelta(days=1)).isoformat())
        have = {datetime.fromisoformat(r["time"]).date() for r in rows}
        expected = self.calendar.trading_days_between(start, end)
        missing = sorted(d for d in expected if d not in have)
        gaps: List[DataGap] = []
        for d in missing:
            # join only CONSECUTIVE missing trading days (weekends/holidays
            # between them are fine) — a calendar-window join would fold a
            # present day into the gap and backfill would overwrite its
            # good row
            if gaps and not [
                t for t in self.calendar.trading_days_between(
                    gaps[-1].end + timedelta(days=1), d - timedelta(days=1)
                )
            ]:
                gaps[-1] = DataGap(symbol, gaps[-1].start, d)
            else:
                gaps.append(DataGap(symbol, d, d))
        return gaps

    def detect_all(self, symbols: List[str], start: date, end: date) -> Dict[str, List[DataGap]]:
        return {s: self.detect(s, start, end) for s in symbols}


@dataclass(order=True)
class BackfillTask:
    priority: int
    gap: DataGap = field(compare=False)
    attempts: int = field(default=0, compare=False)


class BackfillManager:
    """Priority-ordered gap filling (recovery.py:391-750): recent gaps first,
    bounded retries, per-task status."""

    def __init__(self, pipeline, max_attempts: int = 3):
        self.pipeline = pipeline  # DataIngestionPipeline
        self.max_attempts = max_attempts
        self._queue: List[BackfillTask] = []
        self.completed: List[DataGap] = []
        self.failed: List[Tuple[DataGap, str]] = []

    def enqueue(self, gaps: List[DataGap]) -> None:
        today = date.today()
        for gap in gaps:
            # recency priority: newer gaps fill first
            priority = (today - gap.end).days
            heapq.heappush(self._queue, BackfillTask(priority, gap))

    @property
    def pending(self) -> int:
        return len(self._queue)

    def run(self, max_tasks: Optional[int] = None) -> Dict[str, int]:
        done = 0
        while self._queue and (max_tasks is None or done < max_tasks):
            task = heapq.heappop(self._queue)
            gap = task.gap
            result = self.pipeline.ingest_symbol(gap.symbol, gap.start, gap.end)
            if result.status.value in ("success", "partial", "skipped"):
                self.completed.append(gap)
            else:
                task.attempts += 1
                if task.attempts < self.max_attempts:
                    heapq.heappush(self._queue, task)
                else:
                    self.failed.append((gap, "; ".join(result.errors)))
            done += 1
        return {"processed": done, "completed": len(self.completed), "failed": len(self.failed),
                "pending": self.pending}


class DataReconciler:
    """Cross-provider price reconciliation (recovery.py:751-880)."""

    def __init__(self, tolerance_pct: float = 0.005):
        self.tolerance_pct = tolerance_pct

    def reconcile(
        self,
        primary: Dict[date, float],
        secondary: Dict[date, float],
    ) -> Dict[str, object]:
        common = sorted(set(primary) & set(secondary))
        mismatches = []
        for d in common:
            a, b = primary[d], secondary[d]
            if a > 0 and abs(a - b) / a > self.tolerance_pct:
                mismatches.append({"date": d, "primary": a, "secondary": b,
                                   "diff_pct": abs(a - b) / a})
        return {
            "n_common": len(common),
            "n_only_primary": len(set(primary) - set(secondary)),
            "n_only_secondary": len(set(secondary) - set(primary)),
            "n_mismatches": len(mismatches),
            "mismatches": mismatches,
            "match_rate": 1.0 - len(mismatches) / len(common) if common else 1.0,
        }
