"""Fill/position reconciliation against the broker + audit trail.

Plain copy of ``pde_tpu/execution/reconciliation.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference execution/reconciliation.py: the FillReconciler
matching internal fills to broker records with severity-graded discrepancies
(:181-529) and the append-only AuditTrail (:530-678).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional

from .order import Fill

__all__ = ["DiscrepancySeverity", "Discrepancy", "ReconciliationReport", "FillReconciler", "AuditTrail"]


class DiscrepancySeverity(str, enum.Enum):
    INFO = "info"
    WARNING = "warning"
    CRITICAL = "critical"


@dataclass
class Discrepancy:
    kind: str
    severity: DiscrepancySeverity
    message: str
    internal: Optional[Dict] = None
    external: Optional[Dict] = None


@dataclass
class ReconciliationReport:
    n_internal: int
    n_external: int
    n_matched: int
    discrepancies: List[Discrepancy] = field(default_factory=list)
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    @property
    def clean(self) -> bool:
        return not any(
            d.severity in (DiscrepancySeverity.WARNING, DiscrepancySeverity.CRITICAL)
            for d in self.discrepancies
        )


class FillReconciler:
    """Match internal fills to broker fills (reconciliation.py:181-529)."""

    def __init__(self, price_tolerance_pct: float = 0.001, quantity_tolerance: float = 1e-6):
        self.price_tolerance_pct = price_tolerance_pct
        self.quantity_tolerance = quantity_tolerance

    def reconcile_fills(self, internal: List[Fill], external: List[Dict]) -> ReconciliationReport:
        """external rows: {order_id, symbol, quantity, price, ...}."""
        ext_by_order: Dict[str, List[Dict]] = {}
        for row in external:
            ext_by_order.setdefault(str(row["order_id"]), []).append(row)

        discrepancies: List[Discrepancy] = []
        matched = 0
        seen_orders = set()

        consumed: set = set()  # id() of matched external rows: one-to-one
        for fill in internal:
            seen_orders.add(fill.order_id)
            candidates = ext_by_order.get(fill.order_id, [])
            match = next(
                (
                    c for c in candidates
                    if id(c) not in consumed
                    and abs(c["quantity"] - fill.quantity) <= self.quantity_tolerance
                ),
                None,
            )
            if match is None:
                discrepancies.append(
                    Discrepancy(
                        "missing_external", DiscrepancySeverity.CRITICAL,
                        f"internal fill {fill.fill_id} ({fill.symbol} {fill.quantity}) "
                        f"not found at broker",
                        internal=fill.to_dict(),
                    )
                )
                continue
            consumed.add(id(match))
            matched += 1
            if fill.price > 0 and abs(match["price"] - fill.price) / fill.price > self.price_tolerance_pct:
                discrepancies.append(
                    Discrepancy(
                        "price_mismatch", DiscrepancySeverity.WARNING,
                        f"{fill.symbol}: internal {fill.price} vs broker {match['price']}",
                        internal=fill.to_dict(), external=match,
                    )
                )

        internal_orders = {f.order_id for f in internal}
        for order_id, rows in ext_by_order.items():
            if order_id not in internal_orders:
                discrepancies.append(
                    Discrepancy(
                        "unknown_external", DiscrepancySeverity.CRITICAL,
                        f"broker reports fills for unknown order {order_id}",
                        external=rows[0],
                    )
                )
                continue
            for row in rows:
                if id(row) not in consumed:
                    discrepancies.append(
                        Discrepancy(
                            "extra_external", DiscrepancySeverity.CRITICAL,
                            f"broker reports an unmatched extra fill for "
                            f"order {order_id}",
                            external=row,
                        )
                    )

        return ReconciliationReport(
            n_internal=len(internal),
            n_external=len(external),
            n_matched=matched,
            discrepancies=discrepancies,
        )

    def reconcile_positions(self, internal: Dict[str, float], external: Dict[str, float]) -> ReconciliationReport:
        discrepancies = []
        matched = 0
        for symbol in sorted(set(internal) | set(external)):
            a = internal.get(symbol, 0.0)
            b = external.get(symbol, 0.0)
            if abs(a - b) <= self.quantity_tolerance:
                matched += 1
            else:
                sev = (
                    DiscrepancySeverity.CRITICAL
                    if (a == 0) != (b == 0) or (a > 0) != (b > 0)
                    else DiscrepancySeverity.WARNING
                )
                discrepancies.append(
                    Discrepancy(
                        "position_mismatch", sev,
                        f"{symbol}: internal {a} vs broker {b}",
                        internal={"quantity": a}, external={"quantity": b},
                    )
                )
        return ReconciliationReport(
            n_internal=len(internal), n_external=len(external),
            n_matched=matched, discrepancies=discrepancies,
        )


class AuditTrail:
    """Append-only JSONL audit log (reconciliation.py:530-678)."""

    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        self._records: List[Dict[str, Any]] = []

    def record(self, event_type: str, **payload) -> Dict[str, Any]:
        row = {
            "time": datetime.now(timezone.utc).isoformat(),
            "event_type": event_type,
            "seq": len(self._records),
            **payload,
        }
        self._records.append(row)
        if self.path:
            with self.path.open("a") as f:
                f.write(json.dumps(row, default=str) + "\n")
        return row

    def query(self, event_type: Optional[str] = None) -> List[Dict[str, Any]]:
        if event_type is None:
            return list(self._records)
        return [r for r in self._records if r["event_type"] == event_type]

    def __len__(self) -> int:
        return len(self._records)
