"""Transaction-cost analysis: benchmarks, implementation shortfall, reports.

Plain copy of ``pde_tpu/execution/tca.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference execution/tca.py: per-order TCA vs arrival / interval
VWAP / interval TWAP / close benchmarks, implementation shortfall (Perold),
and aggregated report generation (:61-644).  Benchmark computations are
vectorized over the fill/market arrays.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np

from .order import Fill, OrderSide

__all__ = ["TCABenchmark", "TCAResult", "TCAAnalyzer"]


class TCABenchmark(str, enum.Enum):
    ARRIVAL = "arrival"
    VWAP = "vwap"
    TWAP = "twap"
    CLOSE = "close"


@dataclass
class TCAResult:
    """Per-order cost decomposition (tca.py:61-140)."""

    order_id: str
    symbol: str
    side: str
    total_quantity: float
    avg_fill_price: float
    arrival_price: float
    benchmark_prices: Dict[str, float]
    slippage_bps: Dict[str, float]
    implementation_shortfall_bps: float
    explicit_costs: float
    explicit_costs_bps: float
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    def to_dict(self) -> Dict:
        d = dict(self.__dict__)
        d["timestamp"] = self.timestamp.isoformat()
        return d


class TCAAnalyzer:
    """Computes slippage vs benchmarks for executed orders (tca.py:205-644)."""

    def analyze_order(
        self,
        fills: List[Fill],
        arrival_price: float,
        market_prices: Optional[np.ndarray] = None,
        market_volumes: Optional[np.ndarray] = None,
        close_price: Optional[float] = None,
    ) -> TCAResult:
        if not fills:
            raise ValueError("no fills to analyze")
        qty = np.array([f.quantity for f in fills])
        px = np.array([f.price for f in fills])
        total_q = float(qty.sum())
        avg_px = float((qty * px).sum() / total_q)
        side = fills[0].side
        sign = 1.0 if side.is_buy else -1.0

        benchmarks: Dict[str, float] = {TCABenchmark.ARRIVAL.value: arrival_price}
        if market_prices is not None:
            mp = np.asarray(market_prices, dtype=np.float64)
            benchmarks[TCABenchmark.TWAP.value] = float(mp.mean())
            if market_volumes is not None:
                mv = np.asarray(market_volumes, dtype=np.float64)
                benchmarks[TCABenchmark.VWAP.value] = float((mp * mv).sum() / mv.sum())
        if close_price is not None:
            benchmarks[TCABenchmark.CLOSE.value] = close_price

        # slippage: positive = cost (paid more buying / received less selling)
        slippage = {
            name: sign * (avg_px - bench) / bench * 1e4 if bench > 0 else 0.0
            for name, bench in benchmarks.items()
        }

        explicit = float(sum(f.total_cost for f in fills))
        notional = total_q * avg_px
        explicit_bps = explicit / notional * 1e4 if notional > 0 else 0.0

        # Perold implementation shortfall vs arrival, incl. explicit costs
        is_bps = slippage[TCABenchmark.ARRIVAL.value] + explicit_bps

        return TCAResult(
            order_id=fills[0].order_id,
            symbol=fills[0].symbol,
            side=side.value,
            total_quantity=total_q,
            avg_fill_price=avg_px,
            arrival_price=arrival_price,
            benchmark_prices=benchmarks,
            slippage_bps=slippage,
            implementation_shortfall_bps=float(is_bps),
            explicit_costs=explicit,
            explicit_costs_bps=float(explicit_bps),
        )

    def aggregate_report(self, results: List[TCAResult]) -> Dict:
        """Cross-order summary (tca.py report generation)."""
        if not results:
            return {"n_orders": 0}
        is_bps = np.array([r.implementation_shortfall_bps for r in results])
        notional = np.array([r.total_quantity * r.avg_fill_price for r in results])
        weights = notional / notional.sum()
        arr = np.array([r.slippage_bps.get("arrival", 0.0) for r in results])
        return {
            "n_orders": len(results),
            "total_notional": float(notional.sum()),
            "avg_is_bps": float(is_bps.mean()),
            "notional_weighted_is_bps": float((is_bps * weights).sum()),
            "avg_arrival_slippage_bps": float(arr.mean()),
            "worst_order": max(results, key=lambda r: r.implementation_shortfall_bps).order_id,
            "total_explicit_costs": float(sum(r.explicit_costs for r in results)),
        }
