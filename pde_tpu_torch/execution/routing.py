"""Smart order routing: venue scoring and route selection.

Plain copy of ``pde_tpu/execution/routing.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference execution/routing.py: the Venue model (:31-120),
fee/liquidity/latency scoring (:121-314) and the SmartOrderRouter with
best-venue / split / spray strategies (:315-759).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .order import Order

__all__ = ["VenueType", "Venue", "RoutingStrategy", "RouteDecision", "SmartOrderRouter"]


class VenueType(str, enum.Enum):
    EXCHANGE = "exchange"
    DARK_POOL = "dark_pool"
    MARKET_MAKER = "market_maker"
    ECN = "ecn"


@dataclass
class Venue:
    """Execution venue profile (routing.py:31-120)."""

    name: str
    venue_type: VenueType
    fee_per_share: float = 0.003  # negative = rebate
    avg_latency_ms: float = 1.0
    fill_probability: float = 0.95
    avg_liquidity: float = 1e6  # shares typically available
    supports_hidden: bool = False
    active: bool = True


class RoutingStrategy(str, enum.Enum):
    BEST_VENUE = "best_venue"
    SPLIT = "split"
    SPRAY = "spray"


@dataclass
class RouteDecision:
    order_id: str
    allocations: List[Tuple[str, float]]  # (venue_name, quantity)
    strategy: RoutingStrategy
    expected_cost: float
    rationale: str = ""


DEFAULT_VENUES = [
    Venue("NYSE", VenueType.EXCHANGE, fee_per_share=0.0030, avg_latency_ms=0.8,
          fill_probability=0.98, avg_liquidity=5e6),
    Venue("NASDAQ", VenueType.EXCHANGE, fee_per_share=0.0030, avg_latency_ms=0.7,
          fill_probability=0.98, avg_liquidity=5e6),
    Venue("IEX", VenueType.EXCHANGE, fee_per_share=0.0009, avg_latency_ms=1.2,
          fill_probability=0.90, avg_liquidity=1e6),
    Venue("DARK1", VenueType.DARK_POOL, fee_per_share=0.0010, avg_latency_ms=2.0,
          fill_probability=0.60, avg_liquidity=2e6, supports_hidden=True),
    Venue("MM1", VenueType.MARKET_MAKER, fee_per_share=-0.0010, avg_latency_ms=0.5,
          fill_probability=0.99, avg_liquidity=5e5),
]


class SmartOrderRouter:
    """Scores venues and allocates quantity (routing.py:315-759).

    score = w_fee * fee_score + w_liq * liquidity_score + w_lat * latency_score
            + w_fill * fill_probability     (higher is better)
    """

    def __init__(
        self,
        venues: Optional[List[Venue]] = None,
        fee_weight: float = 0.35,
        liquidity_weight: float = 0.30,
        latency_weight: float = 0.15,
        fill_weight: float = 0.20,
    ):
        self.venues: Dict[str, Venue] = {v.name: v for v in (venues or DEFAULT_VENUES)}
        self.weights = (fee_weight, liquidity_weight, latency_weight, fill_weight)

    def add_venue(self, venue: Venue) -> None:
        self.venues[venue.name] = venue

    def score_venues(self, order: Order) -> Dict[str, float]:
        active = [v for v in self.venues.values() if v.active]
        if not active:
            return {}
        fees = np.array([v.fee_per_share for v in active])
        liq = np.array([v.avg_liquidity for v in active])
        lat = np.array([v.avg_latency_ms for v in active])
        fill = np.array([v.fill_probability for v in active])

        def norm(x, invert=False):
            lo, hi = x.min(), x.max()
            if hi - lo < 1e-12:
                return np.ones_like(x)
            n = (x - lo) / (hi - lo)
            return 1.0 - n if invert else n

        w_fee, w_liq, w_lat, w_fill = self.weights
        scores = (
            w_fee * norm(fees, invert=True)
            + w_liq * norm(np.minimum(liq, order.quantity * 10))
            + w_lat * norm(lat, invert=True)
            + w_fill * fill
        )
        return {v.name: float(s) for v, s in zip(active, scores)}

    def route(self, order: Order, strategy: RoutingStrategy = RoutingStrategy.BEST_VENUE) -> RouteDecision:
        scores = self.score_venues(order)
        if not scores:
            raise RuntimeError("no active venues")
        ranked = sorted(scores.items(), key=lambda kv: kv[1], reverse=True)

        if strategy == RoutingStrategy.BEST_VENUE:
            name = ranked[0][0]
            allocations = [(name, order.quantity)]
            rationale = f"best venue {name} (score {ranked[0][1]:.3f})"
        elif strategy == RoutingStrategy.SPLIT:
            # top venues up to their liquidity, score-weighted
            top = ranked[:3]
            weights = np.array([s for _, s in top])
            weights = weights / weights.sum()
            allocations = [(n, float(order.quantity * w)) for (n, _), w in zip(top, weights)]
            rationale = f"split across {[n for n, _ in top]}"
        else:  # SPRAY
            active = [n for n in scores]
            q = order.quantity / len(active)
            allocations = [(n, q) for n in active]
            rationale = f"sprayed across {len(active)} venues"

        expected_cost = sum(
            self.venues[n].fee_per_share * q for n, q in allocations
        )
        return RouteDecision(
            order_id=order.order_id,
            allocations=allocations,
            strategy=strategy,
            expected_cost=expected_cost,
            rationale=rationale,
        )

    def record_fill_quality(self, venue_name: str, filled: bool, latency_ms: float) -> None:
        """EWMA update of venue statistics from realized fills
        (routing.py adaptive feedback)."""
        v = self.venues.get(venue_name)
        if v is None:
            return
        alpha = 0.05
        v.fill_probability = (1 - alpha) * v.fill_probability + alpha * (1.0 if filled else 0.0)
        v.avg_latency_ms = (1 - alpha) * v.avg_latency_ms + alpha * latency_ms
