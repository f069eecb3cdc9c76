"""Portfolio Greeks aggregation and re-hedge recommendations.

Plain copy of ``pde_tpu/risk/greeks_monitor.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference risk/greeks_monitor.py: OptionPosition /
PortfolioGreeks / HedgeAction dataclasses (:43-139), threshold-based delta /
gamma / vega / theta checks with urgency escalation at 2x/3x the threshold
(:270-455), delta-hedge trade computation (:456-504) and a Greeks summary
(:505-549).  Aggregation across a large book is one vectorized pass.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "HedgeActionType",
    "OptionPosition",
    "PortfolioGreeks",
    "HedgeAction",
    "GreeksMonitorConfig",
    "GreeksRiskMonitor",
]


class HedgeActionType(str, enum.Enum):
    HEDGE_DELTA = "hedge_delta"
    REDUCE_GAMMA = "reduce_gamma"
    REDUCE_VEGA = "reduce_vega"
    ALERT = "alert"
    NO_ACTION = "no_action"


@dataclass
class OptionPosition:
    symbol: str
    underlying: str
    option_type: str
    strike: float
    expiration: datetime
    quantity: int
    direction: str
    delta: float
    gamma: float
    vega: float
    theta: float
    rho: float = 0.0
    implied_vol: float = 0.0
    underlying_price: float = 0.0
    market_value: float = 0.0


@dataclass
class PortfolioGreeks:
    delta: float
    gamma: float
    vega: float
    theta: float
    delta_dollars: float = 0.0
    gamma_dollars: float = 0.0
    vega_dollars: float = 0.0
    delta_by_underlying: Dict[str, float] = field(default_factory=dict)
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    def to_dict(self) -> Dict:
        d = self.__dict__.copy()
        d["timestamp"] = self.timestamp.isoformat()
        return d


@dataclass
class HedgeAction:
    action_type: HedgeActionType
    underlying: Optional[str] = None
    quantity: float = 0.0
    rationale: str = ""
    urgency: str = "normal"
    estimated_cost: float = 0.0


@dataclass
class GreeksMonitorConfig:
    """Thresholds match greeks_monitor.py:141-162."""

    delta_threshold: float = 100.0
    delta_dollars_threshold: float = 50_000.0
    gamma_threshold: float = 50.0
    gamma_dollars_threshold: float = 10_000.0
    vega_threshold: float = 1000.0
    max_vega_dollars: float = 25_000.0
    max_daily_theta_loss: float = 5_000.0
    hedge_delta_threshold_pct: float = 0.02
    min_hedge_size: float = 100.0


class GreeksRiskMonitor:
    """Aggregates position Greeks and emits hedge recommendations."""

    def __init__(self, config: Optional[GreeksMonitorConfig] = None):
        self.config = config or GreeksMonitorConfig()

    def compute_portfolio_greeks(self, positions: List[OptionPosition]) -> PortfolioGreeks:
        """Contract-multiplied aggregation (greeks_monitor.py:204-268):
        position Greeks = per-contract Greeks * quantity * 100."""
        if not positions:
            return PortfolioGreeks(0.0, 0.0, 0.0, 0.0)

        qty = np.array([p.quantity * 100.0 for p in positions])
        delta = np.array([p.delta for p in positions]) * qty
        gamma = np.array([p.gamma for p in positions]) * qty
        vega = np.array([p.vega for p in positions]) * qty
        theta = np.array([p.theta for p in positions]) * qty
        px = np.array([p.underlying_price for p in positions])

        by_underlying: Dict[str, float] = {}
        for p, d in zip(positions, delta):
            by_underlying[p.underlying] = by_underlying.get(p.underlying, 0.0) + float(d)

        return PortfolioGreeks(
            delta=float(delta.sum()),
            gamma=float(gamma.sum()),
            vega=float(vega.sum()),
            theta=float(theta.sum()),
            delta_dollars=float((delta * px).sum()),
            gamma_dollars=float((gamma * px * px).sum() / 100.0),
            vega_dollars=float(vega.sum()),
            delta_by_underlying=by_underlying,
        )

    def check_rehedge_needed(
        self, portfolio_greeks: PortfolioGreeks, portfolio_value: float = 1_000_000
    ) -> Tuple[bool, List[HedgeAction]]:
        actions: List[HedgeAction] = []
        actions += self._check_delta(portfolio_greeks, portfolio_value)
        actions += self._check_gamma(portfolio_greeks)
        actions += self._check_vega(portfolio_greeks)
        actions += self._check_theta(portfolio_greeks)
        return bool(actions), actions

    def compute_hedge_trade(
        self, greeks: PortfolioGreeks, underlying: Optional[str] = None
    ) -> Optional[HedgeAction]:
        """Shares of underlying to neutralize delta (greeks_monitor.py:456-504)."""
        delta = (
            greeks.delta_by_underlying.get(underlying, 0.0) if underlying else greeks.delta
        )
        qty = -delta
        if abs(qty) < self.config.min_hedge_size:
            return None
        return HedgeAction(
            action_type=HedgeActionType.HEDGE_DELTA,
            underlying=underlying,
            quantity=qty,
            rationale=f"Trade {qty:+.0f} shares to neutralize delta {delta:.0f}",
        )

    def summarize_greeks(self, greeks: PortfolioGreeks) -> str:
        return (
            f"Greeks: delta={greeks.delta:.0f} (${greeks.delta_dollars:,.0f}), "
            f"gamma={greeks.gamma:.2f}, vega={greeks.vega:.0f}, "
            f"theta={greeks.theta:,.0f}/day"
        )

    # ------------------------------------------------------------ internals

    def _urgency(self, value: float, threshold: float) -> str:
        if abs(value) > threshold * 3:
            return "critical"
        if abs(value) > threshold * 2:
            return "high"
        return "normal"

    def _check_delta(self, g: PortfolioGreeks, portfolio_value: float) -> List[HedgeAction]:
        actions = []
        if abs(g.delta) > self.config.delta_threshold:
            actions.append(
                HedgeAction(
                    action_type=HedgeActionType.HEDGE_DELTA,
                    quantity=-g.delta,
                    rationale=(
                        f"Portfolio delta {g.delta:.0f} exceeds threshold "
                        f"{self.config.delta_threshold:.0f}"
                    ),
                    urgency=self._urgency(g.delta, self.config.delta_threshold),
                )
            )
        delta_pct = abs(g.delta_dollars) / portfolio_value if portfolio_value > 0 else 0.0
        if not actions and (
            delta_pct > self.config.hedge_delta_threshold_pct
            or abs(g.delta_dollars) > self.config.delta_dollars_threshold
        ):
            actions.append(
                HedgeAction(
                    action_type=HedgeActionType.HEDGE_DELTA,
                    quantity=-g.delta,
                    rationale=(
                        f"Dollar delta {g.delta_dollars:,.0f} is {delta_pct:.1%} of portfolio"
                    ),
                    urgency=self._urgency(
                        g.delta_dollars, self.config.delta_dollars_threshold
                    ),
                )
            )
        for underlying, d in g.delta_by_underlying.items():
            if abs(d) > self.config.delta_threshold:
                actions.append(
                    HedgeAction(
                        action_type=HedgeActionType.HEDGE_DELTA,
                        underlying=underlying,
                        quantity=-d,
                        rationale=f"{underlying} delta {d:.0f} exceeds threshold",
                    )
                )
        return actions

    def _check_gamma(self, g: PortfolioGreeks) -> List[HedgeAction]:
        # unit-gamma OR dollar-gamma (per 1% move) over its threshold
        if (abs(g.gamma) <= self.config.gamma_threshold
                and abs(g.gamma_dollars) <= self.config.gamma_dollars_threshold):
            return []
        over_d = abs(g.gamma_dollars) > self.config.gamma_dollars_threshold
        return [
            HedgeAction(
                action_type=HedgeActionType.ALERT,
                rationale=(
                    f"High gamma exposure: {g.gamma:.2f} "
                    f"(${g.gamma_dollars:,.0f}/1%), monitor for large "
                    "underlying moves"
                ),
                urgency=self._urgency(
                    g.gamma_dollars if over_d else g.gamma,
                    self.config.gamma_dollars_threshold if over_d
                    else self.config.gamma_threshold,
                ),
            )
        ]

    def _check_vega(self, g: PortfolioGreeks) -> List[HedgeAction]:
        # unit-vega OR dollar-vega over its cap
        if (abs(g.vega) <= self.config.vega_threshold
                and abs(g.vega_dollars) <= self.config.max_vega_dollars):
            return []
        over_d = abs(g.vega_dollars) > self.config.max_vega_dollars
        return [
            HedgeAction(
                action_type=HedgeActionType.REDUCE_VEGA,
                rationale=(
                    f"Vega exposure {g.vega:.0f} (${g.vega_dollars:,.0f}/vol-pt) "
                    f"exceeds threshold "
                    f"{self.config.max_vega_dollars if over_d else self.config.vega_threshold:,.0f}"
                ),
                urgency=self._urgency(
                    g.vega_dollars if over_d else g.vega,
                    self.config.max_vega_dollars if over_d
                    else self.config.vega_threshold,
                ),
            )
        ]

    def _check_theta(self, g: PortfolioGreeks) -> List[HedgeAction]:
        if g.theta >= -self.config.max_daily_theta_loss:
            return []
        return [
            HedgeAction(
                action_type=HedgeActionType.ALERT,
                rationale=(
                    f"Daily theta decay {g.theta:,.0f} exceeds limit "
                    f"-{self.config.max_daily_theta_loss:,.0f}"
                ),
                urgency="high",
            )
        ]
