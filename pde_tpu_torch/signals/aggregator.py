"""Signal aggregation: per-asset confidence-weighted voting.

Plain copy of ``pde_tpu/signals/aggregator.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.

Mirrors the reference SignalAggregator (signals/aggregator.py): signals from
all strategies are normalized (:183-220), grouped by asset (:241), and
resolved by weighted voting with a 1.5x consensus-dominance ratio (:285-383);
exit signals from position management take priority (:316-325); position-size
suggestion scales confidence into the per-position cap (:409-421) and a risk
budget filter truncates the book (:423-463).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional

from .mean_reversion import MeanReversionSignal, MeanRevSignalType
from .vol_arbitrage import SignalType, VolArbitrageSignal

__all__ = ["AggregatedSignalType", "AggregatedSignal", "AggregatorConfig", "SignalAggregator"]


class AggregatedSignalType(str, enum.Enum):
    BUY = "buy"
    SELL = "sell"
    ENTRY_LONG = "entry_long"
    ENTRY_SHORT = "entry_short"
    EXIT = "exit"
    NO_ACTION = "no_action"


@dataclass
class AggregatedSignal:
    """Final per-asset decision (mirrors aggregator.py:40-70)."""

    asset: str
    signal_type: AggregatedSignalType
    confidence: float
    supporting_strategies: List[str]
    conflicting_strategies: List[str]
    rationale: str
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    component_signals: List[Dict] = field(default_factory=list)
    suggested_position_size: Optional[float] = None
    max_position_pct: Optional[float] = None

    def to_dict(self) -> Dict:
        return {
            "asset": self.asset,
            "signal_type": self.signal_type.value,
            "confidence": self.confidence,
            "supporting_strategies": self.supporting_strategies,
            "conflicting_strategies": self.conflicting_strategies,
            "rationale": self.rationale,
            "timestamp": self.timestamp.isoformat(),
            "component_signals": self.component_signals,
            "suggested_position_size": self.suggested_position_size,
            "max_position_pct": self.max_position_pct,
        }


@dataclass
class AggregatorConfig:
    """Defaults match aggregator.py:73-95."""

    consensus_ratio: float = 1.5
    min_confidence_threshold: float = 0.6
    strategy_weights: Dict[str, float] = field(
        default_factory=lambda: {"vol_arbitrage": 1.0, "mean_reversion": 1.0}
    )
    max_single_position_pct: float = 0.10
    max_strategy_allocation_pct: float = 0.30
    require_unanimous: bool = False


class SignalAggregator:
    """Combines strategy signals into unified portfolio decisions."""

    def __init__(self, config: Optional[AggregatorConfig] = None):
        self.config = config or AggregatorConfig()

    # ------------------------------------------------------------------ API

    def aggregate(
        self,
        vol_arbitrage_signals: Optional[List[VolArbitrageSignal]] = None,
        mean_reversion_signals: Optional[List[MeanReversionSignal]] = None,
        portfolio_value: float = 1_000_000,
        current_positions: Optional[Dict[str, Dict]] = None,
    ) -> List[AggregatedSignal]:
        normalized = self._normalize(vol_arbitrage_signals or [], mean_reversion_signals or [])
        by_asset: Dict[str, List[Dict]] = {}
        for sig in normalized:
            by_asset.setdefault(sig["asset"], []).append(sig)

        out = []
        positions = current_positions or {}
        for asset, sigs in by_asset.items():
            agg = self._aggregate_asset(asset, sigs, asset in positions)
            if agg is None or agg.signal_type == AggregatedSignalType.NO_ACTION:
                continue
            if agg.confidence < self.config.min_confidence_threshold:
                continue
            agg.suggested_position_size = self._position_size(agg.confidence, portfolio_value)
            agg.max_position_pct = self.config.max_single_position_pct
            out.append(agg)
        return sorted(out, key=lambda s: s.confidence, reverse=True)

    def filter_by_risk_budget(
        self,
        signals: List[AggregatedSignal],
        portfolio_value: float,
        current_exposure: float = 0.0,
    ) -> List[AggregatedSignal]:
        """Greedy truncation under the strategy allocation budget
        (aggregator.py:423-463)."""
        budget = self.config.max_strategy_allocation_pct * portfolio_value - current_exposure
        kept = []
        for sig in sorted(signals, key=lambda s: s.confidence, reverse=True):
            size = sig.suggested_position_size or 0.0
            if size <= budget:
                kept.append(sig)
                budget -= size
        return kept

    # ------------------------------------------------------------ internals

    @staticmethod
    def _normalize(vol_signals, mr_signals) -> List[Dict]:
        """Common schema across strategies (aggregator.py:183-240)."""
        rows = []
        for s in vol_signals:
            rows.append(
                {
                    "asset": s.underlying,
                    "strategy": "vol_arbitrage",
                    "direction": "buy" if s.signal_type == SignalType.BUY else "sell",
                    "confidence": s.confidence,
                    "rationale": s.rationale,
                    "raw": s.to_dict(),
                }
            )
        mr_dir = {
            MeanRevSignalType.ENTRY_LONG: "buy",
            MeanRevSignalType.ENTRY_SHORT: "sell",
            MeanRevSignalType.EXIT_TAKE_PROFIT: "exit",
            MeanRevSignalType.EXIT_STOP_LOSS: "exit",
        }
        for s in mr_signals:
            d = mr_dir.get(s.signal_type)
            if d is None:
                continue
            rows.append(
                {
                    "asset": s.spread_name,
                    "strategy": "mean_reversion",
                    "direction": d,
                    "confidence": s.confidence,
                    "rationale": s.rationale,
                    "raw": s.to_dict(),
                }
            )
        return rows

    def _aggregate_asset(self, asset: str, sigs: List[Dict], has_position: bool):
        if len(sigs) == 1:
            s = sigs[0]
            return AggregatedSignal(
                asset=asset,
                signal_type=self._to_type(s["direction"]),
                confidence=s["confidence"],
                supporting_strategies=[s["strategy"]],
                conflicting_strategies=[],
                rationale=s["rationale"],
                component_signals=[s["raw"]],
            )
        return self._resolve_multiple(asset, sigs, has_position)

    def _resolve_multiple(self, asset: str, sigs: List[Dict], has_position: bool):
        """Weighted voting with consensus dominance (aggregator.py:285-383)."""
        buy_w = sell_w = exit_w = 0.0
        buy_s, sell_s, exit_s = [], [], []
        for s in sigs:
            w = self.config.strategy_weights.get(s["strategy"], 1.0) * s["confidence"]
            if s["direction"] == "buy":
                buy_w += w
                buy_s.append(s["strategy"])
            elif s["direction"] == "sell":
                sell_w += w
                sell_s.append(s["strategy"])
            elif s["direction"] == "exit":
                exit_w += w
                exit_s.append(s["strategy"])

        # exits take priority when positioned
        if has_position and exit_w > 0:
            return AggregatedSignal(
                asset=asset,
                signal_type=AggregatedSignalType.EXIT,
                confidence=exit_w / len(exit_s) if exit_s else 0.0,
                supporting_strategies=exit_s,
                conflicting_strategies=[],
                rationale="Exit signal from position management",
                component_signals=[s["raw"] for s in sigs],
            )

        if self.config.require_unanimous and buy_w > 0 and sell_w > 0:
            return None

        if buy_w > 0 and sell_w == 0:
            direction, confidence = "buy", buy_w / len(buy_s)
            supporting, conflicting = buy_s, []
        elif sell_w > 0 and buy_w == 0:
            direction, confidence = "sell", sell_w / len(sell_s)
            supporting, conflicting = sell_s, []
        elif buy_w > sell_w * self.config.consensus_ratio:
            direction, confidence = "buy", buy_w / (buy_w + sell_w)
            supporting, conflicting = buy_s, sell_s
        elif sell_w > buy_w * self.config.consensus_ratio:
            direction, confidence = "sell", sell_w / (buy_w + sell_w)
            supporting, conflicting = sell_s, buy_s
        else:
            return None  # no consensus

        support_str = ", ".join(supporting)
        rationale = f"{direction.upper()} signal supported by: {support_str}"
        if conflicting:
            rationale += f" (conflicting: {', '.join(conflicting)})"

        return AggregatedSignal(
            asset=asset,
            signal_type=self._to_type(direction),
            confidence=confidence,
            supporting_strategies=supporting,
            conflicting_strategies=conflicting,
            rationale=rationale,
            component_signals=[s["raw"] for s in sigs],
        )

    @staticmethod
    def _to_type(direction: str) -> AggregatedSignalType:
        return {
            "buy": AggregatedSignalType.BUY,
            "sell": AggregatedSignalType.SELL,
            "exit": AggregatedSignalType.EXIT,
        }.get(direction, AggregatedSignalType.NO_ACTION)

    def _position_size(self, confidence: float, portfolio_value: float) -> float:
        """Confidence-scaled size under the single-position cap
        (aggregator.py:409-421)."""
        return confidence * self.config.max_single_position_pct * portfolio_value
