"""Mean-reversion entry/exit signals from OU optimal boundaries.

Plain copy of ``pde_tpu/signals/mean_reversion.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.

Mirrors the reference MeanReversionSignalGenerator
(signals/mean_reversion.py): half-life/speed validation gates (:256-281),
boundary-crossing entries with distance-scaled confidence (:283-357,
:436-462), stop-loss-first exits (:359-435), and a position registry
(:464-477).  This layer is host-side state-machine logic by design; the
device-side batched equivalent over whole histories is
pde_tpu_torch.models.ou.generate_trading_signals.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional

__all__ = [
    "MeanRevSignalType",
    "Position",
    "MeanReversionSignal",
    "MeanReversionConfig",
    "MeanReversionSignalGenerator",
]


class MeanRevSignalType(str, enum.Enum):
    ENTRY_LONG = "entry_long"
    ENTRY_SHORT = "entry_short"
    EXIT_TAKE_PROFIT = "exit_take_profit"
    EXIT_STOP_LOSS = "exit_stop_loss"
    HOLD = "hold"


@dataclass
class Position:
    """Open spread position (mirrors signals/mean_reversion.py:45-67)."""

    spread_name: str
    direction: str  # 'long' | 'short'
    entry_price: float
    entry_time: datetime
    quantity: float
    stop_loss: float
    take_profit: float

    def to_dict(self) -> Dict:
        return {
            "spread_name": self.spread_name,
            "direction": self.direction,
            "entry_price": self.entry_price,
            "entry_time": self.entry_time.isoformat(),
            "quantity": self.quantity,
            "stop_loss": self.stop_loss,
            "take_profit": self.take_profit,
        }


@dataclass
class MeanReversionSignal:
    """Signal payload (mirrors signals/mean_reversion.py:70-110)."""

    spread_name: str
    signal_type: MeanRevSignalType
    confidence: float
    current_value: float
    rationale: str
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    theta: Optional[float] = None
    half_life_days: Optional[float] = None
    entry_lower: Optional[float] = None
    entry_upper: Optional[float] = None
    exit_target: Optional[float] = None
    entry_price: Optional[float] = None
    pnl: Optional[float] = None

    def to_dict(self) -> Dict:
        return {
            "spread_name": self.spread_name,
            "signal_type": self.signal_type.value,
            "confidence": self.confidence,
            "current_value": self.current_value,
            "rationale": self.rationale,
            "timestamp": self.timestamp.isoformat(),
            "theta": self.theta,
            "half_life_days": self.half_life_days,
            "entry_lower": self.entry_lower,
            "entry_upper": self.entry_upper,
            "exit_target": self.exit_target,
            "entry_price": self.entry_price,
            "pnl": self.pnl,
        }


@dataclass
class MeanReversionConfig:
    """Gates and thresholds (defaults match signals/mean_reversion.py:113-131)."""

    min_half_life_days: float = 5.0
    max_half_life_days: float = 120.0
    min_mean_reversion_speed: float = 0.5
    min_confidence: float = 0.6
    min_sigma_distance: float = 1.0
    default_stop_loss_sigma: float = 2.0
    default_take_profit_sigma: float = 0.0


class MeanReversionSignalGenerator:
    """Boundary-crossing signal state machine per spread."""

    def __init__(
        self,
        config: Optional[MeanReversionConfig] = None,
        position_manager: Optional[Dict[str, Position]] = None,
    ):
        self.config = config or MeanReversionConfig()
        self._positions: Dict[str, Position] = position_manager or {}

    # ------------------------------------------------------------------ API

    def generate_signal(
        self,
        spread_name: str,
        current_value: float,
        ou_fit_result,
        current_position: Optional[Position] = None,
    ) -> Optional[MeanReversionSignal]:
        """Entry check when flat, exit check when positioned
        (signals/mean_reversion.py:176-221)."""
        params = ou_fit_result.params
        boundaries = ou_fit_result.boundaries
        if not self._validate_ou_params(params):
            return None

        position = current_position or self._positions.get(spread_name)
        if position is None:
            return self._check_entry(spread_name, current_value, params, boundaries)
        return self._check_exit(spread_name, current_value, params, position)

    def generate_signals_batch(self, spreads: Dict[str, float], ou_results: Dict) -> List[MeanReversionSignal]:
        signals = []
        for name, value in spreads.items():
            if name not in ou_results:
                continue
            s = self.generate_signal(name, value, ou_results[name])
            if s is not None:
                signals.append(s)
        return signals

    def register_position(self, position: Position) -> None:
        self._positions[position.spread_name] = position

    def close_position(self, spread_name: str) -> Optional[Position]:
        return self._positions.pop(spread_name, None)

    def get_position(self, spread_name: str) -> Optional[Position]:
        return self._positions.get(spread_name)

    # ------------------------------------------------------------ internals

    def _validate_ou_params(self, params) -> bool:
        """Half-life window + reversion-speed gate (mean_reversion.py:256-281)."""
        half_life_days = float(params.half_life()) * 252.0
        if half_life_days < self.config.min_half_life_days:
            return False
        if half_life_days > self.config.max_half_life_days:
            return False
        if float(params.mu) < self.config.min_mean_reversion_speed:
            return False
        return True

    def _check_entry(self, spread_name, current_value, params, boundaries):
        theta = float(params.theta)
        sigma_stat = float(params.stationary_std())
        entry_lower = float(boundaries.entry_lower)
        entry_upper = float(boundaries.entry_upper)
        dist_sigma = abs(current_value - theta) / sigma_stat

        if current_value < entry_lower:
            side, boundary = MeanRevSignalType.ENTRY_LONG, entry_lower
        elif current_value > entry_upper:
            side, boundary = MeanRevSignalType.ENTRY_SHORT, entry_upper
        else:
            return None

        confidence = self._entry_confidence(current_value, boundary, theta, sigma_stat)
        if confidence < self.config.min_confidence:
            return None

        word = "<" if side == MeanRevSignalType.ENTRY_LONG else ">"
        bound_name = "entry lower" if side == MeanRevSignalType.ENTRY_LONG else "entry upper"
        return MeanReversionSignal(
            spread_name=spread_name,
            signal_type=side,
            confidence=confidence,
            current_value=current_value,
            rationale=(
                f"Spread {current_value:.4f} {word} {bound_name} {boundary:.4f}, "
                f"expect reversion to theta={theta:.4f} ({dist_sigma:.1f} sigma from mean)"
            ),
            theta=theta,
            half_life_days=float(params.half_life()) * 252.0,
            entry_lower=entry_lower,
            entry_upper=entry_upper,
            exit_target=theta,
        )

    def _check_exit(self, spread_name, current_value, params, position: Position):
        """Stop-loss has priority over take-profit (mean_reversion.py:359-435)."""
        theta = float(params.theta)
        long_ = position.direction == "long"
        pnl = (current_value - position.entry_price) if long_ else (position.entry_price - current_value)

        stop_hit = current_value <= position.stop_loss if long_ else current_value >= position.stop_loss
        if stop_hit:
            return MeanReversionSignal(
                spread_name=spread_name,
                signal_type=MeanRevSignalType.EXIT_STOP_LOSS,
                confidence=1.0,
                current_value=current_value,
                rationale=f"Stop-loss triggered at {current_value:.4f}",
                theta=theta,
                entry_price=position.entry_price,
                pnl=pnl,
            )

        tp_hit = current_value >= position.take_profit if long_ else current_value <= position.take_profit
        if tp_hit:
            return MeanReversionSignal(
                spread_name=spread_name,
                signal_type=MeanRevSignalType.EXIT_TAKE_PROFIT,
                confidence=0.9,
                current_value=current_value,
                rationale=(
                    f"Take-profit at {current_value:.4f}, gained {pnl:.4f} "
                    f"from entry {position.entry_price:.4f}"
                ),
                theta=theta,
                entry_price=position.entry_price,
                pnl=pnl,
            )
        return None

    def _entry_confidence(self, current_value, boundary, theta, sigma_stat) -> float:
        """0.6 base + 0.35 * (distance past boundary / 2 sigma), capped 0.95,
        +0.05 bonus beyond 2 sigma from the mean (mean_reversion.py:436-462)."""
        distance_past = abs(current_value - boundary)
        dist_sigma = abs(current_value - theta) / sigma_stat
        confidence = min(0.95, 0.6 + (distance_past / (2.0 * sigma_stat)) * 0.35)
        if dist_sigma > 2.0:
            confidence = min(0.98, confidence + 0.05)
        return confidence
