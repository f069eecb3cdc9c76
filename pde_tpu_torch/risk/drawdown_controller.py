"""Drawdown monitoring, tiered risk levels, and kill switch.

Plain copy of ``pde_tpu/risk/drawdown_controller.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.

Mirrors the reference risk/drawdown_controller.py: equity tracking with
rolling 30/60/90-day drawdowns (:200-302), risk levels
NORMAL -> ELEVATED -> HIGH -> CRITICAL -> EMERGENCY with per-level exposure
multipliers (:303-387, thresholds 10/15/20/25/30%), daily-loss and
consecutive-loss gates, per-strategy limits (:448-490) and the kill switch
(:429-447).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "RiskLevel",
    "RiskAction",
    "DrawdownMetrics",
    "RiskLimitStatus",
    "DrawdownControllerConfig",
    "DrawdownController",
]


class RiskLevel(str, enum.Enum):
    NORMAL = "normal"
    ELEVATED = "elevated"
    HIGH = "high"
    CRITICAL = "critical"
    EMERGENCY = "emergency"

    @property
    def severity(self) -> int:
        return ["normal", "elevated", "high", "critical", "emergency"].index(self.value)


class RiskAction(str, enum.Enum):
    NO_ACTION = "no_action"
    REDUCE_EXPOSURE = "reduce_exposure"
    HALT_NEW_TRADES = "halt_new_trades"
    CLOSE_POSITIONS = "close_positions"
    KILL_SWITCH = "kill_switch"


@dataclass
class DrawdownMetrics:
    current_drawdown: float
    max_drawdown: float
    drawdown_duration_days: int
    peak_value: float
    current_value: float
    recovery_needed: float
    drawdown_30d: float = 0.0
    drawdown_60d: float = 0.0
    drawdown_90d: float = 0.0
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))

    def to_dict(self) -> Dict:
        d = self.__dict__.copy()
        d["timestamp"] = self.timestamp.isoformat()
        return d


@dataclass
class RiskLimitStatus:
    risk_level: RiskLevel
    recommended_action: RiskAction
    limits_breached: List[str]
    exposure_multiplier: float
    message: str
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))


@dataclass
class DrawdownControllerConfig:
    """Thresholds/multipliers match drawdown_controller.py:116-142."""

    warning_threshold: float = 0.10
    elevated_threshold: float = 0.15
    high_threshold: float = 0.20
    critical_threshold: float = 0.25
    emergency_threshold: float = 0.30
    elevated_exposure_mult: float = 0.75
    high_exposure_mult: float = 0.50
    critical_exposure_mult: float = 0.25
    emergency_exposure_mult: float = 0.0
    max_daily_loss_pct: float = 0.03
    consecutive_loss_days_limit: int = 5
    max_strategy_drawdown: float = 0.15
    max_position_loss_pct: float = 0.10
    min_recovery_before_increase: float = 0.05


class DrawdownController:
    """Equity-curve risk governor with tiered exposure reduction."""

    def __init__(self, initial_capital: float, config: Optional[DrawdownControllerConfig] = None):
        self.config = config or DrawdownControllerConfig()
        self._initial_capital = initial_capital
        self._equity: List[float] = [initial_capital]
        self._timestamps: List[datetime] = [datetime.now(timezone.utc)]
        self._daily_returns: List[float] = []
        self._peak_value = initial_capital
        self._peak_time = self._timestamps[0]
        self._max_drawdown = 0.0
        self._kill_switch_active = False
        self._kill_switch_reason: Optional[str] = None

    # ------------------------------------------------------------------ API

    def update(self, portfolio_value: float, timestamp: Optional[datetime] = None) -> DrawdownMetrics:
        """Record a new equity point and recompute metrics."""
        ts = timestamp or datetime.now(timezone.utc)
        prev = self._equity[-1]
        self._equity.append(portfolio_value)
        self._timestamps.append(ts)
        if prev > 0:
            self._daily_returns.append(portfolio_value / prev - 1.0)
        if portfolio_value > self._peak_value:
            self._peak_value = portfolio_value
            self._peak_time = ts
        dd = self.current_drawdown
        self._max_drawdown = max(self._max_drawdown, dd)
        return self._compute_metrics(ts)

    @property
    def current_drawdown(self) -> float:
        if self._peak_value <= 0:
            return 0.0
        return max(0.0, 1.0 - self._equity[-1] / self._peak_value)

    def check_limits(self) -> RiskLimitStatus:
        """Tiered drawdown gates + daily-loss + consecutive-loss checks
        (drawdown_controller.py:303-387)."""
        if self._kill_switch_active:
            return RiskLimitStatus(
                risk_level=RiskLevel.EMERGENCY,
                recommended_action=RiskAction.KILL_SWITCH,
                limits_breached=["kill_switch_active"],
                exposure_multiplier=0.0,
                message=f"Kill switch active: {self._kill_switch_reason}",
            )

        metrics = self._compute_metrics(datetime.now(timezone.utc))
        breached: List[str] = []
        level = RiskLevel.NORMAL
        mult = 1.0
        c = self.config
        dd = metrics.current_drawdown

        tiers = [
            (c.emergency_threshold, RiskLevel.EMERGENCY, c.emergency_exposure_mult, "emergency"),
            (c.critical_threshold, RiskLevel.CRITICAL, c.critical_exposure_mult, "critical"),
            (c.high_threshold, RiskLevel.HIGH, c.high_exposure_mult, "high"),
            (c.elevated_threshold, RiskLevel.ELEVATED, c.elevated_exposure_mult, "elevated"),
        ]
        for threshold, lvl, m, name in tiers:
            if dd >= threshold:
                level, mult = lvl, m
                breached.append(f"drawdown {dd:.1%} >= {name} {threshold:.0%}")
                break

        if self._daily_returns and self._daily_returns[-1] < -c.max_daily_loss_pct:
            if level.severity < RiskLevel.ELEVATED.severity:
                level = RiskLevel.ELEVATED
            breached.append(
                f"daily loss {self._daily_returns[-1]:.1%} exceeds limit -{c.max_daily_loss_pct:.0%}"
            )

        streak = self._consecutive_losses()
        if streak >= c.consecutive_loss_days_limit:
            if level.severity < RiskLevel.ELEVATED.severity:
                level = RiskLevel.ELEVATED
            breached.append(f"{streak} consecutive losing days")

        action = {
            RiskLevel.NORMAL: RiskAction.NO_ACTION,
            RiskLevel.ELEVATED: RiskAction.REDUCE_EXPOSURE,
            RiskLevel.HIGH: RiskAction.REDUCE_EXPOSURE,
            RiskLevel.CRITICAL: RiskAction.HALT_NEW_TRADES,
            RiskLevel.EMERGENCY: RiskAction.CLOSE_POSITIONS,
        }[level]

        if level == RiskLevel.NORMAL:
            msg = f"Risk normal. Drawdown: {dd:.1%}, Peak: {metrics.peak_value:,.0f}"
        else:
            msg = (
                f"Risk {level.value}. Drawdown: {dd:.1%}, "
                f"Recovery needed: {metrics.recovery_needed:.1%}. "
                f"Limits breached: {'; '.join(breached) or 'none'}"
            )

        return RiskLimitStatus(
            risk_level=level,
            recommended_action=action,
            limits_breached=breached,
            exposure_multiplier=mult,
            message=msg,
        )

    def check_strategy_limits(self, strategy_equity: Dict[str, List[float]]) -> Dict[str, RiskLimitStatus]:
        """Per-strategy drawdown gates (drawdown_controller.py:448-490)."""
        out = {}
        for name, equity in strategy_equity.items():
            arr = np.asarray(equity, dtype=np.float64)
            peak = np.maximum.accumulate(arr)
            dd = float(np.max(1.0 - arr / np.maximum(peak, 1e-300)))
            if dd >= self.config.max_strategy_drawdown:
                out[name] = RiskLimitStatus(
                    risk_level=RiskLevel.HIGH,
                    recommended_action=RiskAction.REDUCE_EXPOSURE,
                    limits_breached=[
                        f"strategy drawdown {dd:.1%} >= {self.config.max_strategy_drawdown:.0%}"
                    ],
                    exposure_multiplier=0.5,
                    message=f"{name}: strategy drawdown limit breached",
                )
            else:
                out[name] = RiskLimitStatus(
                    risk_level=RiskLevel.NORMAL,
                    recommended_action=RiskAction.NO_ACTION,
                    limits_breached=[],
                    exposure_multiplier=1.0,
                    message=f"{name}: ok (drawdown {dd:.1%})",
                )
        return out

    def activate_kill_switch(self, reason: str) -> None:
        self._kill_switch_active = True
        self._kill_switch_reason = reason

    def deactivate_kill_switch(self) -> None:
        self._kill_switch_active = False
        self._kill_switch_reason = None

    @property
    def kill_switch_active(self) -> bool:
        return self._kill_switch_active

    def get_metrics(self) -> DrawdownMetrics:
        return self._compute_metrics(datetime.now(timezone.utc))

    def reset(self, new_capital: float) -> None:
        self.__init__(new_capital, self.config)

    # ------------------------------------------------------------ internals

    def _compute_metrics(self, ts: datetime) -> DrawdownMetrics:
        dd = self.current_drawdown
        current = self._equity[-1]
        recovery = (self._peak_value / current - 1.0) if current > 0 else float("inf")
        duration = (ts - self._peak_time).days
        return DrawdownMetrics(
            current_drawdown=dd,
            max_drawdown=self._max_drawdown,
            drawdown_duration_days=duration,
            peak_value=self._peak_value,
            current_value=current,
            recovery_needed=recovery,
            drawdown_30d=self._rolling_drawdown(30),
            drawdown_60d=self._rolling_drawdown(60),
            drawdown_90d=self._rolling_drawdown(90),
            timestamp=ts,
        )

    def _rolling_drawdown(self, days: int) -> float:
        window = np.asarray(self._equity[-days:], dtype=np.float64)
        if window.size < 2:
            return 0.0
        peak = np.maximum.accumulate(window)
        return float(np.max(1.0 - window / np.maximum(peak, 1e-300)))

    def _consecutive_losses(self) -> int:
        count = 0
        for r in reversed(self._daily_returns):
            if r < 0:
                count += 1
            else:
                break
        return count
