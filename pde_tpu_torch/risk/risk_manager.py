"""Core risk management: limit registry, pre-trade checks, portfolio risk.

Plain copy of ``pde_tpu/risk/risk_manager.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.  One addition: ``RiskManager`` takes the
``device`` and ``dtype`` its VaR runs on.

Mirrors the reference risk/risk_manager.py: the RiskLimitType taxonomy
(:31-46), RiskLimit with warning threshold and breach actions (:48-95),
PositionRisk / PortfolioRisk dataclasses (:96-251), pre-trade
``check_position_allowed`` (:413-532), portfolio aggregation with Herfindahl
concentration (:550-627), ``check_all_limits`` (:628-749) and the circuit
breaker (:750-771).  Host-side control logic by design; heavier analytics
(VaR) are delegated to pde_tpu_torch.risk.var_calculator.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "RiskLimitType",
    "RiskLimit",
    "PositionRisk",
    "PortfolioRisk",
    "RiskCheckResult",
    "RiskManager",
]


class RiskLimitType(str, enum.Enum):
    POSITION_SIZE = "position_size"
    TOTAL_EXPOSURE = "total_exposure"
    NET_EXPOSURE = "net_exposure"
    SECTOR_EXPOSURE = "sector_exposure"
    DELTA = "delta"
    GAMMA = "gamma"
    VEGA = "vega"
    VAR = "var"
    DRAWDOWN = "drawdown"
    LEVERAGE = "leverage"
    CONCENTRATION = "concentration"
    DAILY_LOSS = "daily_loss"


@dataclass
class RiskLimit:
    """Limit with 80% warning band and a breach action (risk_manager.py:48-95)."""

    limit_type: RiskLimitType
    value: float
    warning_threshold: float = 0.8
    action_on_breach: str = "alert"  # "alert" | "reduce" | "halt"
    metadata: Dict[str, Any] = field(default_factory=dict)

    def check_breach(self, current_value: float) -> Tuple[bool, str]:
        if abs(current_value) >= abs(self.value):
            return True, "breach"
        if abs(current_value) >= abs(self.value * self.warning_threshold):
            return False, "warning"
        return False, "ok"

    def to_dict(self) -> Dict:
        return {
            "limit_type": self.limit_type.value,
            "value": self.value,
            "warning_threshold": self.warning_threshold,
            "action_on_breach": self.action_on_breach,
            "metadata": self.metadata,
        }


@dataclass
class PositionRisk:
    """Per-position risk record (risk_manager.py:96-169)."""

    asset_id: str
    position_size: float
    market_value: float
    entry_price: float = 0.0
    current_price: float = 0.0
    pnl: float = 0.0
    pnl_pct: float = 0.0
    weight: float = 0.0
    delta: float = 0.0
    gamma: float = 0.0
    vega: float = 0.0
    theta: float = 0.0
    var_95: float = 0.0
    contribution_to_var: float = 0.0
    volatility: float = 0.0
    sector: Optional[str] = None
    strategy: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        d = self.__dict__.copy()
        d.pop("metadata")
        return d


@dataclass
class PortfolioRisk:
    """Aggregated portfolio risk (risk_manager.py:171-251)."""

    total_value: float
    total_exposure: float
    net_exposure: float
    leverage: float = 0.0
    total_delta: float = 0.0
    total_gamma: float = 0.0
    total_vega: float = 0.0
    total_theta: float = 0.0
    var_95: float = 0.0
    var_99: float = 0.0
    cvar_95: float = 0.0
    correlation_risk: float = 0.0
    concentration_risk: float = 0.0
    daily_pnl: float = 0.0
    total_pnl: float = 0.0
    position_risks: Dict[str, PositionRisk] = field(default_factory=dict)
    exposure_by_sector: Dict[str, float] = field(default_factory=dict)
    exposure_by_strategy: Dict[str, float] = field(default_factory=dict)
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))


@dataclass
class RiskCheckResult:
    """Pre-trade check outcome (risk_manager.py:252-271)."""

    is_allowed: bool
    breached_limits: List[str]
    warnings: List[str]
    recommended_action: str  # "proceed" | "reduce" | "halt"
    details: Dict[str, Any] = field(default_factory=dict)


class RiskManager:
    """Limit registry + position tracking + circuit breaker.

    ``device`` and ``dtype`` go to the VaR calculator of
    :meth:`compute_portfolio_risk` (default: the CUDA card, the returns'
    own precision)."""

    def __init__(
        self,
        total_capital: float,
        risk_free_rate: float = 0.05,
        target_volatility: float = 0.15,
        device=None,
        dtype=None,
    ):
        self.device = device
        self.dtype = dtype
        self.total_capital = total_capital
        self.risk_free_rate = risk_free_rate
        self.target_volatility = target_volatility
        self.limits: Dict[RiskLimitType, RiskLimit] = {}
        self.positions: Dict[str, PositionRisk] = {}
        self.portfolio_risk: Optional[PortfolioRisk] = None
        self._circuit_breaker_active = False
        self._circuit_breaker_reason: Optional[str] = None
        self._peak_value = total_capital
        self._current_value = total_capital

    # ------------------------------------------------------------- limits

    def add_limit(self, limit: RiskLimit) -> None:
        self.limits[limit.limit_type] = limit

    def remove_limit(self, limit_type: RiskLimitType) -> None:
        self.limits.pop(limit_type, None)

    def set_default_limits(self) -> None:
        """Design-doc defaults (risk_manager.py:367-412)."""
        for lt, value, action in [
            (RiskLimitType.POSITION_SIZE, 0.10, "reduce"),
            (RiskLimitType.TOTAL_EXPOSURE, 1.0, "halt"),
            (RiskLimitType.DRAWDOWN, 0.25, "halt"),
            (RiskLimitType.DAILY_LOSS, 0.03, "halt"),
            (RiskLimitType.DELTA, 50.0, "reduce"),
            (RiskLimitType.VAR, 0.02, "reduce"),
        ]:
            self.add_limit(RiskLimit(limit_type=lt, value=value, action_on_breach=action))

    # ----------------------------------------------------------- pre-trade

    def check_position_allowed(
        self,
        asset_id: str,
        position_size: float,
        current_price: float,
        position_risk: Optional[PositionRisk] = None,
    ) -> RiskCheckResult:
        """Pre-trade gate (risk_manager.py:413-532)."""
        breached: List[str] = []
        breached_types: List[RiskLimitType] = []
        warnings: List[str] = []
        details: Dict[str, Any] = {}

        if self._circuit_breaker_active:
            return RiskCheckResult(
                is_allowed=False,
                breached_limits=["circuit_breaker_active"],
                warnings=[],
                recommended_action="halt",
                details={"reason": self._circuit_breaker_reason},
            )

        position_value = abs(position_size * current_price)
        position_pct = position_value / self.total_capital if self.total_capital > 0 else 0.0

        def check(lt: RiskLimitType, current, label, fmt="{:.2%}"):
            if lt not in self.limits:
                return
            limit = self.limits[lt]
            is_breach, level = limit.check_breach(current)
            details[f"{label}"] = current
            details[f"{label}_limit"] = limit.value
            if is_breach:
                breached.append(
                    f"{lt.value}: {fmt.format(current)} > {fmt.format(limit.value)}"
                )
                breached_types.append(lt)
            elif level == "warning":
                warnings.append(
                    f"{lt.value} near limit: {fmt.format(current)} / {fmt.format(limit.value)}"
                )

        check(RiskLimitType.POSITION_SIZE, position_pct, "position_size_pct")

        current_exposure = sum(abs(p.market_value) for p in self.positions.values())
        exposure_pct = (
            (current_exposure + position_value) / self.total_capital
            if self.total_capital > 0
            else 0.0
        )
        check(RiskLimitType.TOTAL_EXPOSURE, exposure_pct, "total_exposure_pct")

        if position_risk is not None:
            new_delta = sum(p.delta for p in self.positions.values()) + position_risk.delta
            check(RiskLimitType.DELTA, new_delta, "new_portfolio_delta", fmt="{:.1f}")
            new_vega = sum(p.vega for p in self.positions.values()) + position_risk.vega
            check(RiskLimitType.VEGA, new_vega, "new_portfolio_vega", fmt="{:.1f}")

        if breached:
            # escalate to halt only when a BREACHED limit demands it — the
            # graded reduce/halt design must not trip on merely-registered
            # halt-class limits
            action = "reduce"
            for lt in breached_types:
                if self.limits[lt].action_on_breach == "halt":
                    action = "halt"
                    break
            return RiskCheckResult(False, breached, warnings, action, details)
        return RiskCheckResult(True, [], warnings, "proceed", details)

    # ------------------------------------------------------------- state

    def update_position(self, position: PositionRisk) -> None:
        self.positions[position.asset_id] = position

    def remove_position(self, asset_id: str) -> None:
        self.positions.pop(asset_id, None)

    def update_portfolio_value(self, value: float) -> None:
        self._current_value = value
        self._peak_value = max(self._peak_value, value)

    @property
    def current_drawdown(self) -> float:
        if self._peak_value <= 0:
            return 0.0
        return max(0.0, 1.0 - self._current_value / self._peak_value)

    # ---------------------------------------------------------- aggregation

    def compute_portfolio_risk(
        self, historical_returns: Optional[np.ndarray] = None, asset_ids=None
    ) -> PortfolioRisk:
        """Aggregate positions (risk_manager.py:550-627); VaR via the
        var_calculator when return history is supplied."""
        values = [p.market_value for p in self.positions.values()]
        gross = float(sum(abs(v) for v in values))
        net = float(sum(values))
        total_pnl = float(sum(p.pnl for p in self.positions.values()))

        weights = np.array([abs(v) / gross for v in values]) if gross > 0 else np.array([])
        herfindahl = float(np.sum(weights**2)) if weights.size else 0.0

        by_sector: Dict[str, float] = {}
        by_strategy: Dict[str, float] = {}
        for p in self.positions.values():
            if p.sector:
                by_sector[p.sector] = by_sector.get(p.sector, 0.0) + abs(p.market_value)
            if p.strategy:
                by_strategy[p.strategy] = by_strategy.get(p.strategy, 0.0) + abs(p.market_value)

        risk = PortfolioRisk(
            total_value=self._current_value,
            total_exposure=gross,
            net_exposure=net,
            leverage=gross / self.total_capital if self.total_capital > 0 else 0.0,
            total_delta=float(sum(p.delta for p in self.positions.values())),
            total_gamma=float(sum(p.gamma for p in self.positions.values())),
            total_vega=float(sum(p.vega for p in self.positions.values())),
            total_theta=float(sum(p.theta for p in self.positions.values())),
            concentration_risk=herfindahl,
            total_pnl=total_pnl,
            position_risks=dict(self.positions),
            exposure_by_sector=by_sector,
            exposure_by_strategy=by_strategy,
        )

        if historical_returns is not None and len(self.positions) > 0:
            from .var_calculator import VaRCalculator, VaRMethod

            calc = VaRCalculator(method=VaRMethod.HISTORICAL, device=self.device,
                                 dtype=self.dtype)
            pv = {p.asset_id: p.market_value for p in self.positions.values()}
            var = calc.calculate(pv, historical_returns, asset_ids=asset_ids or list(pv))
            risk.var_95 = var.var_95
            risk.var_99 = var.var_99
            risk.cvar_95 = var.cvar_95

        self.portfolio_risk = risk
        return risk

    def check_all_limits(
        self, daily_pnl: float = 0.0, historical_returns=None
    ) -> RiskCheckResult:
        """Post-trade portfolio-wide audit (risk_manager.py:628-749).

        Pass ``historical_returns`` to refresh VaR as part of the audit;
        otherwise the VaR figures of the LAST ``compute_portfolio_risk``
        call are carried forward (recomputing without return history would
        silently zero var_95 and make the VAR limit unbreachable).
        """
        prev = self.portfolio_risk
        risk = self.compute_portfolio_risk(historical_returns=historical_returns)
        if historical_returns is None and prev is not None:
            risk.var_95, risk.var_99, risk.cvar_95 = (
                prev.var_95, prev.var_99, prev.cvar_95,
            )
        breached: List[str] = []
        breached_types: List[RiskLimitType] = []
        warnings: List[str] = []
        details: Dict[str, Any] = {}

        checks = {
            RiskLimitType.TOTAL_EXPOSURE: risk.total_exposure / self.total_capital
            if self.total_capital
            else 0.0,
            RiskLimitType.NET_EXPOSURE: risk.net_exposure / self.total_capital
            if self.total_capital
            else 0.0,
            RiskLimitType.LEVERAGE: risk.leverage,
            RiskLimitType.DRAWDOWN: self.current_drawdown,
            RiskLimitType.DAILY_LOSS: -daily_pnl / self.total_capital
            if self.total_capital and daily_pnl < 0
            else 0.0,
            RiskLimitType.DELTA: risk.total_delta,
            RiskLimitType.GAMMA: risk.total_gamma,
            RiskLimitType.VEGA: risk.total_vega,
            RiskLimitType.CONCENTRATION: risk.concentration_risk,
            RiskLimitType.VAR: risk.var_95 / self.total_capital if self.total_capital else 0.0,
        }

        halt = False
        for lt, current in checks.items():
            if lt not in self.limits:
                continue
            limit = self.limits[lt]
            is_breach, level = limit.check_breach(current)
            details[lt.value] = current
            if is_breach:
                breached.append(f"{lt.value}: {current:.4f} > {limit.value:.4f}")
                halt = halt or limit.action_on_breach == "halt"
            elif level == "warning":
                warnings.append(f"{lt.value} near limit: {current:.4f} / {limit.value:.4f}")

        if breached and halt:
            self.activate_circuit_breaker(f"limit breach: {breached[0]}")

        return RiskCheckResult(
            is_allowed=not breached,
            breached_limits=breached,
            warnings=warnings,
            recommended_action="halt" if halt else ("reduce" if breached else "proceed"),
            details=details,
        )

    # -------------------------------------------------------- circuit breaker

    def activate_circuit_breaker(self, reason: str) -> None:
        self._circuit_breaker_active = True
        self._circuit_breaker_reason = reason

    def deactivate_circuit_breaker(self) -> None:
        self._circuit_breaker_active = False
        self._circuit_breaker_reason = None

    @property
    def circuit_breaker_active(self) -> bool:
        return self._circuit_breaker_active

    # ------------------------------------------------------------- reports

    def get_position_summary(self) -> Dict[str, Any]:
        return {
            "n_positions": len(self.positions),
            "gross_exposure": float(sum(abs(p.market_value) for p in self.positions.values())),
            "net_exposure": float(sum(p.market_value for p in self.positions.values())),
            "total_pnl": float(sum(p.pnl for p in self.positions.values())),
            "positions": {k: v.to_dict() for k, v in self.positions.items()},
        }

    def get_limit_status(self) -> Dict[str, Any]:
        return {lt.value: limit.to_dict() for lt, limit in self.limits.items()}

    def reset(self, new_capital: Optional[float] = None) -> None:
        if new_capital is not None:
            self.total_capital = new_capital
        self.positions.clear()
        self.portfolio_risk = None
        self._peak_value = self.total_capital
        self._current_value = self.total_capital
        self.deactivate_circuit_breaker()
