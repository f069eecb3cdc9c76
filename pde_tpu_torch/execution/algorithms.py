"""Execution algorithms: TWAP, VWAP, Iceberg, POV slicing.

Plain copy of ``pde_tpu/execution/algorithms.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference execution/algorithms.py: ExecutionSlice / ExecutionPlan
(:43-156), BaseExecutor (:157-205), TWAP with even time buckets (:206-331),
VWAP with a U-shaped intraday volume profile (:332-484), Iceberg display
slices (:485-615), POV participation slicing (:616-757) and the factory
(:758-794).
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional

import numpy as np

from .order import Order, OrderSide

__all__ = [
    "ExecutionAlgorithm",
    "ExecutionSlice",
    "ExecutionPlan",
    "BaseExecutor",
    "TWAPExecutor",
    "VWAPExecutor",
    "IcebergExecutor",
    "POVExecutor",
    "create_executor",
    "simulate_plan",
]


class ExecutionAlgorithm(str, enum.Enum):
    TWAP = "twap"
    VWAP = "vwap"
    ICEBERG = "iceberg"
    POV = "pov"


@dataclass
class ExecutionSlice:
    """One child slice of a parent order (algorithms.py:43-88)."""

    slice_id: int
    quantity: float
    scheduled_time: datetime
    filled_quantity: float = 0.0
    avg_price: float = 0.0
    submitted: bool = False

    @property
    def remaining(self) -> float:
        return max(0.0, self.quantity - self.filled_quantity)

    @property
    def fill_rate(self) -> float:
        return self.filled_quantity / self.quantity if self.quantity > 0 else 0.0


@dataclass
class ExecutionPlan:
    """A schedule of slices for a parent order (algorithms.py:90-156)."""

    order: Order
    algorithm: ExecutionAlgorithm
    slices: List[ExecutionSlice] = field(default_factory=list)
    params: Dict = field(default_factory=dict)

    @property
    def n_slices(self) -> int:
        return len(self.slices)

    @property
    def total_quantity(self) -> float:
        return sum(s.quantity for s in self.slices)

    @property
    def filled_quantity(self) -> float:
        return sum(s.filled_quantity for s in self.slices)

    @property
    def completion_rate(self) -> float:
        tq = self.total_quantity
        return self.filled_quantity / tq if tq > 0 else 0.0

    @property
    def pending_slices(self) -> List[ExecutionSlice]:
        return [s for s in self.slices if not s.submitted]

    def next_slice(self, now: Optional[datetime] = None) -> Optional[ExecutionSlice]:
        now = now or datetime.now(timezone.utc)
        for s in self.slices:
            if not s.submitted and s.scheduled_time <= now:
                return s
        return None

    @property
    def avg_fill_price(self) -> float:
        filled = self.filled_quantity
        if filled <= 0:
            return 0.0
        return sum(s.avg_price * s.filled_quantity for s in self.slices) / filled

    def record_fill(self, slice_id: int, quantity: float, price: float) -> None:
        s = self.slices[slice_id]
        total = s.filled_quantity + quantity
        s.avg_price = (s.avg_price * s.filled_quantity + price * quantity) / total
        s.filled_quantity = total


class BaseExecutor(abc.ABC):
    def __init__(self, algorithm: ExecutionAlgorithm):
        self.algorithm = algorithm

    @abc.abstractmethod
    def create_plan(self, order: Order, **params) -> ExecutionPlan:
        ...


class TWAPExecutor(BaseExecutor):
    """Equal slices on an even time grid (algorithms.py:206-331)."""

    def __init__(self):
        super().__init__(ExecutionAlgorithm.TWAP)

    def create_plan(
        self,
        order: Order,
        duration_minutes: float = 60.0,
        n_slices: int = 10,
        start_time: Optional[datetime] = None,
        **_,
    ) -> ExecutionPlan:
        if n_slices < 1:
            raise ValueError("n_slices must be >= 1")
        start = start_time or datetime.now(timezone.utc)
        step = timedelta(minutes=duration_minutes / n_slices)
        base = order.quantity / n_slices
        slices = [
            ExecutionSlice(i, base, start + i * step) for i in range(n_slices)
        ]
        # rounding drift goes to the last slice
        slices[-1].quantity += order.quantity - sum(s.quantity for s in slices)
        return ExecutionPlan(order, self.algorithm, slices,
                             {"duration_minutes": duration_minutes, "n_slices": n_slices})


# U-shaped intraday volume profile over 13 half-hour buckets
# (algorithms.py:351-431 uses the same open/close-heavy shape)
_U_PROFILE = np.array([0.14, 0.09, 0.07, 0.06, 0.055, 0.05, 0.05, 0.05, 0.055, 0.06, 0.07, 0.10, 0.20])


class VWAPExecutor(BaseExecutor):
    """Volume-profile-weighted slices (algorithms.py:332-484)."""

    def __init__(self, volume_profile: Optional[np.ndarray] = None):
        super().__init__(ExecutionAlgorithm.VWAP)
        self.volume_profile = volume_profile if volume_profile is not None else _U_PROFILE

    def create_plan(
        self,
        order: Order,
        duration_minutes: float = 390.0,
        start_time: Optional[datetime] = None,
        **_,
    ) -> ExecutionPlan:
        profile = np.asarray(self.volume_profile, dtype=np.float64)
        profile = profile / profile.sum()
        n = len(profile)
        start = start_time or datetime.now(timezone.utc)
        step = timedelta(minutes=duration_minutes / n)
        slices = [
            ExecutionSlice(i, order.quantity * float(w), start + i * step)
            for i, w in enumerate(profile)
        ]
        slices[-1].quantity += order.quantity - sum(s.quantity for s in slices)
        return ExecutionPlan(order, self.algorithm, slices, {"profile_buckets": n})


class IcebergExecutor(BaseExecutor):
    """Show only ``display_size`` at a time (algorithms.py:485-615)."""

    def __init__(self):
        super().__init__(ExecutionAlgorithm.ICEBERG)

    def create_plan(
        self,
        order: Order,
        display_size: float = 100.0,
        replenish_seconds: float = 30.0,
        start_time: Optional[datetime] = None,
        **_,
    ) -> ExecutionPlan:
        if display_size <= 0:
            raise ValueError("display_size must be positive")
        start = start_time or datetime.now(timezone.utc)
        n_full, remainder = divmod(order.quantity, display_size)
        quantities = [display_size] * int(n_full) + ([remainder] if remainder > 1e-9 else [])
        slices = [
            ExecutionSlice(i, q, start + timedelta(seconds=i * replenish_seconds))
            for i, q in enumerate(quantities)
        ]
        return ExecutionPlan(order, self.algorithm, slices,
                             {"display_size": display_size, "replenish_seconds": replenish_seconds})


class POVExecutor(BaseExecutor):
    """Percentage-of-volume participation (algorithms.py:616-757):
    slice_i = participation_rate * expected_volume_i, truncated when the
    parent quantity is exhausted."""

    def __init__(self):
        super().__init__(ExecutionAlgorithm.POV)

    def create_plan(
        self,
        order: Order,
        participation_rate: float = 0.1,
        expected_volume_per_bucket: float = 10_000.0,
        bucket_minutes: float = 30.0,
        max_buckets: int = 50,
        start_time: Optional[datetime] = None,
        **_,
    ) -> ExecutionPlan:
        if not 0 < participation_rate <= 0.5:
            raise ValueError("participation_rate must be in (0, 0.5]")
        start = start_time or datetime.now(timezone.utc)
        per_bucket = participation_rate * expected_volume_per_bucket
        slices: List[ExecutionSlice] = []
        remaining = order.quantity
        i = 0
        while remaining > 1e-9 and i < max_buckets:
            q = min(per_bucket, remaining)
            slices.append(ExecutionSlice(i, q, start + timedelta(minutes=i * bucket_minutes)))
            remaining -= q
            i += 1
        if remaining > 1e-9:
            slices[-1].quantity += remaining  # cap reached: dump tail in last bucket
        return ExecutionPlan(order, self.algorithm, slices,
                             {"participation_rate": participation_rate})


_EXECUTORS = {
    ExecutionAlgorithm.TWAP: TWAPExecutor,
    ExecutionAlgorithm.VWAP: VWAPExecutor,
    ExecutionAlgorithm.ICEBERG: IcebergExecutor,
    ExecutionAlgorithm.POV: POVExecutor,
}


def create_executor(algorithm) -> BaseExecutor:
    """Factory (algorithms.py:758-794)."""
    algo = ExecutionAlgorithm(algorithm)
    return _EXECUTORS[algo]()


def simulate_plan(
    plan: ExecutionPlan,
    tick_times: np.ndarray,
    tick_prices: np.ndarray,
    *,
    slippage_pct: float = 0.0005,
    market_impact_coeff: float = 0.1,
    adv: float = 1e6,
) -> Dict[str, float]:
    """Simulate an execution plan against a tick path in one native call.

    Child slices are released as market orders at their scheduled times (or
    as limit orders when the parent carries a limit price) and filled by the
    native order-stream engine (src/cpp/pde_host.cpp simulate_fills) with
    slippage, square-root market impact and IBKR commissions.  Fills are
    recorded back into the plan; the return value is a TCA-style summary.

    ``tick_times`` are epoch seconds (compare against each slice's
    ``scheduled_time``).  Falls back to a pure-Python loop when the native
    toolchain is unavailable.
    """
    from .. import native

    tick_times = np.ascontiguousarray(tick_times, dtype=np.float64)
    tick_prices = np.ascontiguousarray(tick_prices, dtype=np.float64)
    slices = sorted(plan.slices, key=lambda s: s.scheduled_time)
    n = len(slices)
    submit = np.array([s.scheduled_time.timestamp() for s in slices])
    side = 1.0 if plan.order.side == OrderSide.BUY else -1.0
    sides = np.full(n, side)
    limit = plan.order.limit_price
    types = np.full(n, 0.0 if limit is None else 1.0)
    limits = np.full(n, 0.0 if limit is None else float(limit))
    stops = np.zeros(n)
    qty = np.array([s.quantity for s in slices])

    if native.is_available():
        _, fills = native.simulate_fills(
            tick_times, tick_prices, submit, sides, types, limits, stops, qty,
            slippage_pct=slippage_pct, market_impact_coeff=market_impact_coeff,
            adv=adv,
        )
    else:  # pure-Python fallback: same semantics, one pass over the ticks
        fills = np.full((n, 4), np.nan)
        pending: List[int] = []
        oi = 0
        for t, px in zip(tick_times, tick_prices):
            while oi < n and submit[oi] <= t:
                pending.append(oi)
                oi += 1
            if px <= 0:
                continue
            still = []
            for k in pending:
                marketable = types[k] == 0.0 or (
                    (side > 0 and px <= limits[k]) or (side < 0 and px >= limits[k])
                )
                if not marketable:
                    still.append(k)
                    continue
                q = abs(qty[k])
                impact = market_impact_coeff * np.sqrt(q / adv)
                fp = px * (1.0 + side * (slippage_pct + impact))
                if types[k] == 1.0:
                    # limit orders never fill through their limit (same cap
                    # as the native engine, src/cpp/pde_host.cpp)
                    fp = min(fp, limits[k]) if side > 0 else max(fp, limits[k])
                fills[k] = (t, fp, min(max(q * 0.005, 1.0), 0.01 * q * fp),
                            abs(fp - px) * q)
            pending = still

    filled = ~np.isnan(fills[:, 0])
    for s, row, ok in zip(slices, fills, filled):
        if ok:
            plan.record_fill(s.slice_id, s.quantity, float(row[1]))

    arrival = float(tick_prices[tick_prices > 0][0]) if np.any(tick_prices > 0) else 0.0
    fqty = qty[filled]
    fprice = fills[filled, 1]
    total_filled = float(fqty.sum())
    avg_price = float((fqty * fprice).sum() / total_filled) if total_filled else 0.0
    shortfall = side * (avg_price - arrival) / arrival * 1e4 if arrival else 0.0
    return {
        "n_slices": float(n),
        "n_filled": float(filled.sum()),
        "filled_quantity": total_filled,
        "avg_fill_price": avg_price,
        "arrival_price": arrival,
        "implementation_shortfall_bps": float(shortfall),
        "total_commission": float(np.nansum(fills[filled, 2])) if filled.any() else 0.0,
        "total_slippage": float(np.nansum(fills[filled, 3])) if filled.any() else 0.0,
    }
