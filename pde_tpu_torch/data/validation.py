"""Market-data quality validation.

Plain copy of ``pde_tpu/data/validation.py`` (numpy only, no numerics on a
device): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference data/validation.py: OHLCV validators (price sanity,
OHLC consistency, staleness, outlier jumps; :110-417), options validators
(spread sanity, monotonicity-in-strike, put-call-parity style arbitrage
bounds; :418-700) and the composable DataValidationPipeline (:701-785).
Array checks are vectorized over whole frames.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "ValidationLevel",
    "DataIssue",
    "DataValidationResult",
    "MarketDataValidator",
    "OptionsDataValidator",
    "DataValidationPipeline",
]


class ValidationLevel(str, enum.Enum):
    INFO = "info"
    WARNING = "warning"
    ERROR = "error"


@dataclass
class DataIssue:
    check: str
    level: ValidationLevel
    message: str
    indices: List[int] = field(default_factory=list)


@dataclass
class DataValidationResult:
    passed: bool
    issues: List[DataIssue] = field(default_factory=list)
    n_records: int = 0
    n_flagged: int = 0

    @property
    def errors(self) -> List[DataIssue]:
        return [i for i in self.issues if i.level == ValidationLevel.ERROR]


class MarketDataValidator:
    """OHLCV sanity checks (data/validation.py:110-417)."""

    def __init__(
        self,
        max_price: float = 1e6,
        max_daily_move: float = 0.5,
        max_staleness_days: int = 5,
        min_volume: float = 0.0,
    ):
        self.max_price = max_price
        self.max_daily_move = max_daily_move
        self.max_staleness_days = max_staleness_days
        self.min_volume = min_volume

    def validate(self, bars: Dict[str, np.ndarray], as_of: Optional[datetime] = None) -> DataValidationResult:
        """bars: dict with 'close' and optional 'open'/'high'/'low'/'volume'/'time'."""
        issues: List[DataIssue] = []
        close = np.asarray(bars["close"], dtype=np.float64)
        n = len(close)

        bad_price = np.nonzero(~np.isfinite(close) | (close <= 0) | (close > self.max_price))[0]
        if bad_price.size:
            issues.append(
                DataIssue("price_sanity", ValidationLevel.ERROR,
                          f"{bad_price.size} non-positive/absurd closes", bad_price.tolist())
            )

        if all(k in bars for k in ("open", "high", "low")):
            o = np.asarray(bars["open"], dtype=np.float64)
            h = np.asarray(bars["high"], dtype=np.float64)
            low = np.asarray(bars["low"], dtype=np.float64)
            bad_ohlc = np.nonzero((h < low) | (h < np.maximum(o, close)) | (low > np.minimum(o, close)))[0]
            if bad_ohlc.size:
                issues.append(
                    DataIssue("ohlc_consistency", ValidationLevel.ERROR,
                              f"{bad_ohlc.size} bars with inconsistent OHLC", bad_ohlc.tolist())
                )

        if n > 1:
            rets = np.abs(np.diff(close) / close[:-1])
            jumps = np.nonzero(rets > self.max_daily_move)[0] + 1
            if jumps.size:
                issues.append(
                    DataIssue("outlier_jump", ValidationLevel.WARNING,
                              f"{jumps.size} moves > {self.max_daily_move:.0%}", jumps.tolist())
                )
            stale = np.nonzero(np.diff(close) == 0.0)[0]
            if stale.size > n * 0.5:
                issues.append(
                    DataIssue("stale_prices", ValidationLevel.WARNING,
                              f"{stale.size}/{n-1} unchanged closes")
                )

        if "time" in bars and len(bars["time"]):
            last = bars["time"][-1]
            if isinstance(last, str):
                last = datetime.fromisoformat(last)
            if last.tzinfo is None:
                last = last.replace(tzinfo=timezone.utc)
            now = as_of or datetime.now(timezone.utc)
            if now - last > timedelta(days=self.max_staleness_days):
                issues.append(
                    DataIssue("staleness", ValidationLevel.ERROR,
                              f"last bar {last.isoformat()} older than {self.max_staleness_days}d")
                )

        if "volume" in bars:
            vol = np.asarray(bars["volume"], dtype=np.float64)
            zero = np.nonzero(vol < self.min_volume)[0]
            if zero.size and self.min_volume > 0:
                issues.append(
                    DataIssue("volume_floor", ValidationLevel.WARNING,
                              f"{zero.size} bars below volume floor", zero.tolist())
                )

        flagged = {i for issue in issues for i in issue.indices}
        return DataValidationResult(
            passed=not any(i.level == ValidationLevel.ERROR for i in issues),
            issues=issues,
            n_records=n,
            n_flagged=len(flagged),
        )


class OptionsDataValidator:
    """Option-chain sanity + no-arbitrage checks (data/validation.py:418-700)."""

    def __init__(self, max_spread_pct: float = 0.5, max_iv: float = 5.0):
        self.max_spread_pct = max_spread_pct
        self.max_iv = max_iv

    def validate(self, chain: List[Dict[str, Any]]) -> DataValidationResult:
        issues: List[DataIssue] = []
        n = len(chain)
        if n == 0:
            return DataValidationResult(passed=True, n_records=0)

        bad_quote, wide, bad_iv = [], [], []
        for i, q in enumerate(chain):
            bid, ask = q.get("bid", 0.0) or 0.0, q.get("ask", 0.0) or 0.0
            if bid < 0 or ask < 0 or (bid > 0 and ask > 0 and bid > ask):
                bad_quote.append(i)
            mid = 0.5 * (bid + ask)
            if mid > 0 and (ask - bid) / mid > self.max_spread_pct:
                wide.append(i)
            iv = q.get("implied_vol")
            if iv is not None and not (0.0 < iv < self.max_iv):
                bad_iv.append(i)
        if bad_quote:
            issues.append(DataIssue("crossed_quotes", ValidationLevel.ERROR,
                                    f"{len(bad_quote)} crossed/negative quotes", bad_quote))
        if wide:
            issues.append(DataIssue("wide_spread", ValidationLevel.WARNING,
                                    f"{len(wide)} quotes wider than {self.max_spread_pct:.0%}", wide))
        if bad_iv:
            issues.append(DataIssue("iv_range", ValidationLevel.WARNING,
                                    f"{len(bad_iv)} IVs outside (0, {self.max_iv})", bad_iv))

        # monotonicity: call mids non-increasing in strike per expiry
        by_exp: Dict[Any, List[Dict]] = {}
        for q in chain:
            if str(q.get("option_type", "")).lower() == "call":
                by_exp.setdefault(q.get("expiration"), []).append(q)
        violations = 0
        for exp, quotes in by_exp.items():
            quotes = sorted(quotes, key=lambda q: q["strike"])
            mids = [0.5 * ((q.get("bid") or 0) + (q.get("ask") or 0)) for q in quotes]
            mids = [m for m in mids if m > 0]
            violations += int(np.sum(np.diff(mids) > 1e-9))
        if violations:
            issues.append(
                DataIssue("call_monotonicity", ValidationLevel.WARNING,
                          f"{violations} call-price increases in strike (arbitrage signal)")
            )

        flagged = {i for issue in issues for i in issue.indices}
        return DataValidationResult(
            passed=not any(i.level == ValidationLevel.ERROR for i in issues),
            issues=issues,
            n_records=n,
            n_flagged=len(flagged),
        )


class DataValidationPipeline:
    """Composable validator chain (data/validation.py:701-785)."""

    def __init__(self):
        self._validators: List[Callable[[Any], DataValidationResult]] = []

    def add(self, validator: Callable[[Any], DataValidationResult]) -> "DataValidationPipeline":
        self._validators.append(validator)
        return self

    def run(self, data) -> DataValidationResult:
        all_issues: List[DataIssue] = []
        n_records = 0
        n_flagged = 0
        for v in self._validators:
            res = v(data)
            all_issues.extend(res.issues)
            n_records = max(n_records, res.n_records)
            n_flagged += res.n_flagged
        return DataValidationResult(
            passed=not any(i.level == ValidationLevel.ERROR for i in all_issues),
            issues=all_issues,
            n_records=n_records,
            n_flagged=n_flagged,
        )
