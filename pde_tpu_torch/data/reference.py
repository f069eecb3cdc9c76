"""Reference data: security master, corporate actions, trading calendar.

Plain copy of ``pde_tpu/data/reference.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference data/reference.py: the US-holiday TradingCalendar
(:154-374), split/dividend adjustment (:375-560), the security master and
the ReferenceDataManager facade (:561-739).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import date, timedelta
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "Security",
    "CorporateAction",
    "TradingCalendar",
    "adjust_for_splits",
    "adjust_for_dividends",
    "ReferenceDataManager",
]


@dataclass
class Security:
    symbol: str
    name: str = ""
    exchange: str = ""
    asset_type: str = "equity"
    sector: str = ""
    currency: str = "USD"
    active: bool = True
    metadata: Dict = field(default_factory=dict)


@dataclass
class CorporateAction:
    symbol: str
    action_type: str  # 'split' | 'dividend'
    ex_date: date
    # split: ratio (2.0 = 2-for-1); dividend: amount per share
    value: float = 0.0


def _nth_weekday(year: int, month: int, weekday: int, n: int) -> date:
    """n-th weekday (0=Mon) of a month; n=-1 for last."""
    if n > 0:
        d = date(year, month, 1)
        offset = (weekday - d.weekday()) % 7
        return d + timedelta(days=offset + 7 * (n - 1))
    d = date(year + (month == 12), (month % 12) + 1, 1) - timedelta(days=1)
    offset = (d.weekday() - weekday) % 7
    return d - timedelta(days=offset)


def _easter(year: int) -> date:
    """Anonymous Gregorian algorithm."""
    a = year % 19
    b, c = divmod(year, 100)
    d, e = divmod(b, 4)
    g = (8 * b + 13) // 25
    h = (19 * a + b - d - g + 15) % 30
    i, k = divmod(c, 4)
    l = (32 + 2 * e + 2 * i - h - k) % 7
    m = (a + 11 * h + 19 * l) // 433
    month = (h + l - 7 * m + 90) // 25
    day = (h + l - 7 * m + 33 * month + 19) % 32
    return date(year, month, day)


def _observed(d: date) -> date:
    if d.weekday() == 5:
        return d - timedelta(days=1)
    if d.weekday() == 6:
        return d + timedelta(days=1)
    return d


class TradingCalendar:
    """US equity-market calendar (data/reference.py:154-374)."""

    def __init__(self):
        self._holiday_cache: Dict[int, set] = {}

    def holidays(self, year: int) -> set:
        if year in self._holiday_cache:
            return self._holiday_cache[year]
        hs = {
            _observed(date(year, 1, 1)),  # New Year
            _nth_weekday(year, 1, 0, 3),  # MLK
            _nth_weekday(year, 2, 0, 3),  # Presidents' Day
            _easter(year) - timedelta(days=2),  # Good Friday
            _nth_weekday(year, 5, 0, -1),  # Memorial Day
            _observed(date(year, 7, 4)),  # Independence Day
            _nth_weekday(year, 9, 0, 1),  # Labor Day
            _nth_weekday(year, 11, 3, 4),  # Thanksgiving
            _observed(date(year, 12, 25)),  # Christmas
        }
        if year >= 2021:
            hs.add(_observed(date(year, 6, 19)))  # Juneteenth
        self._holiday_cache[year] = hs
        return hs

    def is_trading_day(self, d: date) -> bool:
        return d.weekday() < 5 and d not in self.holidays(d.year)

    def next_trading_day(self, d: date) -> date:
        nxt = d + timedelta(days=1)
        while not self.is_trading_day(nxt):
            nxt += timedelta(days=1)
        return nxt

    def previous_trading_day(self, d: date) -> date:
        prev = d - timedelta(days=1)
        while not self.is_trading_day(prev):
            prev -= timedelta(days=1)
        return prev

    def trading_days_between(self, start: date, end: date) -> List[date]:
        out = []
        d = start
        while d <= end:
            if self.is_trading_day(d):
                out.append(d)
            d += timedelta(days=1)
        return out


def adjust_for_splits(prices: np.ndarray, dates: List[date], actions: List[CorporateAction]) -> np.ndarray:
    """Back-adjust prices before each split ex-date (reference.py:375-470)."""
    adj = np.asarray(prices, dtype=np.float64).copy()
    for act in actions:
        if act.action_type != "split" or act.value <= 0:
            continue
        mask = np.array([d < act.ex_date for d in dates])
        adj[mask] /= act.value
    return adj


def adjust_for_dividends(prices: np.ndarray, dates: List[date], actions: List[CorporateAction]) -> np.ndarray:
    """Proportional back-adjustment at each dividend ex-date (reference.py:471-560)."""
    adj = np.asarray(prices, dtype=np.float64).copy()
    for act in sorted(
        (a for a in actions if a.action_type == "dividend"), key=lambda a: a.ex_date
    ):
        idx = next((i for i, d in enumerate(dates) if d >= act.ex_date), None)
        if idx is None or idx == 0:
            continue
        ref_price = adj[idx - 1]
        if ref_price > 0:
            factor = 1.0 - act.value / ref_price
            adj[:idx] *= factor
    return adj


class ReferenceDataManager:
    """Security master + actions + calendar facade (reference.py:561-739)."""

    def __init__(self):
        self.calendar = TradingCalendar()
        self._securities: Dict[str, Security] = {}
        self._actions: Dict[str, List[CorporateAction]] = {}
        self._indices: Dict[str, List[str]] = {}

    def add_security(self, security: Security) -> None:
        self._securities[security.symbol] = security

    def get_security(self, symbol: str) -> Optional[Security]:
        return self._securities.get(symbol)

    def list_securities(self, active_only: bool = True) -> List[Security]:
        return [s for s in self._securities.values() if s.active or not active_only]

    def add_corporate_action(self, action: CorporateAction) -> None:
        self._actions.setdefault(action.symbol, []).append(action)

    def get_corporate_actions(self, symbol: str) -> List[CorporateAction]:
        return list(self._actions.get(symbol, []))

    def adjusted_prices(self, symbol: str, prices: np.ndarray, dates: List[date]) -> np.ndarray:
        actions = self.get_corporate_actions(symbol)
        out = adjust_for_splits(prices, dates, actions)
        return adjust_for_dividends(out, dates, actions)

    def set_index_composition(self, index: str, members: List[str]) -> None:
        self._indices[index] = list(members)

    def get_index_composition(self, index: str) -> List[str]:
        return list(self._indices.get(index, []))
