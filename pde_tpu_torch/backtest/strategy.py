"""Backtest strategies: buy&hold, MA crossover, z-score mean reversion,
momentum (plain copy of ``pde_tpu/backtest/strategy.py``).

Each strategy consumes MarketEvents and emits SignalEvents on the host, and
exposes a numpy ``signal_array(prices)`` static method: the whole signal
series in one call, the event loop's own arithmetic, against which the
vectorized generators of :mod:`pde_tpu_torch.backtest.vectorized` are held.
"""

from __future__ import annotations

import abc
from collections import deque
from typing import Dict, Optional

import numpy as np

from .events import MarketEvent, SignalEvent, SignalType

__all__ = [
    "Strategy",
    "BuyAndHoldStrategy",
    "MovingAverageCrossStrategy",
    "MeanReversionStrategy",
    "MomentumStrategy",
]


class Strategy(abc.ABC):
    """Event-driven strategy interface (strategy.py:32-127)."""

    def __init__(self, symbols, strategy_id: str = ""):
        self.symbols = list(symbols)
        self.strategy_id = strategy_id or type(self).__name__

    @abc.abstractmethod
    def calculate_signals(self, event: MarketEvent, events_queue) -> None:
        ...

    def _emit(self, events_queue, event: MarketEvent, signal_type: SignalType, strength=1.0):
        events_queue.put(
            SignalEvent(
                event_type=None,
                timestamp=event.timestamp,
                symbol=event.symbol,
                signal_type=signal_type,
                strength=strength,
                strategy_id=self.strategy_id,
            )
        )


class BuyAndHoldStrategy(Strategy):
    """LONG once per symbol on the first bar (strategy.py:128-162)."""

    def __init__(self, symbols, strategy_id: str = ""):
        super().__init__(symbols, strategy_id)
        self._bought: Dict[str, bool] = {}

    def calculate_signals(self, event, events_queue):
        if event.symbol in self.symbols and not self._bought.get(event.symbol):
            self._bought[event.symbol] = True
            self._emit(events_queue, event, SignalType.LONG)

    @staticmethod
    def signal_array(prices: np.ndarray) -> np.ndarray:
        sig = np.ones(len(prices))
        return sig


class MovingAverageCrossStrategy(Strategy):
    """Golden/death cross of short/long SMAs (strategy.py:163-258)."""

    def __init__(self, symbols, short_window: int = 20, long_window: int = 50, strategy_id=""):
        super().__init__(symbols, strategy_id)
        if short_window >= long_window:
            raise ValueError("short_window must be < long_window")
        self.short_window = short_window
        self.long_window = long_window
        self._prices: Dict[str, deque] = {s: deque(maxlen=long_window) for s in self.symbols}
        self._state: Dict[str, int] = {s: 0 for s in self.symbols}

    def calculate_signals(self, event, events_queue):
        s = event.symbol
        if s not in self._prices:
            return
        self._prices[s].append(event.price)
        if len(self._prices[s]) < self.long_window:
            return
        arr = np.asarray(self._prices[s])
        short_ma = arr[-self.short_window :].mean()
        long_ma = arr.mean()
        if short_ma > long_ma and self._state[s] <= 0:
            self._state[s] = 1
            self._emit(events_queue, event, SignalType.LONG)
        elif short_ma < long_ma and self._state[s] >= 0:
            self._state[s] = -1
            self._emit(events_queue, event, SignalType.SHORT)

    @staticmethod
    def signal_array(prices: np.ndarray, short_window: int = 20, long_window: int = 50) -> np.ndarray:
        """Vectorized +1/-1/0 position series."""
        p = np.asarray(prices, dtype=np.float64)
        kernel_s = np.ones(short_window) / short_window
        kernel_l = np.ones(long_window) / long_window
        short_ma = np.convolve(p, kernel_s, mode="full")[: len(p)]
        long_ma = np.convolve(p, kernel_l, mode="full")[: len(p)]
        sig = np.where(short_ma > long_ma, 1.0, -1.0)
        sig[: long_window - 1] = 0.0
        return sig


class MeanReversionStrategy(Strategy):
    """Z-score entry/exit bands (strategy.py:259-373)."""

    def __init__(
        self,
        symbols,
        lookback: int = 20,
        entry_z: float = 2.0,
        exit_z: float = 0.5,
        strategy_id="",
    ):
        super().__init__(symbols, strategy_id)
        self.lookback = lookback
        self.entry_z = entry_z
        self.exit_z = exit_z
        self._prices: Dict[str, deque] = {s: deque(maxlen=lookback) for s in self.symbols}
        self._state: Dict[str, int] = {s: 0 for s in self.symbols}

    def _zscore(self, symbol: str) -> Optional[float]:
        arr = np.asarray(self._prices[symbol])
        if len(arr) < self.lookback:
            return None
        std = arr.std(ddof=1)
        if std <= 0:
            return None
        return (arr[-1] - arr.mean()) / std

    def calculate_signals(self, event, events_queue):
        s = event.symbol
        if s not in self._prices:
            return
        self._prices[s].append(event.price)
        z = self._zscore(s)
        if z is None:
            return
        state = self._state[s]
        if state == 0:
            if z < -self.entry_z:
                self._state[s] = 1
                self._emit(events_queue, event, SignalType.LONG)
            elif z > self.entry_z:
                self._state[s] = -1
                self._emit(events_queue, event, SignalType.SHORT)
        elif state == 1 and z >= -self.exit_z:
            self._state[s] = 0
            self._emit(events_queue, event, SignalType.EXIT_LONG)
        elif state == -1 and z <= self.exit_z:
            self._state[s] = 0
            self._emit(events_queue, event, SignalType.EXIT_SHORT)

    @staticmethod
    def signal_array(prices, lookback: int = 20, entry_z: float = 2.0, exit_z: float = 0.5):
        p = np.asarray(prices, dtype=np.float64)
        n = len(p)
        sig = np.zeros(n)
        state = 0
        # rolling mean/std via cumulative sums
        for i in range(lookback - 1, n):
            window = p[i - lookback + 1 : i + 1]
            std = window.std(ddof=1)
            z = (p[i] - window.mean()) / std if std > 0 else 0.0
            if state == 0:
                if z < -entry_z:
                    state = 1
                elif z > entry_z:
                    state = -1
            elif state == 1 and z >= -exit_z:
                state = 0
            elif state == -1 and z <= exit_z:
                state = 0
            sig[i] = state
        return sig


class MomentumStrategy(Strategy):
    """Trailing-return momentum with rebalance interval (strategy.py:374-451)."""

    def __init__(self, symbols, lookback: int = 60, holding_period: int = 20, strategy_id=""):
        super().__init__(symbols, strategy_id)
        self.lookback = lookback
        self.holding_period = holding_period
        self._prices: Dict[str, deque] = {s: deque(maxlen=lookback + 1) for s in self.symbols}
        self._bars_since: Dict[str, int] = {s: 0 for s in self.symbols}
        self._state: Dict[str, int] = {s: 0 for s in self.symbols}

    def calculate_signals(self, event, events_queue):
        s = event.symbol
        if s not in self._prices:
            return
        self._prices[s].append(event.price)
        self._bars_since[s] += 1
        arr = np.asarray(self._prices[s])
        if len(arr) <= self.lookback or self._bars_since[s] < self.holding_period:
            return
        self._bars_since[s] = 0
        momentum = arr[-1] / arr[0] - 1.0
        if momentum > 0 and self._state[s] <= 0:
            self._state[s] = 1
            self._emit(events_queue, event, SignalType.LONG)
        elif momentum < 0 and self._state[s] >= 0:
            self._state[s] = -1
            self._emit(events_queue, event, SignalType.SHORT)

    @staticmethod
    def signal_array(prices, lookback: int = 60, holding_period: int = 20):
        p = np.asarray(prices, dtype=np.float64)
        n = len(p)
        sig = np.zeros(n)
        state = 0
        next_rebalance = lookback
        for i in range(lookback, n):
            if i >= next_rebalance:
                momentum = p[i] / p[i - lookback] - 1.0
                state = 1 if momentum > 0 else -1
                next_rebalance = i + holding_period
            sig[i] = state
        return sig
