"""Multi-strategy manager: blended sub-signals with per-symbol weights
(twin of ``pde_tpu/backtest/multi_strategy.py``).

One event-driven Strategy that combines momentum / MA-crossover /
mean-reversion / RSI / Bollinger sub-signals per symbol with configurable
weights, and a symbol -> optimal-strategy lookup fed by optimization
results.  Per bar the manager keeps a rolling window on the host and runs
the vectorized generators of ``optimizer.STRATEGY_FAMILIES`` on it on
``device`` (the card unless the caller names another), reading the five
latest positions back in one copy.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from ..core.precision import host_tensor
from .events import MarketEvent, SignalType
from .strategy import Strategy

__all__ = ["MultiStrategyManager", "get_optimal_strategy"]


# per-symbol optimal configuration produced by StrategyOptimizer runs; the
# reference hardcodes a large lookup (multi_strategy.py:436-438 +
# sector_portfolio maps).  Populate via set_optimization_results.
_OPTIMAL: Dict[str, Dict] = {}


def get_optimal_strategy(symbol: str) -> Dict:
    """Best-known strategy config for a symbol (default: momentum)."""
    return _OPTIMAL.get(
        symbol.upper(), {"strategy": "momentum", "params": {"lookback": 60, "holding": 20}}
    )


class MultiStrategyManager(Strategy):
    """Weighted voting across five sub-strategies per symbol."""

    DEFAULT_WEIGHTS = {
        "momentum": 1.0,
        "ma_crossover": 1.0,
        "mean_reversion": 1.0,
        "rsi": 0.5,
        "bollinger": 0.5,
    }

    def __init__(
        self,
        symbols,
        weights: Optional[Dict[str, float]] = None,
        window: int = 120,
        vote_threshold: float = 0.25,
        strategy_id: str = "",
        device=None,
    ):
        super().__init__(symbols, strategy_id or "multi")
        self.weights = dict(weights or self.DEFAULT_WEIGHTS)
        self.window = window
        self.vote_threshold = vote_threshold
        self._prices: Dict[str, deque] = {s: deque(maxlen=window) for s in self.symbols}
        self._state: Dict[str, int] = {s: 0 for s in self.symbols}
        self.device = device

    @classmethod
    def set_optimization_results(cls, results: Dict[str, Dict]) -> None:
        """Install per-symbol optimal configs from a StrategyOptimizer run."""
        _OPTIMAL.update({k.upper(): v for k, v in results.items()})

    # ----------------------------------------------------------- sub-signals

    # the sub-signal parameters of the vote
    _CONFIGS = {
        "momentum": {"lookback": 60, "holding": 10},
        "ma_crossover": {"short": 10, "long": 50},
        "mean_reversion": {"lookback": 20, "entry_z": 2.0, "exit_z": 0.5},
        "rsi": {"period": 14, "oversold": 30.0, "overbought": 70.0},
        "bollinger": {"window": 20, "n_std": 2.0},
    }

    def _sub_signals(self, prices: np.ndarray) -> Dict[str, float]:
        """Latest -1/0/+1 from each family on the rolling window.

        The window is padded to a FIXED length (self.window) with its first
        price, as the reference pads it (the padding enters the signals)."""
        from .optimizer import STRATEGY_FAMILIES

        fixed = np.empty(self.window, dtype=np.float64)
        n = len(prices)
        if n >= self.window:
            fixed[:] = prices[-self.window:]
        else:
            fixed[: self.window - n] = prices[0]
            fixed[self.window - n:] = prices

        active = [n_ for n_ in self._CONFIGS if n_ in self.weights]
        p = host_tensor(fixed, self.device)
        last = torch.stack([STRATEGY_FAMILIES[n_]["fn"](p, **self._CONFIGS[n_])[-1]
                            for n_ in active]).cpu().numpy()
        return dict(zip(active, map(float, last)))

    def vote(self, prices: np.ndarray) -> float:
        """Weighted average sub-signal in [-1, 1]."""
        subs = self._sub_signals(np.asarray(prices, dtype=np.float64))
        total_w = sum(self.weights[n] for n in subs)
        if total_w == 0:
            return 0.0
        return sum(self.weights[n] * v for n, v in subs.items()) / total_w

    # -------------------------------------------------------------- events

    def calculate_signals(self, event: MarketEvent, events_queue) -> None:
        s = event.symbol
        if s not in self._prices:
            return
        self._prices[s].append(event.price)
        if len(self._prices[s]) < 60:
            return
        score = self.vote(np.asarray(self._prices[s]))
        state = self._state[s]
        if score > self.vote_threshold and state <= 0:
            self._state[s] = 1
            self._emit(events_queue, event, SignalType.LONG, strength=min(abs(score), 1.0))
        elif score < -self.vote_threshold and state >= 0:
            self._state[s] = -1
            self._emit(events_queue, event, SignalType.SHORT, strength=min(abs(score), 1.0))
        elif abs(score) <= self.vote_threshold / 2 and state != 0:
            self._state[s] = 0
            self._emit(events_queue, event, SignalType.EXIT)
