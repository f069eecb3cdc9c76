"""Backtesting: the event-driven engine, the vectorized backtester, its
strategy optimizers, sectors, and the walk-forward and Monte-Carlo
analysis."""

from . import (analysis, data_handler, engine, events, execution, metrics,  # noqa: F401
               multi_strategy, optimizer, portfolio, sectors, strategy, vectorized)
from .data_handler import ArrayDataHandler, SyntheticDataHandler  # noqa: F401
from .engine import BacktestEngine, BacktestResults  # noqa: F401
from .portfolio import Portfolio  # noqa: F401
