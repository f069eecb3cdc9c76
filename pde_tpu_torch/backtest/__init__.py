"""Backtesting: the vectorized backtester, its strategy optimizers and the
walk-forward and Monte-Carlo analysis (the reference's event-driven engine,
portfolio, execution and sector modules are pure Python and are left out
of the port)."""

from . import (analysis, data_handler, events, metrics, multi_strategy,  # noqa: F401
               optimizer, strategy, vectorized)
from .data_handler import ArrayDataHandler, SyntheticDataHandler  # noqa: F401
