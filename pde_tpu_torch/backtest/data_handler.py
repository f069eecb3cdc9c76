"""Bar feeds for the backtester: DataFrame / arrays / synthetic GBM (twin
of ``pde_tpu/backtest/data_handler.py``).

The DataHandler interface, an array handler, a historical DataFrame handler
(duck-typed: anything with ``columns``, ``index`` and per-column
``to_numpy``; pandas is not imported) and the seeded synthetic GBM
generator.  The GBM paths are drawn and compounded in one batched program
on ``device`` (the card unless the caller names another), from a
``torch.Generator`` seeded with ``seed`` there or from a draw source passed
as ``generator``; the bars are then served from the host.
"""

from __future__ import annotations

import abc
from datetime import datetime, timedelta
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.precision import blocked_cumsum, resolve_device
from ..models.heston_mc import _draws
from .events import MarketEvent

__all__ = ["DataHandler", "ArrayDataHandler", "HistoricDataFrameHandler", "SyntheticDataHandler"]


class DataHandler(abc.ABC):
    """Feed of MarketEvents, one bar at a time."""

    continue_backtest: bool = True

    @abc.abstractmethod
    def update_bars(self, events_queue) -> None:
        """Push the next bar's MarketEvents onto the queue."""

    @abc.abstractmethod
    def get_latest_price(self, symbol: str) -> Optional[float]:
        ...


class ArrayDataHandler(DataHandler):
    """Bars from plain arrays: {symbol: prices}, shared timestamps."""

    def __init__(self, prices: Dict[str, np.ndarray], timestamps: Optional[List[datetime]] = None):
        self.prices = {k: np.asarray(v, dtype=np.float64) for k, v in prices.items()}
        n = len(next(iter(self.prices.values())))
        for k, v in self.prices.items():
            if len(v) != n:
                raise ValueError(f"price series length mismatch for {k}")
        if timestamps is None:
            start = datetime(2020, 1, 1)
            timestamps = [start + timedelta(days=i) for i in range(n)]
        self.timestamps = timestamps
        self.n_bars = n
        self._i = 0
        self.continue_backtest = True
        self._latest: Dict[str, float] = {}

    def update_bars(self, events_queue) -> None:
        if self._i >= self.n_bars:
            self.continue_backtest = False
            return
        ts = self.timestamps[self._i]
        for symbol, series in self.prices.items():
            price = float(series[self._i])
            self._latest[symbol] = price
            events_queue.put(
                MarketEvent(event_type=None, timestamp=ts, symbol=symbol, price=price)
            )
        self._i += 1
        if self._i >= self.n_bars:
            self.continue_backtest = False

    def get_latest_price(self, symbol: str) -> Optional[float]:
        return self._latest.get(symbol)

    def reset(self) -> None:
        self._i = 0
        self.continue_backtest = True
        self._latest.clear()


class HistoricDataFrameHandler(ArrayDataHandler):
    """Bars from a DataFrame-like table with a datetime index and one
    column per symbol (close prices)."""

    def __init__(self, df):
        prices = {str(c): df[c].to_numpy(dtype=np.float64) for c in df.columns}
        timestamps = [ts.to_pydatetime() if hasattr(ts, "to_pydatetime") else ts for ts in df.index]
        super().__init__(prices, timestamps)


class SyntheticDataHandler(ArrayDataHandler):
    """Seeded GBM bars, drawn in one batched program on ``device``.

    S_{t+1} = S_t exp((mu - 0.5 sigma^2) dt + sigma sqrt(dt) Z)
    """

    def __init__(
        self,
        symbols: List[str],
        n_bars: int = 252,
        initial_price: float = 100.0,
        annual_drift: float = 0.05,
        annual_vol: float = 0.2,
        seed: int = 42,
        start_date: Optional[datetime] = None,
        device=None,
        generator=None,
    ):
        dev = resolve_device(device)
        draws = _draws(torch.Generator(device=dev).manual_seed(seed)
                       if generator is None else generator, dev)
        dt = 1.0 / 252.0
        z = draws.normal((len(symbols), n_bars - 1), torch.float64, dev)
        log_ret = (annual_drift - 0.5 * annual_vol**2) * dt + annual_vol * np.sqrt(dt) * z
        log_paths = torch.cat([torch.zeros_like(z[:, :1]), blocked_cumsum(log_ret)], dim=1)
        paths = (initial_price * torch.exp(log_paths)).cpu().numpy()

        start = start_date or datetime(2020, 1, 1)
        timestamps = [start + timedelta(days=i) for i in range(n_bars)]
        super().__init__(
            {s: paths[i] for i, s in enumerate(symbols)}, timestamps
        )
