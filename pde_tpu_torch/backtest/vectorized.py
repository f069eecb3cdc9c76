"""Vectorized array backtester (twin of ``pde_tpu/backtest/vectorized.py``).

A backtest is an array program:

    position_t (from a signal array) ->
    r_t = position_{t-1} * (p_t / p_{t-1} - 1) - cost_per_turnover * |dpos_t|

Every function takes prices of shape (..., n) and broadcasts its window and
threshold parameters (numbers or tensors) against the leading axes, so one
call evaluates a family's whole grid over many symbols: prices (S, 1, n)
with (G,) parameter tensors give (S, G, n) positions.  They compute on the
prices' device (the card for host arrays, unless ``device`` names another)
in the prices' own precision.

The reference walks its strategy state machines bar by bar (``lax.scan``);
here every walk takes log depth and no Python loop runs over the bars:

* the momentum rebalance walk and the RSI band walk are forward fills: the
  last bar at which the state was set is ``torch.cummax`` of its index;
* the z-score and Bollinger walks are 3-state machines: each bar maps
  {-1, 0, +1} to itself, and the maps compose exactly as small integer
  tables, by doubling (ceil(log2 n) rounds of one gather);
* RSI's EMAs are a linear recursion, a log-depth scan of affine maps.

Prefix sums and products round as the reference's compiled ones do on the
CPU (:func:`~pde_tpu_torch.core.precision.blocked_cumsum`), by elementwise
operations alone, so float64 positions are the reference's bit for bit and
the card's are the CPU's.  The moving statistics keep the reference's
cumulative-sum differences: at 2,520 bars their cancellation needs float64.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..core.precision import blocked_cumprod, blocked_cumsum, host_tensor

__all__ = [
    "equity_from_positions",
    "backtest_positions",
    "ma_cross_positions",
    "zscore_positions",
    "momentum_positions",
    "grid_backtest_ma",
]

# the metrics of :func:`backtest_positions`, in the order the batched
# helpers below hand them to the host
METRICS = ("total_return", "annualized_return", "sharpe", "max_drawdown", "final_equity")


def _prices(prices, device=None) -> torch.Tensor:
    """Prices as a floating tensor: a tensor stays where it is, a host
    array goes to ``device`` (the card for None) in its own precision."""
    if isinstance(prices, torch.Tensor):
        return prices if prices.is_floating_point() else prices.to(torch.get_default_dtype())
    return host_tensor(prices, device)


def _window(w, like: torch.Tensor) -> torch.Tensor:
    """An integer window (number or tensor) as an int64 tensor on ``like``'s device."""
    return torch.as_tensor(w, device=like.device).long()


def _level(x, like: torch.Tensor) -> torch.Tensor:
    """A threshold (number or tensor) in ``like``'s precision and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _col(t: torch.Tensor) -> torch.Tensor:
    """A parameter of the leading axes as a column against the bars."""
    return t[..., None]


def _gather_lagged(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` with ``idx`` of shape (..., n) broadcast against x."""
    shape = torch.broadcast_shapes(x.shape[:-1], idx.shape[:-1]) + (idx.shape[-1],)
    return torch.gather(x.expand(*shape[:-1], x.shape[-1]), -1, idx.expand(shape))


def _forward_fill(is_set: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` at the last bar up to each bar where ``is_set``, else 0: a
    walk that holds its state until a bar sets it."""
    shape = torch.broadcast_shapes(is_set.shape, value.shape)
    idx = torch.arange(shape[-1], device=value.device)
    last = torch.cummax(torch.where(is_set.expand(shape), idx, -1), dim=-1).values
    held = torch.gather(value.expand(shape), -1, last.clamp_min(0))
    return torch.where(last >= 0, held, torch.zeros_like(held))


def _walk3(step: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """Positions of a walk over the states {-1, 0, +1} from state 0.

    ``step(s)`` gives, for every bar, the state after the bar from state
    ``s`` before it.  Each bar's map is a table of three state indices;
    composing the tables by doubling (Hillis-Steele, one gather a round)
    gives every prefix of maps in ceil(log2 n) rounds, exactly."""
    table = torch.stack([step(s) for s in (-1, 0, 1)], -1).long() + 1   # (..., n, 3)
    n, shift = table.shape[-2], 1
    while shift < n:
        # bar i's map after bar i - shift's: table_i[table_{i - shift}[s]]
        later = torch.gather(table[..., shift:, :], -1, table[..., :-shift, :])
        table = torch.cat([table[..., :shift, :], later], -2)
        shift *= 2
    return table[..., 1] - 1


def _affine_scan(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """s_t = a s_{t-1} + b_t from s_{-1} = 0 over the last axis, as a
    log-depth scan: each round adds the partial sums ``shift`` bars back
    times a^shift (powers by squaring; no a^-k weights to overflow)."""
    y, shift, a_pow = b, 1, a
    while shift < y.shape[-1]:
        y = torch.cat([y[..., :shift], y[..., shift:] + a_pow * y[..., :-shift]], -1)
        shift, a_pow = 2 * shift, a_pow * a_pow
    return y


def equity_from_positions(prices, positions, cost_per_turnover: float = 0.0, device=None):
    """Per-bar strategy returns from a position series.

    positions[..., t] is the position HELD FROM bar t to t+1 (signal known
    at t).  Returns (returns, equity) with equity normalized to 1.0.
    """
    prices = _prices(prices, device)
    positions = torch.as_tensor(positions, dtype=prices.dtype, device=prices.device)
    asset_ret = prices[..., 1:] / prices[..., :-1] - 1.0
    strat_ret = positions[..., :-1] * asset_ret
    turnover = torch.abs(torch.diff(positions, prepend=torch.zeros_like(positions[..., :1])))
    strat_ret = strat_ret - cost_per_turnover * turnover[..., :-1]
    start = strat_ret.new_ones(strat_ret.shape[:-1] + (1,))
    equity = torch.cat([start, blocked_cumprod(1.0 + strat_ret)], -1)
    return strat_ret, equity


def backtest_positions(prices, positions, cost_per_turnover: float = 0.0,
                       device=None) -> Dict[str, torch.Tensor]:
    """Scalar metrics for each (prices, positions) pair of the leading axes."""
    ret, equity = equity_from_positions(prices, positions, cost_per_turnover, device)
    n = ret.shape[-1]
    ann = 252.0
    mean = torch.mean(ret, dim=-1)
    std = torch.std(ret, dim=-1, correction=0)
    sharpe = torch.where(std > 0, mean / std * math.sqrt(ann), torch.zeros_like(std))
    peak = torch.cummax(equity, dim=-1).values
    max_dd = torch.amax(1.0 - equity / peak, dim=-1)
    total = equity[..., -1] - 1.0
    return {
        "total_return": total,
        "annualized_return": (1.0 + total) ** (ann / max(n, 1)) - 1.0,
        "sharpe": sharpe,
        "max_drawdown": max_dd,
        "final_equity": equity[..., -1],
    }


def _moving_average(p: torch.Tensor, window: torch.Tensor, csum=None) -> torch.Tensor:
    """Trailing SMA by cumulative sums (``window`` broadcast against the
    leading axes); the first window-1 entries use the expanding mean."""
    csum = blocked_cumsum(p) if csum is None else csum
    idx = torch.arange(p.shape[-1], device=p.device)
    w = _col(window)
    lagged = _gather_lagged(csum, (idx - w).clamp_min(0))
    wsum = csum - torch.where(idx >= w, lagged, torch.zeros_like(lagged))
    count = torch.minimum(idx + 1, w)
    return wsum / count


def ma_cross_positions(prices, short_window, long_window, device=None):
    """+1/-1 position from an SMA crossover, 0 during warmup."""
    p = _prices(prices, device)
    short_w, long_w = _window(short_window, p), _window(long_window, p)
    csum = blocked_cumsum(p)
    short = _moving_average(p, short_w, csum)
    long_ = _moving_average(p, long_w, csum)
    sig = torch.where(short > long_, 1.0, -1.0).to(p.dtype)
    warm = torch.arange(p.shape[-1], device=p.device) < _col(long_w) - 1
    return torch.where(warm, torch.zeros_like(sig), sig)


def zscore_positions(prices, lookback, entry_z, exit_z, device=None):
    """Stateful z-score band walk (strategy.py's MeanReversionStrategy)."""
    p = _prices(prices, device)
    n = p.shape[-1]
    lb = _window(lookback, p)
    entry, exit_ = _col(_level(entry_z, p)), _col(_level(exit_z, p))
    mean = _moving_average(p, lb)
    # rolling second moment for std
    p2_mean = _moving_average(p * p, lb)
    var = torch.clamp_min(p2_mean - mean * mean, 0.0)
    # ddof correction approximating the event-driven implementation
    idx = torch.arange(n, device=p.device)
    count = torch.minimum(idx + 1, _col(lb))
    std = torch.sqrt(var * count / torch.clamp_min(count - 1, 1))
    pos_std = std > 0
    z = torch.where(pos_std, (p - mean) / torch.where(pos_std, std, torch.ones_like(std)),
                    torch.zeros_like(std))
    z = torch.where(idx < _col(lb) - 1, torch.zeros_like(z), z)

    def step(state):
        if state == 0:
            new = torch.where(z < -entry, 1, 0)
            return torch.where(z > entry, -1, new)
        if state == 1:
            return torch.where(z >= -exit_, 0, 1)
        return torch.where(z <= exit_, 0, -1)

    return _walk3(step).to(p.dtype)


def momentum_positions(prices, lookback, holding_period, device=None):
    """Rebalance every holding_period bars on trailing-return sign."""
    p = _prices(prices, device)
    idx = torch.arange(p.shape[-1], device=p.device)
    lb, hold = _col(_window(lookback, p)), _col(_window(holding_period, p))
    back = _gather_lagged(p, (idx - lb).clamp_min(0))
    mom = torch.where(idx >= lb, p / back - 1.0, torch.zeros_like(back))
    rebalance = (idx >= lb) & (torch.remainder(idx - lb, hold) == 0)
    return _forward_fill(rebalance, torch.where(mom > 0, 1.0, -1.0).to(p.dtype))


def grid_backtest_ma(prices, short_windows, long_windows, cost_per_turnover: float = 0.0005,
                     device=None):
    """Backtest an entire MA-crossover parameter grid in one batched call.

    short_windows/long_windows: (G,) integer arrays (pairs), entering as
    data against the bar index."""
    p = _prices(prices, device)
    shorts, longs = _window(short_windows, p), _window(long_windows, p)
    out = backtest_positions(p, ma_cross_positions(p, shorts, longs), cost_per_turnover)
    return {k: out[k] for k in ("sharpe", "total_return", "max_drawdown")}


# -- batched evaluation over many windows -----------------------------------

def _by_length(rows: Sequence[np.ndarray]) -> Dict[int, List[int]]:
    """Row indices grouped by row length, in first-seen order."""
    groups: Dict[int, List[int]] = {}
    for i, r in enumerate(rows):
        groups.setdefault(len(r), []).append(i)
    return groups


def _param_column(values, like: torch.Tensor) -> torch.Tensor:
    """Grid values as one tensor: integers as int64 (windows), anything
    else in the prices' precision (thresholds)."""
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in values):
        return torch.tensor([int(v) for v in values], dtype=torch.int64, device=like.device)
    return torch.tensor([float(v) for v in values], dtype=like.dtype, device=like.device)


def _stack(rows, members, device) -> torch.Tensor:
    return host_tensor(np.stack([np.asarray(rows[i], dtype=np.float64) for i in members]), device)


def _grid_metrics(fn, rows, grid: List[Dict], cost: float, device=None) -> np.ndarray:
    """:func:`backtest_positions` of ``fn``'s positions on every row for
    every grid point, as a (len(rows), len(grid), len(METRICS)) host array:
    one batched call of ``fn`` (prices (B, 1, n), each parameter a (G,)
    tensor) and one copy per distinct row length."""
    out = np.empty((len(rows), len(grid), len(METRICS)))
    keys = list(grid[0]) if grid else []
    for members in _by_length(rows).values():
        p = _stack(rows, members, device)[:, None, :]
        params = {k: _param_column([g[k] for g in grid], p) for k in keys}
        m = backtest_positions(p, fn(p, **params), cost)
        out[members] = torch.stack([m[k] for k in METRICS], -1).cpu().numpy()
    return out


def _positions(fn, rows, params: List[Dict], device=None) -> List[np.ndarray]:
    """``fn``'s positions on row i under ``params[i]``, on the host: one
    batched call (each parameter a tensor over the rows) and one copy per
    distinct row length."""
    out: List[np.ndarray] = [None] * len(rows)
    keys = list(params[0]) if params else []
    for members in _by_length(rows).values():
        p = _stack(rows, members, device)
        cols = {k: _param_column([params[i][k] for i in members], p) for k in keys}
        pos = fn(p, **cols).expand(p.shape).cpu().numpy()
        for j, i in enumerate(members):
            out[i] = pos[j]
    return out


def _metrics_rows(price_rows, pos_rows, cost: float, device=None) -> np.ndarray:
    """:func:`backtest_positions` of each (prices, positions) pair as a
    (len(rows), len(METRICS)) host array, one batched call and one copy per
    distinct row length."""
    out = np.empty((len(price_rows), len(METRICS)))
    for members in _by_length(price_rows).values():
        p = _stack(price_rows, members, device)
        pos = _stack(pos_rows, members, p.device).to(p.dtype)
        m = backtest_positions(p, pos, cost)
        out[members] = torch.stack([m[k] for k in METRICS], -1).cpu().numpy()
    return out
