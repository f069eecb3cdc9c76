"""The C++ host runtime (twin of ``pde_tpu/native``): stream aggregation,
the position backtest loop, the order-stream fill engine, float64 oracles
of the device solvers and pricers, and the HJB marches.

These are host functions: ``src/cpp/pde_host.cpp`` and ``pde_solvers.cpp``
run them in float64 on the CPU.  The wrappers take and return numpy
arrays, with the reference's signatures; :mod:`.loader` builds the library
at first use and raises :class:`NativeUnavailable` when it cannot.  A
tensor argument must be a CPU tensor, and a floating one float64: a tensor
on the card or in float32 raises ``ValueError`` instead of being copied to
the host or widened without a word.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from .loader import NativeUnavailable, build, is_available, load

__all__ = [
    "is_available",
    "build",
    "load",
    "NativeUnavailable",
    "aggregate_bars",
    "run_position_backtest",
    "thomas_solve",
    "ou_mle",
    "zscore_positions",
    "heston_price_batch",
    "sabr_vols",
    "bs_pde_solve",
    "heston_adi_solve",
    "hjb_march",
    "hjb_march_bs",
    "hjb_march_bs_multi",
    "simulate_fills",
    "bs_implied_vol",
]


def _c(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _host(fn):
    """Refuse a tensor argument on a device other than the CPU, or a
    floating tensor in another dtype than float64."""

    def check(name, a):
        if isinstance(a, torch.Tensor) and (
                a.device.type != "cpu" or (a.is_floating_point() and a.dtype != torch.float64)):
            raise ValueError(f"native.{fn.__name__} runs on the host in float64: argument "
                             f"{name!r} is a {a.dtype} tensor on {a.device}; pass a float64 "
                             "CPU tensor or a numpy array")
        if isinstance(a, (list, tuple)):
            for item in a:
                check(name, item)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        for i, a in enumerate(args):
            check(i, a)
        for k, a in kwargs.items():
            check(k, a)
        return fn(*args, **kwargs)

    return wrapper


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


@_host
def aggregate_bars(times, prices, sizes, bar_seconds: float) -> np.ndarray:
    """Ticks -> (n_bars, 6) [start, open, high, low, close, volume]."""
    lib = load()
    times, prices, sizes = _f64(times), _f64(prices), _f64(sizes)
    n = len(times)
    out = np.zeros((n, 6), dtype=np.float64)  # upper bound: one bar per tick
    n_bars = lib.aggregate_bars(_c(times), _c(prices), _c(sizes), n, bar_seconds, _c(out), n)
    return out[:n_bars].copy()


@_host
def run_position_backtest(prices, positions, cost_per_turnover: float = 0.0) -> Dict:
    """Host twin of ``backtest.vectorized.equity_from_positions`` and its
    statistics."""
    lib = load()
    prices, positions = _f64(prices), _f64(positions)
    n = len(prices)
    returns = np.zeros(n - 1, dtype=np.float64)
    equity = np.zeros(n, dtype=np.float64)
    stats = np.zeros(4, dtype=np.float64)
    lib.run_position_backtest(_c(prices), _c(positions), n, cost_per_turnover,
                              _c(returns), _c(equity), _c(stats))
    return {
        "returns": returns,
        "equity": equity,
        "total_return": float(stats[0]),
        "sharpe": float(stats[1]),
        "max_drawdown": float(stats[2]),
        "n_trades": int(stats[3]),
    }


@_host
def thomas_solve(lower, diag, upper, rhs) -> np.ndarray:
    """Batched float64 Thomas solve; shapes (B, n-1), (B, n), (B, n-1), (B, n)."""
    lib = load()
    lower, diag, upper, rhs = (_f64(a) for a in (lower, diag, upper, rhs))
    if diag.ndim == 1:
        lower, diag, upper, rhs = (a[None, :] for a in (lower, diag, upper, rhs))
    batch, n = diag.shape
    out = np.zeros((batch, n), dtype=np.float64)
    work = np.zeros(2 * n, dtype=np.float64)
    lib.thomas_solve(_c(lower), _c(diag), _c(upper), _c(rhs), n, batch, _c(out), _c(work))
    return out if out.shape[0] > 1 else out[0]


@_host
def ou_mle(x, dt: float) -> Tuple[float, float, float]:
    """(theta, mu, sigma): the float64 oracle of ``models.ou.fit_mle``."""
    lib = load()
    x = _f64(x)
    out = np.zeros(3, dtype=np.float64)
    lib.ou_mle(_c(x), len(x), dt, _c(out))
    return float(out[0]), float(out[1]), float(out[2])


@_host
def zscore_positions(prices, lookback: int, entry_z: float, exit_z: float) -> np.ndarray:
    """The z-score band positions of ``MeanReversionStrategy.signal_array``."""
    lib = load()
    prices = _f64(prices)
    out = np.zeros(len(prices), dtype=np.float64)
    lib.zscore_positions(_c(prices), len(prices), lookback, entry_z, exit_z, _c(out))
    return out


@_host
def heston_price_batch(kappa, theta, sigma, rho, v0, spot, r, q,
                       strikes, maturities, is_call,
                       n_points: int = 1024, du: float = 0.01,
                       alpha: float = 0.75) -> np.ndarray:
    """Float64 Carr-Madan oracle of ``models.heston.price_carr_madan``: the
    scalar loop a option of the C++ reference."""
    lib = load()
    strikes = _f64(strikes)
    n = len(strikes)
    maturities = _f64(np.broadcast_to(np.asarray(maturities, dtype=np.float64), (n,)))
    is_call = _f64(np.broadcast_to(np.asarray(is_call, dtype=np.float64), (n,)))
    out = np.zeros(n, dtype=np.float64)
    lib.heston_price_batch(kappa, theta, sigma, rho, v0, spot, r, q,
                           _c(strikes), _c(maturities), _c(is_call), n,
                           n_points, du, alpha, _c(out))
    return out


@_host
def sabr_vols(alpha, beta, rho, nu, forward, maturity, strikes) -> np.ndarray:
    """Float64 Hagan-smile oracle of ``models.sabr.implied_volatilities``."""
    lib = load()
    strikes = _f64(strikes)
    out = np.zeros(len(strikes), dtype=np.float64)
    lib.sabr_vols(alpha, beta, rho, nu, forward, maturity, _c(strikes), len(strikes), _c(out))
    return out


@_host
def bs_implied_vol(target, spot, strike, r, q, maturity, is_call, *,
                   vol0: float = 0.0, max_iter: int = 100,
                   tol: float = 1e-8) -> np.ndarray:
    """Float64 Newton implied-vol oracle of ``models.black_scholes.implied_vol``;
    ``vol0 <= 0`` starts from the Brenner-Subrahmanyam guess."""
    lib = load()
    n = len(np.atleast_1d(np.asarray(strike)))
    target, spot, strike, maturity, is_call = (
        _f64(np.broadcast_to(np.asarray(a, dtype=np.float64), (n,)))
        for a in (target, spot, strike, maturity, is_call))
    out = np.zeros(n, dtype=np.float64)
    lib.bs_implied_vol(_c(target), _c(spot), _c(strike), r, q, _c(maturity),
                       _c(is_call), n, vol0, max_iter, tol, _c(out))
    return out


@_host
def simulate_fills(tick_times, tick_prices, submit_times, sides, types,
                   limit_prices, stop_prices, quantities, *,
                   slippage_pct: float = 0.0005,
                   market_impact_coeff: float = 0.1,
                   adv: float = 1e6):
    """Order-stream fill engine (the semantics of
    ``backtest.execution.SimulatedExecutionHandler``).

    ``sides``: +1 buy / -1 sell.  ``types``: 0 market, 1 limit, 2 stop.
    Orders are sorted by submit time and rest until marketable; one
    submitted before the first positive price rests until one appears
    instead of being dropped.  Returns ``(n_filled, fills)``, ``fills``
    (n_orders, 4) rows of [fill_time, fill_price, commission, slippage]
    (NaN rows: never filled).
    """
    lib = load()
    tick_times, tick_prices = _f64(tick_times), _f64(tick_prices)
    n_orders = len(submit_times)
    arrs = [_f64(a) for a in (submit_times, sides, types, limit_prices, stop_prices,
                              quantities)]
    out = np.zeros((n_orders, 4), dtype=np.float64)
    n_filled = lib.simulate_fills(
        _c(tick_times), _c(tick_prices), len(tick_times),
        *(_c(a) for a in arrs), n_orders,
        slippage_pct, market_impact_coeff, adv, _c(out))
    return int(n_filled), out


@_host
def bs_pde_solve(S0, sigma, r, q, T, K, *, is_call=True, american=False,
                 n_space: int = 200, n_time: int = 100,
                 s_min_mult: float = 0.2, s_max_mult: float = 5.0,
                 crank_nicolson: bool = True):
    """Float64 log-space CN oracle of ``solvers.bs_pde.solve``: returns
    (price, V_grid, spot_grid), the same discretization written
    independently."""
    lib = load()
    grid = np.zeros(n_space, dtype=np.float64)
    sgrid = np.zeros(n_space, dtype=np.float64)
    price = lib.bs_pde_solve(S0, sigma, r, q, T, K, int(is_call), int(american),
                             n_space, n_time, s_min_mult, s_max_mult,
                             int(crank_nicolson), _c(grid), _c(sgrid))
    return float(price), grid, sgrid


@_host
def heston_adi_solve(kappa, theta, sigma, rho, v0, r, q, T, K, S0, *,
                     is_call=True, american=False,
                     n_spot: int = 100, n_vol: int = 50, n_time: int = 100,
                     s_min_mult: float = 0.2, s_max_mult: float = 5.0,
                     v_max: float = 1.0):
    """Float64 Douglas-ADI oracle of ``solvers.heston_adi.solve``: returns
    (price, V_grid) with V_grid (n_spot, n_vol), the same scheme (In 't
    Hout-Foulon boundaries, theta = 1/2) written independently in scalar
    C++."""
    lib = load()
    grid = np.zeros((n_spot, n_vol), dtype=np.float64)
    price = lib.heston_adi_solve(kappa, theta, sigma, rho, v0, r, q, T, K,
                                 int(is_call), int(american), S0,
                                 n_spot, n_vol, n_time,
                                 s_min_mult, s_max_mult, v_max, _c(grid))
    return float(price), grid


@_host
def hjb_march(theta, mu, sigma, r, T, x_min, x_max, exercise, n_time: int = 200) -> np.ndarray:
    """Float64 implicit-Euler obstacle march (``hjb._march``'s projection
    mode); the final value function on the x grid."""
    lib = load()
    exercise = _f64(exercise)
    out = np.zeros(len(exercise), dtype=np.float64)
    lib.hjb_march(theta, mu, sigma, r, T, x_min, x_max, len(exercise), n_time,
                  _c(exercise), _c(out))
    return out


@_host
def hjb_march_bs(theta, mu, sigma, r, T, x_min, x_max, exercise, reverse: bool,
                 n_time: int = 200) -> np.ndarray:
    """The exact LCP march by Brennan-Schwartz (``hjb._march(method=
    "brennan_schwartz")``), the contact region at the right end when
    ``reverse``."""
    lib = load()
    exercise = _f64(exercise)
    out = np.zeros(len(exercise), dtype=np.float64)
    lib.hjb_march_bs(theta, mu, sigma, r, T, x_min, x_max, len(exercise), n_time,
                     _c(exercise), int(bool(reverse)), _c(out))
    return out


@_host
def hjb_march_bs_multi(theta, mu, sigma, r, T, x_min, x_max, exercise, reverse,
                       n_time: int = 200) -> np.ndarray:
    """Every stopping problem of one config in one call, a thread a march:
    ``exercise`` (n_problems, n_space), ``reverse`` a flag a problem."""
    lib = load()
    exercise = _f64(exercise)
    n_problems, n = exercise.shape
    rev = np.ascontiguousarray(np.asarray(reverse, dtype=np.int32).reshape(n_problems))
    out = np.zeros((n_problems, n), dtype=np.float64)
    lib.hjb_march_bs_multi(theta, mu, sigma, r, T, x_min, x_max, n, n_time, n_problems,
                           _c(exercise), rev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                           _c(out))
    return out
