"""Ornstein-Uhlenbeck process: exact MLE, simulation, boundaries, signals
(twin of ``pde_tpu/models/ou.py``).

* :func:`fit_mle` / :func:`log_likelihood` — the closed-form AR(1) MLE
  (ou_process.cpp:45-151) as tensor reductions over the LAST axis: a
  ``(..., n)`` batch of series fits in one call, the port's form of the
  reference's ``vmap`` over spreads.
* :func:`simulate` — the exact-discretization path as a loop of tensor
  steps over the time axis; :func:`simulate_parallel` — the same recurrence
  as a log-depth scan over (a, b) pairs.  Both take a ``torch.Generator``
  where the reference takes a PRNG key, run on their inputs' device (the
  card when no input is a tensor), draw their normals there from the
  generator, which must live there too, and hand them to a path function
  of (params, x0, dt, z).  Philox and threefry streams differ, so the
  paths match the reference only on the same normals.
* :func:`generate_trading_signals` — the stateful -1/0/+1 position walk.

Functions follow their inputs' device (the card when no input is a tensor)
and keep the reference's ``safe_*`` guards, so that autograd through one
side of a ``where`` never meets a NaN from the other.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.precision import check_generator, device_of, result_dtype, to_tensor

__all__ = [
    "OUParams",
    "OUFitResult",
    "fit_mle",
    "log_likelihood",
    "conditional_mean",
    "conditional_variance",
    "transition_density",
    "simulate",
    "simulate_parallel",
    "optimal_boundaries",
    "generate_trading_signals",
]

_EPS = 1e-12  # matches ou_process.cpp:13
_LOG_2PI = 1.8378770664093453


def _tensors(*xs, device=None):
    """``xs`` as tensors of one floating dtype on one device (the first
    tensor's, else ``device``, else the card)."""
    dtype = result_dtype(*xs)
    dev = device_of(*xs, default=device)
    return tuple(to_tensor(x, dtype, dev) for x in xs)


class OUParams(NamedTuple):
    """OU parameters dX = mu (theta - X) dt + sigma dW: numbers or tensors.

    Mirrors OUParameters (ou_process.hpp:42-118) including the derived
    half-life and stationary-variance helpers.
    """

    theta: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor

    def half_life(self):
        """ln 2 / mu (inf when mu <= 0)."""
        mu, = _tensors(self.mu)
        return torch.where(mu > 0, math.log(2.0) / torch.clamp_min(mu, _EPS), math.inf)

    def stationary_variance(self):
        """sigma^2 / (2 mu)."""
        mu, sigma = _tensors(self.mu, self.sigma)
        return torch.where(mu > 0, sigma**2 / (2.0 * torch.clamp_min(mu, _EPS)), math.inf)

    def stationary_std(self):
        return torch.sqrt(self.stationary_variance())


class OUFitResult(NamedTuple):
    """Closed-form MLE output (params + fit diagnostics)."""

    params: OUParams
    log_likelihood: torch.Tensor
    aic: torch.Tensor
    bic: torch.Tensor
    converged: torch.Tensor  # bool: variance was non-degenerate
    b_clamped: torch.Tensor  # bool: AR(1) slope was clamped into (0, 1)


def conditional_mean(x_t, params: OUParams, dt):
    """E[X_{t+dt} | X_t] = theta + (X_t - theta) e^{-mu dt}  (ou_process.cpp:160-164)."""
    x_t, theta, mu = _tensors(x_t, params.theta, params.mu)
    return theta + (x_t - theta) * torch.exp(-mu * dt)


def conditional_variance(params: OUParams, dt):
    """Var[X_{t+dt} | X_t] = sigma^2 (1 - e^{-2 mu dt}) / (2 mu).

    Brownian limit sigma^2 dt when mu ~ 0 (ou_process.cpp:166-175).
    """
    mu, sigma = _tensors(params.mu, params.sigma)
    small = mu < _EPS
    safe_mu = torch.clamp_min(mu, _EPS)
    exact = sigma**2 * (1.0 - torch.exp(-2.0 * safe_mu * dt)) / (2.0 * safe_mu)
    return torch.where(small, sigma**2 * dt, exact)


def transition_density(x_next, x_t, params: OUParams, dt):
    """Gaussian transition density (ou_process.cpp:177-192)."""
    x_next = _tensors(x_next, x_t, *params)[0]
    m = conditional_mean(x_t, params, dt)
    var = conditional_variance(params, dt)
    degenerate = var < _EPS
    safe_var = torch.where(degenerate, 1.0, var)
    z = (x_next - m) / torch.sqrt(safe_var)
    dens = torch.exp(-0.5 * z * z) / torch.sqrt(2.0 * math.pi * safe_var)
    spike = torch.where(torch.abs(x_next - m) < _EPS, 1e10, 0.0)
    return torch.where(degenerate, spike, dens)


def log_likelihood(x, params: OUParams, dt):
    """Exact discrete-time log-likelihood (ou_process.cpp:194-220) of the
    series along the last axis of ``x``, with parameters of its batch
    shape (or shared)."""
    x = _tensors(x, *params)[0]
    n = x.shape[-1] - 1
    # parameters of the batch shape (...) against series (..., n + 1)
    params = OUParams(*(to_tensor(v, x.dtype, x.device)[..., None] for v in params))
    var = conditional_variance(params, dt)[..., 0]
    resid = x[..., 1:] - conditional_mean(x[..., :-1], params, dt)
    ssr = torch.sum(resid * resid, dim=-1)
    safe_var = torch.clamp_min(var, _EPS)
    ll = -0.5 * n * _LOG_2PI - 0.5 * n * torch.log(safe_var) - 0.5 * ssr / safe_var
    return torch.where(var < _EPS, -math.inf, ll)


def fit_mle(x, dt) -> OUFitResult:
    """Closed-form AR(1) maximum-likelihood fit over the last axis.

    Exactly mirrors OUProcess::fit_mle (ou_process.cpp:45-151): population
    moments over consecutive pairs, slope clamp b in [1e-4, 0.9999],
    mu = -ln b / dt, theta from the intercept, sigma from the residual
    variance with the small-mu Brownian fallback, plus AIC/BIC.  A
    ``(..., n)`` batch of series gives ``(...)``-shaped fields.  The
    moments are taken of each series less its first value: of a series
    far from zero, mean(x^2) - mean(x)^2 cancels most of float32's digits,
    and mu = -ln(b) / dt magnifies the slope's error by 1 / (1 - b) (the
    reference takes raw moments, and its float32 mu drifts by percents).
    """
    x, = _tensors(x)
    n = x.shape[-1] - 1
    # theta takes the shift back; mu and sigma do not depend on it
    shift = x[..., :1]
    xt = x[..., :-1] - shift
    xn = x[..., 1:] - shift

    mean_x = torch.mean(xt, dim=-1)
    mean_xn = torch.mean(xn, dim=-1)
    var_x = torch.mean(xt * xt, dim=-1) - mean_x * mean_x
    var_xn = torch.mean(xn * xn, dim=-1) - mean_xn * mean_xn
    cov = torch.mean(xt * xn, dim=-1) - mean_x * mean_xn

    degenerate = var_x < _EPS
    safe_var_x = torch.where(degenerate, 1.0, var_x)

    b_raw = cov / safe_var_x
    # clamp only the invalid slopes, exactly as ou_process.cpp:89-97; the
    # upper clamp's 1 - b and -ln b come from float64 constants (float32's
    # 0.9999 is 0.99989998, 1.7e-4 off in both)
    high = b_raw >= 1.0
    b = torch.where(high, 0.9999, torch.where(b_raw <= 0.0, 0.0001, b_raw))
    clamped = high | (b_raw <= 0.0)
    one_minus_b = torch.where(high, 1.0 - 0.9999, 1.0 - b)

    mu = torch.where(high, -math.log(0.9999), -torch.log(b)) / dt
    a = mean_xn - b * mean_x
    theta = torch.where(torch.abs(one_minus_b) > _EPS, a / torch.clamp_min(one_minus_b, _EPS),
                        0.5 * (mean_x + mean_xn))

    resid_var = torch.clamp_min(var_xn - b * b * var_x, _EPS)
    exp_factor = -torch.expm1(-2.0 * mu * dt)  # 1 - e^{-2 mu dt} keeps its digits at small mu dt
    sigma_exact = torch.sqrt(2.0 * mu * resid_var / torch.clamp_min(exp_factor, _EPS))
    sigma_bm = torch.sqrt(resid_var / dt)
    sigma = torch.where((mu > _EPS) & (exp_factor > _EPS), sigma_exact, sigma_bm)

    # degenerate (constant) series: theta = mean, mu = 0, sigma = 0
    theta = torch.where(degenerate, mean_x, theta) + shift[..., 0]
    mu = torch.where(degenerate, 0.0, mu)
    sigma = torch.where(degenerate, 0.0, sigma)

    params = OUParams(theta=theta, mu=mu, sigma=sigma)
    ll = log_likelihood(x, params, dt)
    aic = -2.0 * ll + 2.0 * 3.0
    bic = -2.0 * ll + 3.0 * torch.log(torch.tensor(float(n), dtype=x.dtype, device=x.device))

    return OUFitResult(params=params, log_likelihood=ll, aic=aic, bic=bic,
                       converged=~degenerate, b_clamped=clamped)


def _normals(generator: torch.Generator, shape, dtype, device):
    """Standard normals of ``shape`` drawn from ``generator`` on ``device``,
    which must be the generator's own: a draw never moves the path to
    another device."""
    check_generator(generator, device)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _step(params: OUParams, x0, dt, z):
    """``z`` as a floating tensor, and theta, x0, e^{-mu dt} and the step's
    standard deviation in its dtype on its device."""
    z, = _tensors(z)
    theta, mu, sigma, x0 = (to_tensor(a, z.dtype, z.device) for a in (*params, x0))
    std = torch.sqrt(conditional_variance(OUParams(theta, mu, sigma), dt))
    return z, theta, x0, torch.exp(-mu * dt), std


def _path(params: OUParams, x0, dt, z):
    """The exact-discretization recurrence on given normals ``z`` (..., n):
    X_{t+dt} = theta + (X_t - theta) e^{-mu dt} + std Z, one tensor step
    per time step; returns (..., n + 1) starting at ``x0``."""
    z, theta, x0, decay, std = _step(params, x0, dt, z)
    x = x0.expand(z.shape[:-1])
    xs = [x]
    for zi in z.unbind(-1):
        x = theta + (x - theta) * decay + std * zi
        xs.append(x)
    return torch.stack(xs, -1)


def _path_parallel(params: OUParams, x0, dt, z):
    """The same path as :func:`_path` as one log-depth scan: the steps are
    pairs (a, b_k) = (e^{-mu dt}, theta (1 - a) + std Z_k) composed by
    ``(a1, b1) . (a2, b2) = (a2 a1, a2 b1 + b2)``, an associative map, in
    ceil(log2 n) whole-tensor passes (each element composed with the one
    ``s`` steps before it, s = 1, 2, 4, ...); X_k = A_k x0 + B_k."""
    z, theta, x0, decay, std = _step(params, x0, dt, z)
    a = decay.expand(z.shape)
    b = theta * (1.0 - decay) + std * z
    n, s = z.shape[-1], 1
    while s < n:
        a, b = (torch.cat([a[..., :s], a[..., s:] * a[..., :-s]], -1),
                torch.cat([b[..., :s], a[..., s:] * b[..., :-s] + b[..., s:]], -1))
        s *= 2
    path = a * x0[..., None] + b
    return torch.cat([x0.expand(z.shape[:-1])[..., None], path], -1)


def simulate(params: OUParams, x0, T, n_steps: int, generator: torch.Generator,
             shape=(), dtype=None, device=None) -> torch.Tensor:
    """Exact-discretization OU path of length ``n_steps + 1``
    (ou_process.cpp:230-256) on the inputs' device (the first tensor's
    among ``x0`` and ``params``, else ``device``, else the card), in
    ``dtype`` (default: the inputs' floating dtype).  Its normals are drawn
    from ``generator``, which must live on that device (``ValueError``
    otherwise).  ``shape`` adds leading path axes: ``shape=(1024,)`` is a
    fan of 1024 paths, the port's form of the reference's ``vmap`` over
    keys."""
    dtype = dtype or result_dtype(x0, *params)
    dev = device_of(x0, *params, default=device)
    z = _normals(generator, tuple(shape) + (n_steps,), dtype, dev)
    return _path(params, x0, T / n_steps, z)


def simulate_parallel(params: OUParams, x0, T, n_steps: int, generator: torch.Generator,
                      shape=(), dtype=None, device=None) -> torch.Tensor:
    """Parallel-in-time exact OU path: the distribution of :func:`simulate`
    (and, on the same normals, its path to roundoff) at log depth.  The
    serial recurrence is latency-bound at n dependent steps; this variant
    does O(n log n) work in ~log2(n) passes, the winning trade for LONG
    paths (one path, millions of steps).  For wide fans of short paths keep
    :func:`simulate`.  Device, dtype and generator as :func:`simulate`."""
    dtype = dtype or result_dtype(x0, *params)
    dev = device_of(x0, *params, default=device)
    z = _normals(generator, tuple(shape) + (n_steps,), dtype, dev)
    return _path_parallel(params, x0, T / n_steps, z)


def optimal_boundaries(params: OUParams, transaction_cost=0.001, risk_free_rate=0.05):
    """Heuristic entry/exit boundaries from the stationary distribution.

    Matches OUProcess::optimal_boundaries (ou_process.cpp:270-301):
    threshold = 1.5 sigma_stat + transaction_cost, exit at theta.  The
    rigorous free-boundary alternative lives in
    :mod:`pde_tpu_torch.solvers.hjb`.
    """
    del risk_free_rate  # unused in the heuristic (same as the reference)
    theta = _tensors(*params)[0]
    stat_std = params.stationary_std()
    threshold = 1.5 * stat_std + (transaction_cost / stat_std) * stat_std
    return theta - threshold, theta + threshold, theta


def generate_trading_signals(prices, params: OUParams, transaction_cost=0.001,
                             risk_free_rate=0.05):
    """Boundary-crossing -1/0/+1 position walk over a price series (the
    reference's per-bar loop, models/ou_process.py:375-425), one step per
    bar over the last axis."""
    prices = _tensors(prices, *params)[0]
    lower, upper, exit_target = optimal_boundaries(params, transaction_cost, risk_free_rate)
    position = torch.zeros(prices.shape[:-1], dtype=torch.int64, device=prices.device)
    signals = []
    for price in prices.unbind(-1):
        enter_long = (position == 0) & (price < lower)
        enter_short = (position == 0) & (price > upper)
        exit_long = (position == 1) & (price >= exit_target)
        exit_short = (position == -1) & (price <= exit_target)

        new_pos = torch.where(enter_long, 1, position)
        new_pos = torch.where(enter_short, -1, new_pos)
        position = torch.where(exit_long | exit_short, 0, new_pos)
        signals.append(position)
    return {
        "signals": torch.stack(signals, -1),
        "entry_lower": lower,
        "entry_upper": upper,
        "exit_target": exit_target,
    }
