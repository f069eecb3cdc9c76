"""Rough Heston Monte Carlo via the Markovian multifactor lift (twin of
``pde_tpu/models/rough_heston_mc.py``).

The rough variance carries the fractional kernel K(t) = t^{alpha-1} /
Gamma(alpha), so it is not Markovian.  The lift (Abi Jaber & El Euch 2019)
approximates the kernel by a sum of exponentials,

    K(t) ~= sum_j c_j exp(-x_j t),

on a geometric node grid, and each exponential factor becomes an OU-type
state

    dY_j = -x_j Y_j dt + dF_t,   V_t = v0 + sum_j c_j Y_j(t),
    dF_t = lam (theta - V_t) dt + nu sqrt(V_t^+) dW_t,

an (n_paths, n_factors) Markovian system: one elementwise update and one
``(paths, factors) @ (factors,)`` product per step, in full float32 (TF32
off).  The factor recursion uses the exact decay e^{-x_j dt} with the
integrated-kernel average gamma_j = (1 - e^{-x_j dt}) / (x_j dt) on the
shared increment, so stiff fast factors stay stable at any step.

European prices cross-check the fractional-Riccati pricer
(:func:`~pde_tpu_torch.models.rough_heston.price_rough`); American prices
run Longstaff-Schwartz (:mod:`pde_tpu_torch.solvers.lsm`) on the lifted
paths, which no grid or characteristic-function route reaches.

**Draws.**  Where the reference takes a PRNG key, each simulator and
pricer takes a ``torch.Generator`` on the path's device or a replay
(:mod:`pde_tpu_torch.models.heston_mc`), split into ``n_steps`` step
sources and each of those into ``(W, B)``, as the reference splits its key.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.precision import device_of, result_dtype, to_tensor
from .heston_mc import MCPaths, _draws, _mc_estimate, _ndim
from .rough_heston import RoughHestonParams, _gamma

__all__ = [
    "lift_nodes",
    "simulate_lifted",
    "simulate_lifted_paths",
    "price_european_rough_mc",
    "price_american_rough_lsm",
]


def _fp32():
    from ..calibrate.lm import _full_fp32_matmul  # calibrate imports the models

    return _full_fp32_matmul()


def lift_nodes(hurst, n_factors: int = 20, x_min: float = 1e-3, x_max: float = 3e4,
               dtype=None, device=None):
    """Exponential-sum approximation of the fractional kernel: ``(c, x)`` of
    shape (n_factors,).

    Nodes x_j at the geometric midpoints of [x_min, x_max]; weights by
    relative least squares on a log time grid t in [1e-4, 4] (minimizing
    sum_t |sum_j c_j e^{-x_j t} / K(t) - 1|^2) with a ridge of 1e-10 of the
    Gram matrix's mean diagonal: the reference's problem.  The nodes span
    7 decades, so the Gram matrix is ill-conditioned, and the reference's
    normal equations square that condition; the port solves the same
    ridge least squares by QR of the stacked matrix ``[Ew; sqrt(ridge)
    I]``, in ``dtype`` as the reference solves in its path dtype (float32
    wherever x64 is off).  In float32 that keeps the fitted kernel within
    ~1e-6 of float64's, where the normal equations miss it by ~1e-4.
    ``dtype`` defaults to ``hurst``'s (torch's default float for a
    number).  Runs on ``hurst``'s device, else on ``device``, else on the
    card.
    """
    dtype = dtype or result_dtype(hurst)
    device = device_of(hurst, default=device)
    alpha = to_tensor(hurst, dtype, device) + 0.5
    edges = np.geomspace(x_min, x_max, n_factors + 1)
    mids_np = np.sqrt(edges[:-1] * edges[1:])
    mids = to_tensor(mids_np, dtype, device)
    t_grid = np.geomspace(1e-4, 4.0, 256)
    E = to_tensor(np.exp(-t_grid[:, None] * mids_np[None, :]), dtype, device)  # (T, M)
    k_t = to_tensor(t_grid, dtype, device) ** (alpha - 1.0) / _gamma(alpha)
    Ew = E / k_t[:, None]  # relative residuals
    ridge = 1e-10 * torch.sum(Ew * Ew) / n_factors  # of trace(Ew^T Ew)
    A = torch.cat([Ew, torch.sqrt(ridge) * torch.eye(n_factors, dtype=dtype, device=device)])
    b = torch.cat([torch.ones(t_grid.shape[0], dtype=dtype, device=device),
                   torch.zeros(n_factors, dtype=dtype, device=device)])
    Q, R = torch.linalg.qr(A)
    with _fp32():
        qtb = Q.T @ b
    c = torch.linalg.solve_triangular(R, qtb[:, None], upper=True)[:, 0]
    return c, mids


def _lift_step_factory(params: RoughHestonParams, dt, c, x, n_draw, antithetic, rate,
                       dividend, dtype):
    """One lifted step ``(ln_s, Y, source) -> (ln_s', Y', V')``."""
    device = dt.device
    lam, theta, nu, rho, v0 = (to_tensor(getattr(params, f), dtype, device)
                               for f in ("lam", "theta", "nu", "rho", "v0"))
    rho_bar = torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.0))
    drift = (to_tensor(rate, dtype, device) - to_tensor(dividend, dtype, device)) * dt
    sqdt = torch.sqrt(dt)
    decay = torch.exp(-x * dt)  # (M,)
    gamma = torch.where(x * dt > 1e-12, (1.0 - decay) / (x * dt), 1.0)  # (M,)

    def step(ln_s, Y, k_t):
        with _fp32():
            v = torch.clamp_min(v0 + Y @ c, 0.0)  # (P,)
        k1, k2 = k_t.split(2)
        dW = k1.normal((n_draw,), dtype, device) * sqdt
        dB = k2.normal((n_draw,), dtype, device) * sqdt
        if antithetic:
            dW = torch.cat([dW, -dW])
            dB = torch.cat([dB, -dB])
        sqv = torch.sqrt(v)
        dF = lam * (theta - v) * dt + nu * sqv * dW  # (P,)
        Y_new = decay[None, :] * Y + gamma[None, :] * dF[:, None]
        ln_s_new = ln_s + drift - 0.5 * v * dt + sqv * (rho * dW + rho_bar * dB)
        with _fp32():
            v_new = torch.clamp_min(v0 + Y_new @ c, 0.0)
        return ln_s_new, Y_new, v_new

    return step


def _setup(params, spot, maturity, generator, n_steps, n_paths, n_factors, rate,
           dividend, antithetic, device):
    """dtype, device, the step sources, the step, log S0 and Y0, and c."""
    dtype = result_dtype(spot, maturity, params.lam)
    device = device_of(spot, maturity, *params, default=device)
    source = _draws(generator, device)
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths
    dt = to_tensor(maturity, dtype, device) / n_steps
    c, x = lift_nodes(to_tensor(params.hurst, dtype, device), n_factors, dtype=dtype)
    step = _lift_step_factory(params, dt, c, x, n_draw, antithetic, rate, dividend, dtype)
    s0 = to_tensor(spot, dtype, device)
    Y0 = torch.zeros((n_paths, n_factors), dtype=dtype, device=device)
    return dtype, device, source.split(n_steps), step, s0, torch.log(s0).expand(n_paths), Y0, c


def simulate_lifted(
    params: RoughHestonParams,
    spot,
    maturity,
    generator,
    *,
    n_steps: int = 256,
    n_paths: int = 65536,
    n_factors: int = 20,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
    device=None,
) -> MCPaths:
    """Simulate rough Heston paths: the terminal state and path statistics
    (the :class:`~pde_tpu_torch.models.heston_mc.MCPaths` contract of the
    QE engine, so its path-payoff pricers apply).  Runs on the first
    tensor's device among spot, maturity and the parameters, else on
    ``device``, else on the card."""
    dtype, device, keys, step, s0, ln_s, Y, c = _setup(
        params, spot, maturity, generator, n_steps, n_paths, n_factors, rate, dividend,
        antithetic, device)
    s_sum = torch.zeros(n_paths, dtype=dtype, device=device)
    s_max = s_min = s0.expand(n_paths)
    for k_t in keys:
        ln_s, Y, _ = step(ln_s, Y, k_t)
        s = torch.exp(ln_s)
        s_sum = s_sum + s
        s_max = torch.maximum(s_max, s)
        s_min = torch.minimum(s_min, s)
    with _fp32():
        v_term = torch.clamp_min(to_tensor(params.v0, dtype, device) + Y @ c, 0.0)
    return MCPaths(torch.exp(ln_s), v_term, s_sum / n_steps, s_max, s_min)


def simulate_lifted_paths(
    params: RoughHestonParams,
    spot,
    maturity,
    generator,
    *,
    n_steps: int = 256,
    n_paths: int = 65536,
    n_factors: int = 20,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
    device=None,
):
    """Stored-path variant: ``(S, V)`` of shape ``(n_steps, n_paths)`` at
    t_1..t_N, for Longstaff-Schwartz under rough dynamics."""
    _, _, keys, step, _, ln_s, Y, _ = _setup(
        params, spot, maturity, generator, n_steps, n_paths, n_factors, rate, dividend,
        antithetic, device)
    ln_s_path, v_path = [], []
    for k_t in keys:
        ln_s, Y, v = step(ln_s, Y, k_t)
        ln_s_path.append(ln_s)
        v_path.append(v)
    return torch.exp(torch.stack(ln_s_path)), torch.stack(v_path)


def price_european_rough_mc(
    params: RoughHestonParams,
    strikes,
    maturity,
    spot,
    generator,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 256,
    n_paths: int = 65536,
    n_factors: int = 20,
    antithetic: bool = True,
    device=None,
):
    """European vanilla under rough Heston by lifted MC; cross-validates
    :func:`~pde_tpu_torch.models.rough_heston.price_rough`.  Returns
    ``(price, stderr)`` shaped like ``strikes``."""
    device = device_of(spot, maturity, *params, default=device)
    paths = simulate_lifted(params, spot, maturity, generator, n_steps=n_steps,
                            n_paths=n_paths, n_factors=n_factors, rate=rate,
                            dividend=dividend, antithetic=antithetic, device=device)
    dtype = paths.spot.dtype
    strikes_a = torch.atleast_1d(to_tensor(strikes, dtype, device))
    sign = torch.where(torch.as_tensor(is_call, device=device), 1.0, -1.0).to(dtype).expand(
        strikes_a.shape)
    disc = torch.exp(-to_tensor(rate, dtype, device) * to_tensor(maturity, dtype, device))
    payoff = torch.clamp_min(sign[None, :] * (paths.spot[:, None] - strikes_a[None, :]), 0.0)
    price, stderr = _mc_estimate(disc * payoff, n_paths, antithetic)
    if _ndim(strikes) == 0:
        return price[0], stderr[0]
    return price, stderr


def price_american_rough_lsm(
    params: RoughHestonParams,
    strike,
    maturity,
    spot,
    generator,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=False,
    n_steps: int = 128,
    n_paths: int = 65536,
    n_factors: int = 20,
    antithetic: bool = True,
    device=None,
):
    """American vanilla under rough Heston: Longstaff-Schwartz on lifted
    paths, on the classic LSM's (S, V) basis (V = v0 + sum c_j Y_j
    summarizes the lifted state).  Returns ``(price, stderr)``; exercise
    at t_0 floors the price at intrinsic."""
    from ..solvers.lsm import lsm_backward_induction

    dtype = result_dtype(spot, maturity, strike, params.lam)
    device = device_of(spot, maturity, strike, *params, default=device)
    s_path, v_path = simulate_lifted_paths(
        params, spot, maturity, generator, n_steps=n_steps, n_paths=n_paths,
        n_factors=n_factors, rate=rate, dividend=dividend, antithetic=antithetic,
        device=device)
    sign = torch.where(torch.as_tensor(is_call, device=device), 1.0, -1.0).to(dtype)
    dt = to_tensor(maturity, dtype, device) / n_steps
    disc = torch.exp(-to_tensor(rate, dtype, device) * dt)
    cashflow = lsm_backward_induction(s_path, v_path, strike, sign, disc)
    price, stderr = _mc_estimate(cashflow * disc, n_paths, antithetic)
    intrinsic = torch.clamp_min(
        sign * (to_tensor(spot, dtype, device) - to_tensor(strike, dtype, device)), 0.0)
    return torch.maximum(price, intrinsic), stderr
