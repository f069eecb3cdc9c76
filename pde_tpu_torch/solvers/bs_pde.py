"""Black-Scholes 1D PDE solver in log space (twin of
``pde_tpu/solvers/bs_pde.py``, the fused-book path).

Same discretisation as the reference BlackScholesPDESolver
(src/cpp/solvers/black_scholes_pde.hpp): log-space grid S in
[K s_min_mult, K s_max_mult], central differences, Crank-Nicolson or
implicit Euler, Dirichlet rows discounted over time-to-expiry (both
discounts), per-step ``max(V, payoff)`` projection for American exercise.

* :func:`solve` — one option, a backward march of per-step tridiagonal
  solves (the matrix factored once), American exercise by projection, by
  the LCP through red-black PSOR (:mod:`pde_tpu_torch.solvers.lcp`) or
  exactly by Brennan-Schwartz.  Any dtype.  On float32 tensors on the card
  each step's solve is one launch of K5
  (:func:`~pde_tpu_torch.ops.tridiag.tridiagonal_solve`) and each PSOR
  solve one launch of K6 (:func:`~pde_tpu_torch.solvers.lcp.projected_sor`).
* :func:`solve_fused_batch` — a whole book marches in ONE launch of the K4
  kernel (:mod:`pde_tpu_torch.ops.cn1d_fused`).

Port notes: the batch needs no 128-lane padding and there is no
``interpret`` argument (both TPU artifacts).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import grids
from ..core.precision import resolve_device, result_dtype, to_tensor
from ..ops.cn1d_fused import fused_cn_march_1d
from ..ops.tridiag import (kernel_route, thomas_factor, thomas_solve_factored,
                           tridiagonal_solve)
from . import lcp

__all__ = ["BSPDEParams", "BSPDEResult", "solve", "solve_fused_batch"]


class BSPDEParams(NamedTuple):
    """Solver inputs (defaults match BlackScholesPDEParams,
    black_scholes_pde.hpp:58-62)."""

    sigma: float = 0.2
    r: float = 0.05
    q: float = 0.0
    T: float = 1.0
    K: float = 100.0
    is_call: bool = True
    american: bool = False
    n_space: int = 200
    n_time: int = 100
    s_min_mult: float = 0.2
    s_max_mult: float = 5.0
    scheme: str = "crank_nicolson"  # "crank_nicolson" | "implicit" | "explicit"
    american_method: str = "projection"  # | "psor" | "brennan_schwartz"
    psor_iterations: int = 60
    reference_compat: bool = False


class BSPDEResult(NamedTuple):
    price: torch.Tensor
    delta: torch.Tensor
    gamma: torch.Tensor
    theta: torch.Tensor
    prices: torch.Tensor  # value on the grid at t=0
    spot_grid: torch.Tensor
    early_exercise_optimal: torch.Tensor


def _operator_coeffs(p: BSPDEParams, dx):
    """Interior-point operator L = diffusion + advection - r I in log space
    (black_scholes_pde.hpp:185-206)."""
    sigma2 = p.sigma * p.sigma
    drift = p.r - p.q - 0.5 * sigma2
    a = 0.5 * sigma2 / (dx * dx)
    b = drift / (2.0 * dx)
    return a - b, -2.0 * a - p.r, a + b


def _readout_1d(V, s_grid, S0, K, sigma, r, q, T, is_call, american, price=None):
    """Price, grid delta and gamma, analytic theta and the early-exercise
    flag from the t=0 values; ``V``/``s_grid`` (..., n) with the other
    arguments of the batch shape, ``is_call``/``american`` bool tensors.
    A given ``price`` overrides the bracketing interpolation (the
    reference_compat readout)."""
    interp, delta, gamma = grids.price_delta_gamma(s_grid, V, S0)
    price = interp if price is None else price

    # analytic BS theta at S0 (black_scholes_pde.hpp:314-331)
    d1 = (torch.log(S0 / K) + (r - q + 0.5 * sigma * sigma) * T) / (sigma * torch.sqrt(T))
    nd1 = torch.exp(-0.5 * d1 * d1) / math.sqrt(2.0 * math.pi)
    theta = -S0 * nd1 * sigma / (2.0 * torch.sqrt(T))
    sign = torch.where(is_call, -1.0, 1.0).to(theta.dtype)
    theta = theta + sign * r * K * torch.exp(-r * T) * 0.5

    payoff_s0 = torch.where(is_call, torch.clamp_min(S0 - K, 0.0),
                            torch.clamp_min(K - S0, 0.0))
    early_ex = american & (price > payoff_s0 + 1e-10)
    return price, delta, gamma, theta, early_ex


def _solve_impl(S0, sigma, r, q, T, K, s_min_mult, s_max_mult, n_space, n_time,
                is_call, american, scheme, american_method="projection",
                psor_iterations=60, reference_compat=False):
    """The backward march of one option; ``S0``..``K`` are 0-d tensors of
    one dtype on one device, the rest Python values."""
    n = n_space
    s_grid = torch.exp(grids.linspace(torch.log(K * s_min_mult),
                                      torch.log(K * s_max_mult), n))
    dx = torch.log(s_grid[-1] / s_grid[0]) / (n - 1)
    dt = T / n_time
    payoff = (torch.clamp_min(s_grid - K, 0.0) if is_call
              else torch.clamp_min(K - s_grid, 0.0))
    L_m, L_c, L_p = _operator_coeffs(BSPDEParams(sigma=sigma, r=r, q=q), dx)

    # implicit system diagonals (boundary rows are identity rows); the
    # theta-scheme weight on the implicit side: CN 1/2, implicit Euler 1,
    # explicit Euler 0 (pde_core.hpp:186)
    idx = torch.arange(n, device=s_grid.device)
    is_interior = (idx > 0) & (idx < n - 1)
    w = {"crank_nicolson": 0.5, "implicit": 1.0, "explicit": 0.0}[scheme]
    diag = torch.where(is_interior, 1.0 - w * dt * L_c, 1.0)
    lower = torch.where(is_interior[1:], -w * dt * L_m, 0.0)
    upper = torch.where(is_interior[:-1], -w * dt * L_p, 0.0)
    zero = torch.zeros_like(diag[:1])
    if reference_compat:
        # the reference zeroes A[1,0] and A[n-2,n-1] after assembly
        # (black_scholes_pde.hpp:250-254), so rows 1 and n-2 lose their
        # implicit coupling to the Dirichlet rows
        lower = torch.cat([zero, lower[1:]])
        upper = torch.cat([upper[:-1], zero])

    def explicit_rhs(V):
        """(I + (1-w) dt L) V on interior points."""
        if w == 1.0:
            return V
        LV = L_m * V[:-2] + L_c * V[1:-1] + L_p * V[2:]
        return torch.cat([V[:1], V[1:-1] + (1.0 - w) * dt * LV, V[-1:]])

    def apply_bc(V, tau):
        """Dirichlet values at time-to-expiry ``tau``: discounted over tau
        with the dividend discount on the S leg, or with
        ``reference_compat`` the reference's calendar-time discount
        (black_scholes_pde.hpp:127) and no dividend discount."""
        if reference_compat:
            df_r = torch.exp(-r * (T - tau))
            df_q = torch.ones_like(df_r)
        else:
            df_r = torch.exp(-r * tau)
            df_q = torch.exp(-q * tau)
        if is_call:
            ends = (zero, (s_grid[-1] * df_q - K * df_r)[None])
        else:
            ends = ((K * df_r - s_grid[0] * df_q)[None], zero)
        return torch.cat([ends[0], V[1:-1], ends[1]])

    psor = american and american_method == "psor"
    brennan = american and american_method == "brennan_schwartz"
    on_kernel = not (psor or brennan) and kernel_route(diag, lower, upper, payoff)
    if brennan:
        # put: exercise region at low S (sweep from the left); call: high S
        factors = lcp.brennan_schwartz_factor(lower, diag, upper, reverse=bool(is_call))
    elif not (psor or on_kernel):
        factors = thomas_factor(lower, diag, upper)

    V = payoff
    for k in range(1, n_time + 1):
        tau = dt * float(k)
        rhs = explicit_rhs(V)
        if psor:
            V, _ = lcp.projected_sor(lower, diag, upper, rhs, payoff, x0=V,
                                     n_iter=psor_iterations)
        elif brennan:
            V = lcp.brennan_schwartz_apply(factors, rhs, payoff)
        elif on_kernel:
            V = tridiagonal_solve(lower, diag, upper, rhs[None])[0]
        else:
            V = thomas_solve_factored(factors, rhs)
        if reference_compat:
            # the reference's step order (black_scholes_pde.hpp:117-127):
            # American projection first, Dirichlet overwrite last (unfloored)
            if american:
                V = torch.maximum(V, payoff)
            V = apply_bc(V, tau)
        else:
            V = apply_bc(V, tau)
            if american:
                # after the Dirichlet overwrite, so the boundary rows are
                # floored at intrinsic too
                V = torch.maximum(V, payoff)

    price = None
    if reference_compat:
        # the reference's readout defect (pde_core.hpp:101-133): the NEAREST
        # grid point, then always the segment [i-1, i], which extrapolates
        # from the wrong segment when the nearest point lies left of S0
        i_lo = torch.clamp(torch.searchsorted(s_grid, S0[None], right=True)[0] - 1,
                           0, n - 2)
        nearest = torch.where(S0 - s_grid[i_lo] < s_grid[i_lo + 1] - S0, i_lo, i_lo + 1)
        i = torch.clamp(nearest, 1, n - 2)
        t = (S0 - s_grid[i - 1]) / (s_grid[i] - s_grid[i - 1])
        price = (1.0 - t) * V[i - 1] + t * V[i]
    flag = lambda b: torch.as_tensor(bool(b), device=V.device)  # noqa: E731
    price, delta, gamma, theta, early = _readout_1d(
        V, s_grid, S0, K, sigma, r, q, T, flag(is_call), flag(american), price=price)
    return BSPDEResult(price, delta, gamma, theta, V, s_grid, early)


def solve(params: BSPDEParams, S0, device=None, dtype=None) -> BSPDEResult:
    """Solve the BS PDE and return price/Greeks at ``S0``.

    Runs on ``device`` (default: the CUDA card) in ``dtype`` (default: the
    dtype of the tensors among the parameters and ``S0``, else torch's
    default float).
    """
    if params.sigma <= 0:
        raise ValueError("sigma must be positive")
    if params.T <= 0:
        raise ValueError("T must be positive")
    if params.K <= 0:
        raise ValueError("K must be positive")
    if params.n_space < 10 or params.n_time < 10:
        raise ValueError("n_space and n_time must be >= 10")
    if params.scheme not in ("crank_nicolson", "implicit", "explicit"):
        raise ValueError(f"unknown scheme {params.scheme!r}")
    device = resolve_device(device)
    floats = (S0, params.sigma, params.r, params.q, params.T, params.K)
    f = dtype or result_dtype(*floats)
    return _solve_impl(
        *(to_tensor(a, f, device) for a in floats), params.s_min_mult,
        params.s_max_mult, params.n_space, params.n_time, bool(params.is_call),
        bool(params.american), params.scheme, params.american_method,
        params.psor_iterations, bool(params.reference_compat))


def _march_inputs(sigma, r, q, T, K, call_f, amer_f, n_space, n_time,
                  s_min_mult, s_max_mult):
    """K4's inputs for a book of (B,) float32 tensors on one device, in its
    public layout ``(pay, sc)``, plus the book's spot grid (n, B)."""
    # K-scaled log grid: s_i = K g_i with g_i = s_min_mult e^{i dx}; dx is
    # the SAME for every option.  Spaced in float64 and rounded once.
    n = n_space
    dx = math.log(s_max_mult / s_min_mult) / (n - 1)
    g = (s_min_mult * torch.exp(dx * torch.arange(n, dtype=torch.float64,
                                                  device=K.device))).to(torch.float32)
    s_grid = K[None, :] * g[:, None]                            # (n, B)
    pay = torch.where(call_f[None, :] > 0.5,
                      torch.clamp_min(s_grid - K[None, :], 0.0),
                      torch.clamp_min(K[None, :] - s_grid, 0.0))
    L_m, L_c, L_p = _operator_coeffs(BSPDEParams(sigma=sigma, r=r, q=q), dx)
    sc = torch.stack([T / n_time, r, q, K, call_f, amer_f, L_m, L_c, L_p,
                      K * s_min_mult, K * s_max_mult, torch.zeros_like(K)])
    return pay, sc, s_grid


def solve_fused_batch(
    sigma, r, q, T, K, is_call, S0,
    american=False,
    n_space: int = 200,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    scheme: str = "crank_nicolson",
    device=None,
) -> BSPDEResult:
    """Price a whole option BOOK through one fused march.

    Every array argument broadcasts along one leading batch axis;
    ``is_call`` and ``american`` are per-option, so a book may mix strikes,
    maturities, rates, vols, calls with puts, and European with American
    (projection).  The book marches on ``device`` (default: the CUDA card)
    in float32: one K4 launch on a CUDA device, its plain twin on the CPU.
    Greeks from the grid plus the analytic theta.
    """
    if scheme not in ("crank_nicolson", "implicit"):
        raise ValueError(
            f"unknown or unsupported scheme {scheme!r}: the fused march is "
            "implicit-path only ('crank_nicolson' or 'implicit')")
    if n_space < 10 or n_time < 10:
        raise ValueError("n_space and n_time must be >= 10")
    device = resolve_device(device)
    vals = [torch.atleast_1d(torch.as_tensor(a, device=device).to(torch.float32))
            for a in (sigma, r, q, T, K, is_call, S0, american)]
    B = max(a.shape[0] for a in vals)
    sigma, r, q, T, K, call_f, S0, amer_f = (a.expand(B).contiguous() for a in vals)
    pay, sc, s_grid = _march_inputs(sigma, r, q, T, K, call_f, amer_f, n_space,
                                    n_time, s_min_mult, s_max_mult)
    w = {"crank_nicolson": 0.5, "implicit": 1.0}[scheme]
    V = fused_cn_march_1d(pay, sc, n_space=n_space, n_time=n_time, w=w)  # (n, B)
    price, delta, gamma, theta, early = _readout_1d(
        V.T, s_grid.T, S0, K, sigma, r, q, T, call_f > 0.5, amer_f > 0.5)
    return BSPDEResult(price, delta, gamma, theta, V.T, s_grid.T, early)
