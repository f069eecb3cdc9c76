"""Black-Scholes 1D PDE solver in log space (twin of
``pde_tpu/solvers/bs_pde.py``, the fused-book path).

Same discretisation as the reference BlackScholesPDESolver
(src/cpp/solvers/black_scholes_pde.hpp): log-space grid S in
[K s_min_mult, K s_max_mult], central differences, Crank-Nicolson or
implicit Euler, Dirichlet rows discounted over time-to-expiry (both
discounts), per-step ``max(V, payoff)`` projection for American exercise.
A whole book marches in ONE launch of the K4 kernel
(:mod:`pde_tpu_torch.ops.cn1d_fused`).

Port notes: :func:`solve` (the scan route, with its PSOR and
Brennan-Schwartz American treatments) waits for ``solvers/lcp.py``; the
batch needs no 128-lane padding and there is no ``interpret`` argument
(both TPU artifacts).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import grids
from ..core.precision import resolve_device
from ..ops.cn1d_fused import fused_cn_march_1d

__all__ = ["BSPDEParams", "BSPDEResult", "solve_fused_batch"]


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


def _readout_1d(V, s_grid, S0, K, sigma, r, q, T, is_call, american):
    """Price, grid delta and gamma, analytic theta and the early-exercise
    flag from the t=0 values; ``V``/``s_grid`` (..., n) with the other
    arguments of the batch shape, ``is_call``/``american`` bool tensors."""
    price, delta, gamma = grids.price_delta_gamma(s_grid, V, S0)

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
