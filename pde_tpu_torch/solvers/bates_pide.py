"""Bates 2D PIDE solver: Douglas ADI with an IMEX-CNAB jump term (twin of
``pde_tpu/solvers/bates_pide.py``).

American and European options under stochastic volatility with jumps: the
Heston operator of :mod:`pde_tpu_torch.solvers.heston_adi` (the same In 't
Hout-Foulon boundaries) extended with the non-local term

    lam * INT V(x + y, v) nu(y) dy  -  lam * V  -  lam * kbar * V_x

where ``nu`` is the log-jump density (:class:`~pde_tpu_torch.solvers.pide.
MertonJumps`, the Bates 1996 model, or :class:`~pde_tpu_torch.solvers.pide.
KouJumps`).  The density acts along log-spot only, so the integral over
every variance column is one ``(nS, nS) @ (nS, nv)`` product a step, in
full float32 on the card; jump mass past the grid edges integrates in
closed form against the payoff asymptote, as in the 1D solver.

Time stepping (Salmi, Toivanen & von Sydow 2014): the local operator
marches with the Douglas splitting, the jump integral enters explicitly
with Adams-Bashforth extrapolation ``1.5 J V^n - 0.5 J V^{n-1}`` (Euler on
the first step).  Each step is two implicit sweeps: along S, one system a
variance level with its own bands, and along v, one system an S row with
bands shared by every row.  On float32 tensors on the card outside
autograd each sweep is ONE launch of K5
(:func:`~pde_tpu_torch.ops.tridiag.tridiagonal_solve`), elsewhere the
factored Thomas solve.  American exercise: per-step projection or
Ikonen-Toivanen splitting, the payoff floor after the boundaries in both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..calibrate.lm import _full_fp32_matmul
from ..core import grids
from ..core.precision import resolve_device
from .heston_adi import (HestonPDEResult, _a1_diags, _a2_diags, _apply_a0, _apply_a1,
                         _apply_a2, _assemble_a1, _params_as_tensors, _sweep_solvers)
from .pide import KouJumps, MertonJumps, _cast_jumps, _jump_matrix

__all__ = ["BatesPIDEParams", "solve_bates_pide"]


class BatesPIDEParams(NamedTuple):
    """Heston grid and contract inputs plus the jump leg: the fields of
    :class:`~pde_tpu_torch.solvers.heston_adi.HestonPDEParams` (grid
    defaults from the reference, heston_pde.hpp:56-61) and ``jumps``, a
    :class:`MertonJumps` (= Bates 1996) or :class:`KouJumps`."""

    kappa: float = 2.0
    theta: float = 0.04
    sigma: float = 0.3
    rho: float = -0.7
    v0: float = 0.04
    r: float = 0.05
    q: float = 0.0
    T: float = 1.0
    K: float = 100.0
    is_call: bool = True
    american: bool = False
    jumps: object = MertonJumps(0.5, -0.1, 0.15)
    n_spot: int = 100
    n_vol: int = 50
    n_time: int = 100
    s_min_mult: float = 0.2
    s_max_mult: float = 5.0
    v_max: float = 1.0
    american_method: str = "projection"


def _solve_core(kappa, theta, sigma, rho, v0, r, q, T, K, S0, jumps, *, is_call, american,
                american_method, n_spot, n_vol, n_time, s_min_mult, s_max_mult, v_max):
    """The march of one option: the model and contract inputs 0-d tensors
    of one dtype on one device, the rest Python values.  V is (nS, nv)."""
    nS, nv, nT = n_spot, n_vol, n_time
    f, dev = K.dtype, K.device
    x = grids.linspace(torch.log(K * s_min_mult), torch.log(K * s_max_mult), nS)
    s_grid = torch.exp(x)
    dx = (x[-1] - x[0]) / (nS - 1)
    v_grid = grids.linspace(torch.zeros((), dtype=f, device=dev),
                            torch.full((), v_max, dtype=f, device=dev), nv)
    dv = v_max / (nv - 1)
    dt = T / nT
    th = 0.5  # Douglas parameter

    lam, kbar = jumps.lam, jumps.kbar
    payoff_1d = torch.clamp_min(s_grid - K, 0.0) if is_call else torch.clamp_min(K - s_grid, 0.0)
    payoff = payoff_1d[:, None].expand(nS, nv)

    # the local operator: Heston's with the compensator folded into the
    # x-drift (an effective dividend q + lam kbar) and the intensity added
    # to the discount, split evenly across the two sweeps as -r is
    lo_v, di_v, up_v = _a1_diags(v_grid, dx, r, q + lam * kbar)
    a1_lower, a1_diag, a1_upper = _assemble_a1(nS, nv, lo_v, di_v - 0.5 * lam, up_v)
    a2_lower, a2_diag, a2_upper = _a2_diags(v_grid, dv, kappa, theta, sigma, r)
    # -lam/2 on every PDE row of the v operator (the v_max row is Dirichlet
    # and stays an identity row)
    a2_diag = torch.cat([a2_diag[:-1] - 0.5 * lam, a2_diag[-1:]])
    i1 = (-th * dt * a1_lower, 1.0 - th * dt * a1_diag, -th * dt * a1_upper)  # (nv, nS*)
    i2 = (-th * dt * a2_lower, 1.0 - th * dt * a2_diag, -th * dt * a2_upper)  # (nv*,)

    W = _jump_matrix(jumps, x, dx)      # (nS, nS)
    bu, au = jumps.tail_up(x[-1] - x)   # (nS,)
    bd, ad = jumps.tail_down(x[0] - x)
    # rho and the jump terms reach the right-hand sides, not the bands
    solve_s, solve_v = _sweep_solvers(i1, i2, rho, W, bu, au, bd, ad)
    ii = torch.arange(nS, device=dev)[:, None]
    jj = torch.arange(nv, device=dev)[None, :]
    # the x-boundary rows and the Dirichlet v_max column are reimposed each
    # step: the explicit source stays off them
    source_rows = (ii > 0) & (ii < nS - 1) & (jj < nv - 1)
    one = torch.ones((), dtype=f, device=dev)

    def jump_term(V, tau):
        conv = W @ V
        df_r, df_q = (one, one) if american else (torch.exp(-r * tau), torch.exp(-q * tau))
        if is_call:
            tail = torch.clamp_min(df_q * s_grid * au - df_r * K * bu, 0.0)
        else:
            tail = torch.clamp_min(df_r * K * bd - df_q * s_grid * ad, 0.0)
        return torch.where(source_rows, lam * (conv + tail[:, None]), 0.0)

    def apply_bc(V, tau):
        df_r, df_q = torch.exp(-r * tau), torch.exp(-q * tau)
        if is_call:
            lo, hi, far = 0.0, s_grid[-1] * df_q - K * df_r, s_grid[:, None] * df_q
        else:
            lo, hi, far = K * df_r - s_grid[0] * df_q, 0.0, K * df_r
        V = torch.where(ii == 0, lo, V)
        V = torch.where(ii == nS - 1, hi, V)
        return torch.where(jj == nv - 1, far, V)

    use_it = american and american_method == "it_lcp"
    A0 = lambda V: _apply_a0(V, v_grid, dx, dv, rho, sigma)   # noqa: E731
    A1 = lambda V: _apply_a1(V, a1_lower, a1_diag, a1_upper)  # noqa: E731
    A2 = lambda V: _apply_a2(V, a2_lower, a2_diag, a2_upper)  # noqa: E731

    V = payoff
    lam_it = torch.zeros_like(payoff) if use_it else None
    with _full_fp32_matmul():
        J_prev = jump_term(payoff, 0.0 * dt)  # the first step is Euler
        for k in range(1, nT + 1):
            tau = dt * float(k)
            J_now = jump_term(V, tau)
            # CNAB: Adams-Bashforth extrapolation of the explicit non-local
            # term (Salmi-Toivanen-von Sydow 2014, scheme (14))
            J_ab = 1.5 * J_now - 0.5 * J_prev
            a0V, a1V, a2V = A0(V), A1(V), A2(V)
            acc = a0V + a1V + a2V + J_ab
            if use_it:
                acc = acc + lam_it
            Y0 = V + dt * acc
            Y1 = solve_s(Y0 - th * dt * a1V)
            Vt = solve_v(Y1 - th * dt * a2V)
            if use_it:
                Wv = Vt - dt * lam_it
                V_new = torch.maximum(payoff, Wv)
                lam_it = (V_new - Wv) / dt
                Vt = V_new
            Vt = apply_bc(Vt, tau)
            if american:
                Vt = torch.maximum(Vt, payoff)
            V, J_prev = Vt, J_now
        LV = A0(V) + A1(V) + A2(V) + jump_term(V, 0.0 * dt)

    price = grids.interp_bilinear(s_grid, v_grid, V, S0, v0)
    i = torch.clamp(grids.find_index(s_grid, S0), 1, nS - 2)
    j = torch.clamp(grids.find_index(v_grid, v0), 1, nv - 2)
    # uniform in x = log S: difference in x and convert, Taylor-shifted to
    # the spot, which lies between nodes for even nS (see pide.py); x is
    # absolute log S here
    V_x_i = (V[i + 1, j] - V[i - 1, j]) / (2.0 * dx)
    V_xx_i = (V[i + 1, j] - 2.0 * V[i, j] + V[i - 1, j]) / (dx * dx)
    V_x0 = V_x_i + V_xx_i * (torch.log(S0) - x[i])
    delta = V_x0 / S0
    gamma = (V_xx_i - V_x0) / (S0 * S0)
    dV_dv = (V[i, j + 1] - V[i, j - 1]) / (2.0 * dv)
    vega = 2.0 * torch.sqrt(v0) * T * dV_dv
    return HestonPDEResult(price, delta, gamma, vega, -LV[i, j], V, s_grid, v_grid)


def solve_bates_pide(params: BatesPIDEParams, S0, device=None, dtype=None) -> HestonPDEResult:
    """Solve the Bates PIDE; price and Greeks at ``(S0, v0)``.

    Runs on ``device`` (default: the CUDA card) in ``dtype`` (default: the
    dtype of the tensors among the parameters and ``S0``, else torch's
    default float); the jump parameters are cast to it.
    """
    p = params
    if not isinstance(p.jumps, (MertonJumps, KouJumps)):
        raise TypeError(f"unsupported jump family {type(p.jumps).__name__}")
    if p.american_method not in ("projection", "it_lcp"):
        raise ValueError(f"unknown american_method {p.american_method!r}")
    if p.n_spot < 16 or p.n_vol < 8 or p.n_time < 10:
        raise ValueError("grid too small: need n_spot>=16, n_vol>=8, n_time>=10")
    device = resolve_device(device)
    floats = _params_as_tensors(p, S0, device, dtype)
    return _solve_core(*floats, _cast_jumps(p.jumps, floats[0].dtype, device),
                       is_call=bool(p.is_call),
                       american=bool(p.american), american_method=p.american_method,
                       n_spot=p.n_spot, n_vol=p.n_vol, n_time=p.n_time,
                       s_min_mult=p.s_min_mult, s_max_mult=p.s_max_mult, v_max=p.v_max)
