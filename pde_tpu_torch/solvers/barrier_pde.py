"""Heston barrier-option PDE solver with an absorbing barrier plane (twin
of ``pde_tpu/solvers/barrier_pde.py``).

Continuously monitored knock-outs satisfy the Heston PDE on a domain cut
at the barrier, with V = rebate on the barrier plane.  The vanilla ADI
machinery of :mod:`pde_tpu_torch.solvers.heston_adi` (Douglas splitting,
log-spot coordinates) with four changes:

* the log-spot grid ENDS on the barrier, so the absorbing condition sits
  on a grid plane;
* the v grid is sinh-stretched toward v = 0 (In 't Hout & Foulon 2010,
  section 2.2), the v operator tridiagonal on it with non-uniform weights;
* the far v boundary is a Neumann copy ``V[:, -1] = V[:, -2]``;
* the first ``n_rannacher`` steps run fully implicit (theta = 1) to damp
  the oscillations of the payoff's jump at the barrier (Rannacher start).

Each step is two implicit sweeps, along S (one system a variance level)
and along v (one system an S row, bands shared): on float32 tensors on the
card outside autograd ONE launch of K5 each
(:func:`~pde_tpu_torch.ops.tridiag.tridiagonal_solve`), the implicit and
the Crank-Nicolson steps with bands of their own; elsewhere the factored
Thomas solve.  Knock-ins price by in-out parity against the vanilla
:func:`~pde_tpu_torch.solvers.heston_adi.solve` (European only).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import grids
from ..core.precision import resolve_device, result_dtype, to_tensor
from . import heston_adi
from .heston_adi import (_FLOATS, HestonPDEParams, _a1_diags, _apply_a1, _apply_a2,
                         _assemble_a1, _sweep_solvers)

__all__ = ["BarrierPDEResult", "solve_barrier"]


class BarrierPDEResult(NamedTuple):
    price: torch.Tensor
    delta: torch.Tensor
    gamma: torch.Tensor
    vega: torch.Tensor
    prices: torch.Tensor  # V(S, v) at t=0 on the truncated domain
    spot_grid: torch.Tensor
    vol_grid: torch.Tensor


def _sinh_v_grid(nv, v_max, cluster):
    """v grid stretched toward 0: v_j = c sinh(xi_j), xi uniform, v_0 = 0,
    v_{nv-1} = v_max; ``cluster`` (a 0-d tensor) sets the fine scale."""
    xi_max = torch.arcsinh(v_max / cluster)
    xi = grids.linspace(torch.zeros_like(xi_max), xi_max, nv)
    return cluster * torch.sinh(xi)


def _dv_weights(v_grid):
    """Non-uniform three-point first/second-derivative weights on interior
    nodes: (bm, b0, bp, gm, g0, gp), each (nv-2,)."""
    hm = v_grid[1:-1] - v_grid[:-2]
    hp = v_grid[2:] - v_grid[1:-1]
    hs = hm + hp
    bm = -hp / (hm * hs)
    b0 = (hp - hm) / (hm * hp)
    bp = hm / (hp * hs)
    gm = 2.0 / (hm * hs)
    g0 = -2.0 / (hm * hp)
    gp = 2.0 / (hp * hs)
    return bm, b0, bp, gm, g0, gp


def _a2_diags_nonuniform(v_grid, kappa, theta, sigma, r):
    """The v operator on a non-uniform grid: ``heston_adi._a2_diags``' rows
    with non-uniform weights, central where the row stays an M-matrix and
    first-order upwind where convection dominates.  Diagonals (nv-1,),
    (nv,), (nv-1,) in the grid's dtype; the v_max row is zero."""
    vj = v_grid[1:-1]
    hm = v_grid[1:-1] - v_grid[:-2]
    hp = v_grid[2:] - v_grid[1:-1]
    bm, b0, bp, gm, g0, gp = _dv_weights(v_grid)

    d = 0.5 * sigma * sigma * vj
    c = kappa * (theta - vj)

    lo_c = d * gm + c * bm
    di_c = d * g0 + c * b0
    up_c = d * gp + c * bp
    central_ok = (lo_c >= 0.0) & (up_c >= 0.0)

    up_wind = c > 0.0  # convection pushes toward larger v
    lo_u = d * gm + torch.where(up_wind, 0.0, -c / hm)
    up_u = d * gp + torch.where(up_wind, c / hp, 0.0)
    di_u = d * g0 + torch.where(up_wind, -c / hp, c / hm)

    lo_j = torch.where(central_ok, lo_c, lo_u)
    di_j = torch.where(central_ok, di_c, di_u)
    up_j = torch.where(central_ok, up_c, up_u)

    # v = 0 row: one-sided convection (diffusion vanishes)
    c0 = (kappa * theta / (v_grid[1] - v_grid[0])).reshape(1)
    zero = torch.zeros_like(c0)
    lower = torch.cat([lo_j, zero])
    diag = torch.cat([-c0 - 0.5 * r, di_j - 0.5 * r, zero])
    upper = torch.cat([c0, up_j])
    return lower, diag, upper


def _apply_a0_nonuniform(V, v_grid, dx, rho, sigma):
    """Mixed term rho sigma v V_xv with non-uniform central weights in v."""
    bm, b0, bp, _, _, _ = _dv_weights(v_grid)
    Vx = (V[2:, :] - V[:-2, :]) / (2.0 * dx)  # (nS-2, nv)
    dVx_dv = bm[None, :] * Vx[:, :-2] + b0[None, :] * Vx[:, 1:-1] + bp[None, :] * Vx[:, 2:]
    out = rho * sigma * v_grid[None, 1:-1] * dVx_dv
    return torch.nn.functional.pad(out, (1, 1, 1, 1))


def _barrier_core(kappa, theta, sigma, rho, v0, r, q, T, K, S0, barrier, rebate, *, is_call,
                  direction, n_spot, n_vol, n_time, s_min_mult, s_max_mult, v_max,
                  n_rannacher, rebate_at_hit):
    """The knock-OUT march on the barrier-cut domain: the model and
    contract inputs 0-d tensors of one dtype on one device."""
    nS, nv, nT = n_spot, n_vol, n_time
    dev = K.device
    if direction == "up":
        x = grids.linspace(torch.log(K * s_min_mult), torch.log(barrier), nS)
    else:
        x = grids.linspace(torch.log(barrier), torch.log(K * s_max_mult), nS)
    s_grid = torch.exp(x)
    dx = (x[-1] - x[0]) / (nS - 1)
    # cluster scale: the larger of the spot-variance and mean-reversion levels
    v_grid = _sinh_v_grid(nv, v_max, torch.clamp_min(torch.maximum(v0, theta), 1e-3))
    dt = T / nT
    b_idx = nS - 1 if direction == "up" else 0   # the barrier plane's row
    far_idx = 0 if direction == "up" else nS - 1

    payoff_1d = torch.clamp_min(s_grid - K, 0.0) if is_call else torch.clamp_min(K - s_grid, 0.0)
    ii = torch.arange(nS, device=dev)[:, None]
    # the barrier plane is knocked at expiry too (touch = knock-out)
    V = torch.where(ii == b_idx, rebate, payoff_1d[:, None].expand(nS, nv))

    lo_v, di_v, up_v = _a1_diags(v_grid, dx, r, q)
    a1_lower, a1_diag, a1_upper = _assemble_a1(nS, nv, lo_v, di_v, up_v)   # (nv, nS*)
    a2_lower, a2_diag, a2_upper = _a2_diags_nonuniform(v_grid, kappa, theta, sigma, r)

    def apply_bc(V, tau):
        df_r, df_q = torch.exp(-r * tau), torch.exp(-q * tau)
        reb = rebate if rebate_at_hit else rebate * df_r
        if direction == "up":
            far = 0.0 if is_call else K * df_r - s_grid[0] * df_q
        else:
            far = s_grid[-1] * df_q - K * df_r if is_call else 0.0
        V = torch.where(ii == b_idx, reb, V)
        V = torch.where(ii == far_idx, far, V)
        # the far-v boundary: a Neumann copy, after the planes are set
        return torch.cat([V[:, :-1], V[:, -2:-1]], 1)

    def make_step(th):
        solve_s, solve_v = _sweep_solvers(
            (-th * dt * a1_lower, 1.0 - th * dt * a1_diag, -th * dt * a1_upper),
            (-th * dt * a2_lower, 1.0 - th * dt * a2_diag, -th * dt * a2_upper),
            rho, rebate)   # these reach the right-hand sides, not the bands

        def step(V, tau):
            a0V = _apply_a0_nonuniform(V, v_grid, dx, rho, sigma)
            a1V = _apply_a1(V, a1_lower, a1_diag, a1_upper)
            a2V = _apply_a2(V, a2_lower, a2_diag, a2_upper)
            Y0 = V + dt * (a0V + a1V + a2V)
            Y1 = solve_s(Y0 - th * dt * a1V)
            return apply_bc(solve_v(Y1 - th * dt * a2V), tau)

        return step

    n_r = min(n_rannacher, nT)
    rannacher, crank_nicolson = make_step(1.0), make_step(0.5)
    for k in range(1, nT + 1):
        V = (rannacher if k <= n_r else crank_nicolson)(V, dt * float(k))

    price = grids.interp_bilinear(s_grid, v_grid, V, S0, v0)
    i = torch.clamp(grids.find_index(s_grid, S0), 1, nS - 2)
    j = torch.clamp(grids.find_index(v_grid, v0), 1, nv - 2)
    # S-space stencils on the log grid (the reference's readout)
    delta = (V[i + 1, j] - V[i - 1, j]) / (s_grid[i + 1] - s_grid[i - 1])
    davg = 0.5 * (s_grid[i + 1] - s_grid[i - 1])
    gamma = (V[i + 1, j] - 2.0 * V[i, j] + V[i - 1, j]) / (davg * davg)
    dv_c = v_grid[j + 1] - v_grid[j - 1]
    vega = 2.0 * torch.sqrt(v0) * T * (V[i, j + 1] - V[i, j - 1]) / dv_c
    return BarrierPDEResult(price, delta, gamma, vega, V, s_grid, v_grid)


def solve_barrier(
    params: HestonPDEParams,
    S0,
    barrier,
    barrier_type: str = "up-and-out",
    rebate: float = 0.0,
    n_rannacher: int = 2,
    rebate_at_hit: bool = True,
    device=None,
    dtype=None,
) -> BarrierPDEResult:
    """Price a continuously monitored European barrier option under Heston.

    Knock-outs march on the barrier-cut domain with an absorbing plane;
    knock-ins use in-out parity (the vanilla march on its own domain minus
    the out).  ``rebate`` is paid on knock-out (at hit by default, at expiry
    with ``rebate_at_hit=False``); knock-ins require zero rebate.  A spot
    already beyond the barrier returns the knocked value.  Runs on
    ``device`` (default: the CUDA card) in ``dtype`` (default: the dtype of
    the tensors among the parameters, ``S0``, ``barrier`` and ``rebate``,
    else torch's default float).
    """
    direction, _, inout = barrier_type.partition("-and-")
    if direction not in ("up", "down") or inout not in ("in", "out"):
        raise ValueError(f"unknown barrier_type {barrier_type!r}")
    if params.american:
        raise ValueError("barrier solver is European-only")
    if inout == "in" and rebate:
        raise ValueError("in-out parity requires zero rebate for knock-ins")
    # one host comparison, before any march
    knocked = (float(S0) >= float(barrier)) if direction == "up" else (
        float(S0) <= float(barrier))
    device = resolve_device(device)
    vals = [getattr(params, k) for k in _FLOATS] + [S0, barrier, rebate]
    f = dtype or result_dtype(*vals)
    if inout == "in" and knocked:
        van = heston_adi.solve(params, S0, device=device, dtype=f)
        return BarrierPDEResult(van.price, van.delta, van.gamma, van.vega, van.prices,
                                van.spot_grid, van.vol_grid)
    out = _barrier_core(
        *(to_tensor(a, f, device) for a in vals), is_call=bool(params.is_call),
        direction=direction, n_spot=params.n_spot, n_vol=params.n_vol, n_time=params.n_time,
        s_min_mult=params.s_min_mult, s_max_mult=params.s_max_mult, v_max=params.v_max,
        n_rannacher=n_rannacher, rebate_at_hit=rebate_at_hit)
    if inout == "out":
        if knocked:
            z = to_tensor(rebate, f, device)
            zero = torch.zeros_like(z)
            return out._replace(price=z, delta=zero, gamma=zero, vega=zero)
        return out
    van = heston_adi.solve(params, S0, device=device, dtype=f)
    return BarrierPDEResult(van.price - out.price, van.delta - out.delta,
                            van.gamma - out.gamma, van.vega - out.vega,
                            out.prices, out.spot_grid, out.vol_grid)
