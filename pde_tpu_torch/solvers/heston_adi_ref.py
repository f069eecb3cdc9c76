"""The C++ reference's Heston ADI scheme, defects included (twin of
``pde_tpu/solvers/heston_adi_ref.py``).

This module reproduces ``quant::solvers::HestonPDESolver``
(src/cpp/solvers/heston_pde.hpp:103-559) to float64 round-off, as the
parity oracle held against ``tests/golden/reference_pde_values.json``.  It
exists for parity tests and scheme comparison only; price with
:mod:`pde_tpu_torch.solvers.heston_adi`, whose Douglas scheme with In 't
Hout-Foulon boundaries converges to the semi-analytic price.

The reference's behaviours it replicates on purpose:

1. **The Craig-Sneyd correction is a no-op** (heston_pde.hpp:204,245-248):
   ``theta_adi = 0.5`` makes the correction term ``(0.5 - theta_adi) dt
   (F0(Y2) - F0(V))`` exactly zero, so the step is Douglas; the zero term
   is not computed.
2. **Implicit/explicit v-advection mismatch** (:395-407 against :427-436):
   the implicit v-matrix upwinds the kappa (theta - v) advection, the
   explicit ``A2(V^n)`` on the right-hand side uses central differences.
3. **Boundary discounting over calendar time** (:153-154, :444-479): the
   Dirichlet S-boundaries discount K over t = (n_time - step - 1) dt, which
   reaches no discount at t = 0, and the S_max call boundary carries no
   dividend discount on the S leg.
4. **v-boundary linear extrapolation** applied after the S rows, so the
   corners take the extrapolated value.
5. **Nearest-index clamped readout** (:481-505): ``find_index`` returns the
   nearest grid point and the bilinear weights are clamped to [0, 1], so a
   spot nearer its left neighbour reads the grid-point value.  A midpoint
   tie goes to the right-hand point, as ``Grid1D::find_index``'s strict
   ``<`` sends it (:func:`_nearest_index`).
6. **Greeks from nearest-index stencils** (:507-533, :535-547): delta and
   gamma at the nearest (i, j), vega by the ``2 sqrt(v0) T dV/dv`` chain
   rule.

The march runs in float64 (the reference's precision) on the caller's
device, the card by default.  Its two implicit sweeps solve an (nv - 2,
nS) and an (nS - 2, nv) batch a step through
:func:`pde_tpu_torch.ops.tridiag.tridiagonal_solve`, whose float64 route is
the plain Thomas recurrence.
"""

from __future__ import annotations

import torch

from ..core import grids
from ..core.precision import resolve_device
from ..ops.tridiag import tridiagonal_solve
from .heston_adi import HestonPDEParams, HestonPDEResult

__all__ = ["solve_reference"]


def _nearest_index(grid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Grid1D::find_index (pde_core.hpp:101-118): the nearest grid point,
    a tie to the right."""
    n = grid.shape[0]
    lo = torch.clamp(torch.searchsorted(grid, x.reshape(1), right=True)[0] - 1, 0, n - 2)
    nearest = torch.where(x - grid[lo] < grid[lo + 1] - x, lo, lo + 1)
    return torch.where(x <= grid[0], 0, torch.where(x >= grid[-1], n - 1, nearest))


def _solve_ref(kappa, theta, sigma, rho, v0, r, q, T, K, S0,
               s_min_mult, s_max_mult, v_max,
               n_spot, n_vol, n_time, is_call, american, device):
    nS, nv = n_spot, n_vol
    f64 = dict(dtype=torch.float64, device=device)
    kappa, theta, sigma, rho, v0, r, q, T, K, S0 = (
        torch.as_tensor(a, **f64) for a in (kappa, theta, sigma, rho, v0, r, q, T, K, S0))

    S = torch.exp(grids.linspace(torch.log(K * s_min_mult), torch.log(K * s_max_mult), nS))
    v = grids.linspace(torch.tensor(1e-6, **f64), torch.tensor(float(v_max), **f64), nv)

    dS_m = S[1:-1] - S[:-2]        # (nS-2,)
    dS_p = S[2:] - S[1:-1]
    dS_avg = 0.5 * (dS_m + dS_p)
    dv_m = v[1:-1] - v[:-2]        # (nv-2,)
    dv_p = v[2:] - v[1:-1]
    dv_avg = 0.5 * (dv_m + dv_p)

    dt = T / n_time
    theta_adi = 0.5

    payoff_S = torch.clamp_min(S - K, 0.0) if is_call else torch.clamp_min(K - S, 0.0)
    payoff = payoff_S[:, None].expand(nS, nv)

    Si = S[1:-1][:, None]          # (nS-2, 1) interior spot
    vj = v[1:-1][None, :]          # (1, nv-2) interior variance

    def interior(V, out):
        full = torch.zeros_like(V)
        full[1:-1, 1:-1] = out
        return full

    def full_operator(V):
        """compute_full_operator (heston_pde.hpp:254-297); zero on the boundary."""
        Vc = V[1:-1, 1:-1]
        V_SS = ((V[2:, 1:-1] - Vc) / dS_p[:, None]
                - (Vc - V[:-2, 1:-1]) / dS_m[:, None]) / dS_avg[:, None]
        V_vv = ((V[1:-1, 2:] - Vc) / dv_p[None, :]
                - (Vc - V[1:-1, :-2]) / dv_m[None, :]) / dv_avg[None, :]
        V_S = (V[2:, 1:-1] - V[:-2, 1:-1]) / (dS_m + dS_p)[:, None]
        V_v = (V[1:-1, 2:] - V[1:-1, :-2]) / (dv_m + dv_p)[None, :]
        V_Sv = (V[2:, 2:] - V[2:, :-2] - V[:-2, 2:] + V[:-2, :-2]) / (
            (dS_m + dS_p)[:, None] * (dv_m + dv_p)[None, :])
        return interior(V, 0.5 * vj * Si * Si * V_SS
                        + rho * sigma * vj * Si * V_Sv
                        + 0.5 * sigma * sigma * vj * V_vv
                        + (r - q) * Si * V_S
                        + kappa * (theta - vj) * V_v
                        - r * Vc)

    # ---- S-direction operator (heston_pde.hpp:300-366), batched over j ----
    diff_S = 0.5 * vj.T * (Si.T ** 2)               # (nv-2, nS-2): 0.5 v S^2
    a_m_S = diff_S / (dS_m * dS_avg)[None, :]
    a_p_S = diff_S / (dS_p * dS_avg)[None, :]
    a_c_S = -(a_m_S + a_p_S)
    adv_S = (r - q) * Si.T                           # (1, nS-2)
    b_m_S = -adv_S / (dS_m + dS_p)[None, :]
    b_p_S = adv_S / (dS_m + dS_p)[None, :]

    dtt = dt * theta_adi
    # tridiagonal bands, identity boundary rows (build_S_operator :334-338)
    diag_S = torch.ones(nv - 2, nS, **f64)
    diag_S[:, 1:-1] += -dtt * a_c_S
    lower_S = torch.zeros(nv - 2, nS - 1, **f64)
    lower_S[:, :-1] = -dtt * (a_m_S + b_m_S)
    upper_S = torch.zeros(nv - 2, nS - 1, **f64)
    upper_S[:, 1:] = -dtt * (a_p_S + b_p_S)

    def apply_A1(V):
        """apply_S_operator (:344-366): diff V_SS + adv V_S, no -rV."""
        Vc = V[1:-1, 1:-1]
        V_SS = ((V[2:, 1:-1] - Vc) / dS_p[:, None]
                - (Vc - V[:-2, 1:-1]) / dS_m[:, None]) / dS_avg[:, None]
        V_S = (V[2:, 1:-1] - V[:-2, 1:-1]) / (dS_m + dS_p)[:, None]
        return interior(V, 0.5 * vj * Si * Si * V_SS + (r - q) * Si * V_S)

    # ---- v-direction operator (:369-416), batched over i ----
    diff_v = 0.5 * sigma * sigma * vj                # (1, nv-2)
    a_m_v = diff_v / (dv_m * dv_avg)[None, :]
    a_p_v = diff_v / (dv_p * dv_avg)[None, :]
    a_c_v = -(a_m_v + a_p_v)
    adv_v = kappa * (theta - vj)                     # (1, nv-2)
    pos = adv_v >= 0
    zero = torch.zeros((), **f64)
    b_m_v = torch.where(pos, -adv_v / dv_m[None, :], zero)
    b_p_v = torch.where(pos, zero, -adv_v / dv_p[None, :])
    b_c_v = -b_m_v - b_p_v

    ones_i = torch.ones(nS - 2, 1, **f64)
    diag_v = torch.ones(nS - 2, nv, **f64)
    diag_v[:, 1:-1] += -dtt * (a_c_v + b_c_v - r) * ones_i
    lower_v = torch.zeros(nS - 2, nv - 1, **f64)
    lower_v[:, :-1] = -dtt * (a_m_v + b_m_v) * ones_i
    upper_v = torch.zeros(nS - 2, nv - 1, **f64)
    upper_v[:, 1:] = -dtt * (a_p_v + b_p_v) * ones_i

    def apply_A2(V):
        """apply_v_operator (:419-441): CENTRAL advection and -rV (the
        mismatch with the upwinded implicit matrix, behaviour 2)."""
        Vc = V[1:-1, 1:-1]
        V_vv = ((V[1:-1, 2:] - Vc) / dv_p[None, :]
                - (Vc - V[1:-1, :-2]) / dv_m[None, :]) / dv_avg[None, :]
        V_v = (V[1:-1, 2:] - V[1:-1, :-2]) / (dv_m + dv_p)[None, :]
        return interior(V, diff_v * V_vv + adv_v * V_v - r * Vc)

    def adi_step(V):
        Y0 = V + dt * full_operator(V)
        # implicit S-sweep a interior j (heston_pde.hpp:217-228)
        rhs1 = (Y0 - dtt * apply_A1(V))[:, 1:-1].T.contiguous()        # (nv-2, nS)
        Y1 = Y0.clone()
        Y1[:, 1:-1] = tridiagonal_solve(lower_S, diag_S, upper_S, rhs1).T
        # implicit v-sweep a interior i (:231-242)
        rhs2 = (Y1 - dtt * apply_A2(V))[1:-1, :].contiguous()          # (nS-2, nv)
        Y2 = Y1.clone()
        Y2[1:-1, :] = tridiagonal_solve(lower_v, diag_v, upper_v, rhs2)
        # the correction step (:245-248) multiplies by (0.5 - theta_adi) == 0
        return Y2

    def apply_bc(V, t_cal):
        df = torch.exp(-r * t_cal)
        if is_call:
            V[0, :] = 0.0
            V[-1, :] = S[-1] - K * df
        else:
            V[0, :] = K * df - S[0]
            V[-1, :] = 0.0
        V[:, 0] = 2.0 * V[:, 1] - V[:, 2]
        V[:, -1] = 2.0 * V[:, -2] - V[:, -3]
        return V

    V = payoff.clone()
    for step in range(n_time - 1, -1, -1):
        V = adi_step(V)
        if american:
            V = torch.maximum(V, payoff)
        V = apply_bc(V, dt * float(step))

    # ---- nearest-index clamped bilinear readout (:481-505) ----
    i_n = torch.clamp(_nearest_index(S, S0), 1, nS - 2)
    j_n = torch.clamp(_nearest_index(v, v0), 1, nv - 2)
    t_S = torch.clamp((S0 - S[i_n - 1]) / (S[i_n] - S[i_n - 1]), 0.0, 1.0)
    t_v = torch.clamp((v0 - v[j_n - 1]) / (v[j_n] - v[j_n - 1]), 0.0, 1.0)
    price = ((1 - t_S) * (1 - t_v) * V[i_n - 1, j_n - 1]
             + t_S * (1 - t_v) * V[i_n, j_n - 1]
             + (1 - t_S) * t_v * V[i_n - 1, j_n]
             + t_S * t_v * V[i_n, j_n])

    # ---- Greeks at the nearest indices (:507-559) ----
    jg = _nearest_index(v, v0)
    ig = torch.clamp(_nearest_index(S, S0), 1, nS - 2)
    delta = (V[ig + 1, jg] - V[ig - 1, jg]) / (S[ig + 1] - S[ig - 1])
    dSm = S[ig] - S[ig - 1]
    dSp = S[ig + 1] - S[ig]
    dSa = 0.5 * (dSm + dSp)
    gamma = (V[ig + 1, jg] - 2 * V[ig, jg] + V[ig - 1, jg]) / (dSa * dSa)
    jv = torch.clamp(jg, 1, nv - 2)
    dV_dv = (V[ig, jv + 1] - V[ig, jv - 1]) / (v[jv + 1] - v[jv - 1])
    vega = 2.0 * torch.sqrt(v0) * T * dV_dv
    theta_greek = -full_operator(V)[ig, jg]

    return HestonPDEResult(price=price, delta=delta, gamma=gamma, vega=vega,
                           theta=theta_greek, prices=V, spot_grid=S, vol_grid=v)


def solve_reference(params: HestonPDEParams, S0, device=None) -> HestonPDEResult:
    """Solve with the reference's exact scheme (defects included), in
    float64 on ``device`` (the card when ``None``).

    The parity oracle of tests/golden/reference_pde_values.json; the module
    docstring lists the replicated behaviours.  The ``scheme`` and
    ``american_method`` fields of ``params`` are ignored: the reference has
    one scheme and projection-only American handling.
    """
    return _solve_ref(
        params.kappa, params.theta, params.sigma, params.rho, params.v0,
        params.r, params.q, params.T, params.K, S0,
        params.s_min_mult, params.s_max_mult, params.v_max,
        int(params.n_spot), int(params.n_vol), int(params.n_time),
        bool(params.is_call), bool(params.american), resolve_device(device),
    )
