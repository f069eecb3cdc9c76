"""Grid-sharded IMPLICIT PDE marches — CN Black-Scholes and Heston Douglas
ADI (twin of ``pde_tpu/parallel/adi_sharded.py``).

The spot grid axis is split over the mesh's first dimension.  Each time
step, on every rank:

* the explicit stencils (A0 mixed derivative, A1 spot operator) read
  one-row halos from the neighbouring ranks (:func:`.halo._exchange_halos`,
  point-to-point sends and receives);
* the implicit S-sweep — tridiagonal along the SHARDED axis, batched over
  the v levels — runs as the partitioned Thomas solve
  (:func:`.dist_tridiag.partitioned_thomas_spmd`): one batched local solve
  of three right-hand sides, one ``all_gather`` for the small interface
  system, elementwise back substitution;
* the implicit v-sweep is tridiagonal along the LOCAL axis: one batched
  solve of the local rows by ``ops.tridiag.tridiagonal_solve``, no
  communication.

Both sweeps' local solves go through ``tridiagonal_solve``, which on
float32 2D batches on the card is one launch of the hand-written K5
(``csrc/thomas_batched.cu``): two launches a Heston step, one a
Black-Scholes step.  The marches reuse the single-device solvers' helpers
(``solvers/bs_pde``, ``solvers/heston_adi``) and are held against
``solve`` there: equal up to the partitioned elimination's rounding.
Each function returns the global grid and the price and Greeks on every
rank, on the mesh's device, in ``dtype`` (default: the dtype of the tensors
among the parameters and ``S0``, else torch's default float).
"""

from __future__ import annotations

import torch

from ..core import grids
from ..core.precision import result_dtype, to_tensor
from ..ops.tridiag import tridiagonal_solve
from ..solvers.bs_pde import BSPDEParams, BSPDEResult, _operator_coeffs, _readout_1d
from ..solvers.heston_adi import (
    HestonPDEParams,
    HestonPDEResult,
    _a1_diags,
    _a2_diags,
    _assemble_a1,
    _apply_a0,
    _apply_a1,
    _apply_a2,
    _params_as_tensors,
    _readout,
)
from .dist_tridiag import partitioned_thomas_spmd
from .halo import _exchange_halos
from .mesh import all_gather, axis_index, axis_size, mesh_device, using_mesh

__all__ = ["sharded_bs_solve", "sharded_heston_solve"]


def _row_aligned(lower, diag, upper):
    """thomas-convention bands (n-1), (n), (n-1) -> row-aligned a, b, c (n,)."""
    zero = torch.zeros(lower.shape[:-1] + (1,), dtype=diag.dtype, device=diag.device)
    a = torch.cat([zero, lower], dim=-1)
    c = torch.cat([upper, zero], dim=-1)
    return a, diag, c


# --------------------------------------------------------------------------
# 1D Black-Scholes, Crank-Nicolson/implicit, S axis sharded
# --------------------------------------------------------------------------


def sharded_bs_solve(mesh, params: BSPDEParams, S0, dtype=None) -> BSPDEResult:
    """CN/implicit BS march with the spot axis sharded over the mesh.

    Same discretization and boundary treatment as ``solvers/bs_pde.solve``;
    per step the implicit system — tridiagonal along the sharded axis — is
    solved by the partitioned Thomas solve.  ``american_method``
    "projection" only (PSOR's sweeps across shard boundaries are not
    distributed here).
    """
    if params.scheme not in ("crank_nicolson", "implicit"):
        raise ValueError("sharded_bs_solve is the implicit-path demo: use "
                         "scheme 'crank_nicolson' or 'implicit'")
    if params.american and params.american_method != "projection":
        raise ValueError("sharded_bs_solve supports american_method='projection'")
    axis = mesh.mesh_dim_names[0]
    ndev = axis_size(mesh, axis)
    n = params.n_space
    if n % ndev != 0:
        raise ValueError(f"n_space={n} not divisible by mesh size {ndev}")
    dev = mesh_device(mesh)
    floats = (S0, params.sigma, params.r, params.q, params.T, params.K)
    f = dtype or result_dtype(*floats)
    S0, sigma, r, q, T, K = (to_tensor(a, f, dev) for a in floats)
    is_call = bool(params.is_call)

    s_grid = torch.exp(grids.linspace(torch.log(K * params.s_min_mult),
                                      torch.log(K * params.s_max_mult), n))
    dx = torch.log(s_grid[-1] / s_grid[0]) / (n - 1)
    dt = T / params.n_time
    w = {"crank_nicolson": 0.5, "implicit": 1.0}[params.scheme]

    payoff = torch.clamp_min(s_grid - K, 0.0) if is_call else torch.clamp_min(K - s_grid, 0.0)
    L_m, L_c, L_p = _operator_coeffs(BSPDEParams(sigma=sigma, r=r, q=q), dx)
    gi = torch.arange(n, device=dev)
    interior = ((gi > 0) & (gi < n - 1)).to(f)
    # row-aligned explicit operator and implicit (I - w dt L) bands
    La, Lb, Lc = L_m * interior, L_c * interior, L_p * interior
    ia = -w * dt * La
    ib = torch.where(interior > 0, 1.0 - w * dt * L_c, 1.0)
    ic = -w * dt * Lc

    m, idx = n // ndev, axis_index(mesh, axis)
    rows = slice(idx * m, (idx + 1) * m)
    payoff_l, La_l, Lb_l, Lc_l, ia_l, ib_l, ic_l, sg_l = (
        t[rows] for t in (payoff, La, Lb, Lc, ia, ib, ic, s_grid))
    is_first, is_last = idx == 0, idx == ndev - 1
    V = payoff_l
    with using_mesh(mesh):
        for k in range(1, params.n_time + 1):
            tau = dt * float(k)
            lg, rg = _exchange_halos(V, mesh, axis)
            left = torch.cat([lg[None], V[:-1]])
            right = torch.cat([V[1:], rg[None]])
            rhs = V + (1.0 - w) * dt * (La_l * left + Lb_l * V + Lc_l * right)
            V = partitioned_thomas_spmd(ia_l, ib_l, ic_l, rhs, axis).clone()
            # Dirichlet boundaries (discounted over time-to-expiry)
            df_r, df_q = torch.exp(-r * tau), torch.exp(-q * tau)
            if is_first:
                V[0] = 0.0 if is_call else K * df_r - sg_l[0] * df_q
            if is_last:
                V[m - 1] = sg_l[-1] * df_q - K * df_r if is_call else 0.0
            if params.american:
                V = torch.maximum(V, payoff_l)
    V = all_gather(V, mesh, axis)

    flag = lambda b: torch.as_tensor(bool(b), device=dev)  # noqa: E731
    price, delta, gamma, theta, early_ex = _readout_1d(
        V, s_grid, S0, K, sigma, r, q, T, flag(is_call), flag(params.american))
    return BSPDEResult(price, delta, gamma, theta, V, s_grid, early_ex)


# --------------------------------------------------------------------------
# 2D Heston Douglas ADI, S axis sharded
# --------------------------------------------------------------------------


def sharded_heston_solve(mesh, params: HestonPDEParams, S0, dtype=None) -> HestonPDEResult:
    """Heston Douglas ADI march with the spot axis sharded over the mesh.

    Identical scheme and boundaries to ``solvers/heston_adi.solve``
    (Douglas splitting, In 't Hout-Foulon boundaries, projection or
    Ikonen-Toivanen American); the S-implicit sweep family — (nv)
    tridiagonal systems along the sharded axis — runs as the partitioned
    Thomas solve, the v-sweep family stays a local batched solve, and the
    explicit A0/A1 stencils exchange one-row halos.
    """
    axis = mesh.mesh_dim_names[0]
    ndev = axis_size(mesh, axis)
    nS, nv, nT = params.n_spot, params.n_vol, params.n_time
    if nS % ndev != 0:
        raise ValueError(f"n_spot={nS} not divisible by mesh size {ndev}")
    if params.american and params.american_method not in ("projection", "it_lcp"):
        raise ValueError("american_method must be 'projection' or 'it_lcp'")
    if params.scheme != "douglas":
        raise ValueError("sharded march implements the Douglas scheme")

    dev = mesh_device(mesh)
    kappa, theta_p, sigma, rho, v0, r, q, T, K, S0 = _params_as_tensors(params, S0, dev, dtype)
    f = K.dtype
    is_call = bool(params.is_call)
    use_it = params.american and params.american_method == "it_lcp"

    x = grids.linspace(torch.log(K * params.s_min_mult), torch.log(K * params.s_max_mult), nS)
    s_grid = torch.exp(x)
    dx = (x[-1] - x[0]) / (nS - 1)
    v_grid = grids.linspace(torch.zeros((), dtype=f, device=dev),
                            torch.full((), params.v_max, dtype=f, device=dev), nv)
    dv = params.v_max / (nv - 1)
    dt = T / nT
    th = 0.5  # Douglas parameter

    payoff_1d = (torch.clamp_min(s_grid - K, 0.0) if is_call
                 else torch.clamp_min(K - s_grid, 0.0))
    payoff = payoff_1d[:, None].expand(nS, nv)

    # A1 (spot operator): per-v interior constants -> row-aligned (nS, nv)
    lo_v, di_v, up_v = _a1_diags(v_grid, dx, r, q)          # (nv, 1) each
    gi = torch.arange(nS, device=dev)
    interior = ((gi > 0) & (gi < nS - 1)).to(f)[:, None]     # (nS, 1)
    a1a, a1b, a1c = lo_v.T * interior, di_v.T * interior, up_v.T * interior
    i1a = -th * dt * a1a
    i1b = torch.where(interior > 0, 1.0 - th * dt * di_v.T, 1.0).expand(nS, nv)
    i1c = -th * dt * a1c

    # A2 (vol operator): thomas-convention bands shared by every S row
    a2_lower, a2_diag, a2_upper = _a2_diags(v_grid, dv, kappa, theta_p, sigma, r)
    a2a, a2b, a2c = _row_aligned(a2_lower, a2_diag, a2_upper)
    i2_lower, i2_diag, i2_upper = (-th * dt * a2_lower, 1.0 - th * dt * a2_diag,
                                   -th * dt * a2_upper)
    mixed = rho * sigma * v_grid  # (nv,)

    m, idx = nS // ndev, axis_index(mesh, axis)
    rows = slice(idx * m, (idx + 1) * m)
    payoff_l, a1a_l, a1b_l, a1c_l = (t[rows] for t in (payoff, a1a, a1b, a1c))
    # the S systems one a variance level: (nv, m) bands
    i1a_l, i1b_l, i1c_l = (t[rows].T for t in (i1a, i1b, i1c))
    sg_l = s_grid[rows]
    is_first, is_last = idx == 0, idx == ndev - 1
    gidx = idx * m + torch.arange(m, device=dev)
    smask = ((gidx > 0) & (gidx < nS - 1)).to(f)[:, None]

    def apply_a1_local(V, lg, rg):
        left = torch.cat([lg[None], V[:-1]])
        right = torch.cat([V[1:], rg[None]])
        return a1a_l * left + a1b_l * V + a1c_l * right

    def apply_a2_local(V):
        out = V * a2b[None, :]
        out = out + torch.nn.functional.pad(V[:, :-1] * a2a[None, 1:], (1, 0))
        return out + torch.nn.functional.pad(V[:, 1:] * a2c[None, :-1], (0, 1))

    def apply_a0_local(V, lg, rg):
        V_ext = torch.cat([lg[None], V, rg[None]])          # (m+2, nv)
        V_xv = (V_ext[2:, 2:] - V_ext[2:, :-2] - V_ext[:-2, 2:] + V_ext[:-2, :-2]) / (
            4.0 * dx * dv)
        out = mixed[None, 1:-1] * V_xv                       # (m, nv-2)
        return torch.nn.functional.pad(out, (1, 1)) * smask  # zero global-edge rows

    def apply_bc(V, tau):
        df_r, df_q = torch.exp(-r * tau), torch.exp(-q * tau)
        V = V.clone()
        if is_first:
            V[0, :] = 0.0 if is_call else K * df_r - sg_l[0] * df_q
        if is_last:
            V[m - 1, :] = sg_l[-1] * df_q - K * df_r if is_call else 0.0
        V[:, -1] = sg_l * df_q if is_call else K * df_r
        return V

    def adi_step(V, source):
        lg, rg = _exchange_halos(V, mesh, axis)
        a1V = apply_a1_local(V, lg, rg)
        a2V = apply_a2_local(V)
        F = apply_a0_local(V, lg, rg) + a1V + a2V
        if source is not None:
            F = F + source
        Y0 = V + dt * F
        rhs1 = Y0 - th * dt * a1V
        Y1 = partitioned_thomas_spmd(i1a_l, i1b_l, i1c_l, rhs1.T, axis).T
        rhs2 = Y1 - th * dt * a2V
        return tridiagonal_solve(i2_lower, i2_diag, i2_upper, rhs2.contiguous())

    V = payoff_l
    lam = torch.zeros_like(payoff_l) if use_it else None
    with using_mesh(mesh):
        for k in range(1, nT + 1):
            tau = dt * float(k)
            Vt = adi_step(V, lam)
            if use_it:
                W = Vt - dt * lam
                V_new = torch.maximum(payoff_l, W)
                lam = (V_new - W) / dt
                Vt = V_new
            Vt = apply_bc(Vt, tau)
            if params.american and not use_it:
                Vt = torch.maximum(Vt, payoff_l)
            if use_it:
                # the Dirichlet edges are European: floor them at intrinsic
                floor = torch.maximum(Vt, payoff_l)
                edge = torch.zeros_like(Vt, dtype=torch.bool)
                edge[:, 0] = edge[:, -1] = True
                if is_first:
                    edge[0, :] = True
                if is_last:
                    edge[m - 1, :] = True
                Vt = torch.where(edge, floor, Vt)
            V = Vt
    V = all_gather(V, mesh, axis)

    # price and Greeks from the global grid, as heston_adi's scan route
    # reads them (the mean spacing 0.5 (s_{i+1} - s_{i-1}), as the
    # reference's sharded readout)
    a1l, a1d, a1u = _assemble_a1(nS, nv, lo_v, di_v, up_v)
    LV = (_apply_a0(V, v_grid, dx, dv, rho, sigma) + _apply_a1(V, a1l, a1d, a1u)
          + _apply_a2(V, a2_lower, a2_diag, a2_upper))
    one = lambda t: t.reshape(1, *t.shape)  # noqa: E731
    price, delta, gamma, vega, theta_g = (a[0] for a in _readout(
        one(V), one(s_grid), v_grid, dv, one(S0), one(v0), one(T), one(LV),
        split_davg=False))
    return HestonPDEResult(price, delta, gamma, vega, theta_g, V, s_grid, v_grid)
