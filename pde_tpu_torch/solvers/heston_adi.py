"""Heston 2D PDE solver — Douglas ADI in log-spot coordinates (twin of
``pde_tpu/solvers/heston_adi.py``, the fused-batch path).

Boundary treatment (In 't Hout & Foulon 2010): v = 0 is a PDE row with a
one-sided V_v; v = v_max and both S edges are Dirichlet with both
discounts.  In log-spot coordinates on K-scaled grids, dx is the same for
every option, so the S operator depends only on (v_j, option) and a whole
book marches in one kernel launch (:mod:`pde_tpu_torch.ops.adi_fused`).

Port notes: the batch needs no padding to 128-lane blocks (a TPU lane
artifact), and the reference's ``unroll``/``interpret`` arguments (a Mosaic
loop hint and its CPU interpreter) have no counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import grids
from ..core.precision import resolve_device
from ..ops.adi_fused import fused_douglas_march_batched

__all__ = ["HestonPDEResult", "solve_fused_batch"]


class HestonPDEResult(NamedTuple):
    price: torch.Tensor
    delta: torch.Tensor
    gamma: torch.Tensor
    vega: torch.Tensor
    theta: torch.Tensor
    prices: torch.Tensor  # V(S, v) at t=0
    spot_grid: torch.Tensor
    vol_grid: torch.Tensor


def _a1_diags(v_grid, dx, r, q):
    """S-direction (log-coordinate) operator rows for every v level.

    A1 = 0.5 v V_xx + (r - q - 0.5 v) V_x - 0.5 r V on interior rows.
    ``r``/``q`` of shape (..., 1) give a batch.  Returns the interior
    (lower, diag, upper) values, each (..., nv, 1).
    """
    a = 0.5 * v_grid / (dx * dx)  # (nv,)
    b = (r - q - 0.5 * v_grid) / (2.0 * dx)
    return (a - b)[..., None], (-2.0 * a - 0.5 * r)[..., None], (a + b)[..., None]


def _a2_diags(v_grid, dv, kappa, theta, sigma, r):
    """v-direction operator (identical for every S row).

    Interior: 0.5 sigma^2 v V_vv + kappa(theta - v) V_v - 0.5 r V, with the
    convection central where the scheme stays an M-matrix and first-order
    upwind where it would not.  v = 0 row: kappa*theta * one-sided V_v -
    0.5 r V.  v = v_max row: zero (Dirichlet).  Parameters of shape (..., 1)
    give a batch; returns diagonals (..., nv-1), (..., nv), (..., nv-1).
    """
    vj = v_grid[1:-1]
    d = 0.5 * sigma * sigma * vj / (dv * dv)
    adv = kappa * (theta - vj) / (2.0 * dv)

    central_ok = d >= torch.abs(adv)
    up = adv > 0.0  # convection pushes toward larger v
    lo_j = torch.where(central_ok, d - adv, torch.where(up, d, d - 2.0 * adv))
    up_j = torch.where(central_ok, d + adv, torch.where(up, d + 2.0 * adv, d))
    di_j = -(lo_j + up_j)  # row sum zero before the -r/2 discount term

    col = lambda x: torch.as_tensor(x, dtype=d.dtype, device=d.device).expand(*d.shape[:-1], 1)  # noqa: E731
    zero = col(0.0)
    # v = 0 boundary row: first-order one-sided convection (diffusion is 0)
    c = col(kappa * theta / dv)
    rr = col(r)
    lower = torch.cat([lo_j, zero], dim=-1)
    diag = torch.cat([-c - 0.5 * rr, di_j - 0.5 * rr, zero], dim=-1)
    upper = torch.cat([c, up_j], dim=-1)
    return lower, diag, upper


def _assemble_a1(nS, nv, lo_val, di_val, up_val):
    """Expand per-level constants into batched tridiagonals (..., nv, nS*)."""
    ar = torch.arange(nS, device=lo_val.device)
    interior = ((ar > 0) & (ar < nS - 1)).to(lo_val.dtype)
    lower = lo_val.expand(*lo_val.shape[:-2], nv, nS - 1) * interior[1:]
    diag = di_val.expand(*di_val.shape[:-2], nv, nS) * interior
    upper = up_val.expand(*up_val.shape[:-2], nv, nS - 1) * interior[:-1]
    return lower, diag, upper


def _apply_a1(V, lower, diag, upper):
    """A1 V with the batched-diagonal representation (systems along the S
    axis, -2, of V)."""
    out = diag.transpose(-1, -2) * V
    out[..., 1:, :] += lower.transpose(-1, -2) * V[..., :-1, :]
    out[..., :-1, :] += upper.transpose(-1, -2) * V[..., 1:, :]
    return out


def _apply_a2(V, lower, diag, upper):
    """A2 V, acting along the v axis (-1); same diagonals for all rows."""
    out = V * diag[..., None, :]
    out[..., :, 1:] += V[..., :, :-1] * lower[..., None, :]
    out[..., :, :-1] += V[..., :, 1:] * upper[..., None, :]
    return out


def _apply_a0(V, v_grid, dx, dv, rho, sigma):
    """Mixed-derivative term rho sigma v V_xv (explicit only); ``rho`` and
    ``sigma`` of shape (..., 1, 1) give a batch."""
    V_xv = (V[..., 2:, 2:] - V[..., 2:, :-2] - V[..., :-2, 2:] + V[..., :-2, :-2]) / (4.0 * dx * dv)
    out = rho * sigma * v_grid[None, 1:-1] * V_xv
    return torch.nn.functional.pad(out, (1, 1, 1, 1))


def np_any_flag(arr) -> bool:
    """Host-side any() on a flag array: the flag selects a kernel variant,
    so it resolves before the march is launched."""
    if isinstance(arr, torch.Tensor):
        return bool(torch.any(arr > 0.5))
    return bool(np.any(np.asarray(arr) > 0.5))


def _broadcast_batch(kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
                     american, device):
    """Every argument as a float32 (n,) tensor on ``device``."""
    vals = [torch.atleast_1d(torch.as_tensor(a, device=device).to(torch.float32))
            for a in (kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
                      american)]
    n = max(a.shape[0] for a in vals)
    return tuple(a.expand(n).contiguous() for a in vals)


def _march_inputs(kappa, theta, sigma, rho, r, q, T, K, is_call, american,
                  n_spot, n_vol, n_time, s_min_mult, s_max_mult, v_max):
    """The fused march's inputs for a book of (B,) float32 tensors, in the
    kernel's public layout: ``(pay, sg, a1, i1, a2, i2, mix, sc)``, plus the
    shared v grid."""
    nS, nv, nT = n_spot, n_vol, n_time
    B = kappa.shape[0]
    th = 0.5
    f32, dev = torch.float32, kappa.device

    # K-scaled log-spot grid: x = ln(S/K) is SHARED across the batch, so dx
    # (and the S-operator lattice coefficients) are option-independent.
    # Both grids are spaced in float64 and rounded once.
    x = torch.linspace(math.log(s_min_mult), math.log(s_max_mult), nS,
                       dtype=torch.float64, device=dev).to(f32)
    dx = _dx(nS, s_min_mult, s_max_mult)
    ex = torch.exp(x)                                     # (nS,)
    v_grid = torch.linspace(0.0, v_max, nv, dtype=torch.float64, device=dev).to(f32)
    dv = v_max / (nv - 1)
    dt = T / nT                                           # (B,)

    sg = ex[:, None] * K[None, :]                         # (nS, B)
    pay = torch.where(
        is_call[None, :] > 0.5,
        torch.clamp_min(ex - 1.0, 0.0)[:, None] * K[None, :],
        torch.clamp_min(1.0 - ex, 0.0)[:, None] * K[None, :],
    )

    # explicit S-operator interior coefficients, (nv, B)
    a = 0.5 * v_grid[:, None] / (dx * dx)                 # (nv, 1)
    bb = (r - q - 0.5 * v_grid[:, None]) / (2.0 * dx)     # (nv, B)
    a1 = torch.stack([a - bb, -2.0 * a - 0.5 * r[None, :], a + bb])   # (3,nv,B)
    i1 = torch.stack([
        -th * dt[None, :] * a1[0],
        1.0 - th * dt[None, :] * a1[1],
        -th * dt[None, :] * a1[2],
    ])

    # v-operator bands per option, row-aligned
    a2lo, a2di, a2up = _a2_diags(v_grid, dv, kappa[:, None], theta[:, None],
                                 sigma[:, None], r[:, None])  # (B, nv-1/nv/nv-1)

    def v_align(lower, diag, upper):
        zero = torch.zeros((B, 1), dtype=f32, device=dev)
        return torch.stack([torch.cat([zero, lower], 1).T, diag.T,
                            torch.cat([upper, zero], 1).T])

    a2 = v_align(a2lo, a2di, a2up)                        # (3, nv, B)
    i2 = v_align(-th * dt[:, None] * a2lo, 1.0 - th * dt[:, None] * a2di,
                 -th * dt[:, None] * a2up)

    mix = (rho * sigma / (4.0 * dx * dv))[None, :] * v_grid[:, None]  # (nv, B)
    mix[nv - 1, :] = 0.0                                  # j = nv-1 is Dirichlet

    zeros = torch.zeros((B,), dtype=f32, device=dev)
    sc = torch.stack([dt, r, q, K, is_call, american, zeros, zeros])  # (8, B)
    return (pay[:, None, :], sg[:, None, :], a1, i1, a2, i2, mix[None],
            sc[:, None, :]), v_grid


def _dx(nS, s_min_mult, s_max_mult):
    return (math.log(s_max_mult) - math.log(s_min_mult)) / (nS - 1)


def _fused_batch_impl(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0, american,
    use_it, n_spot, n_vol, n_time, s_min_mult, s_max_mult, v_max,
):
    """Build the book's operator bands, march it, read out price and Greeks.
    All inputs are (B,) float32 tensors on one device."""
    nS, nv = n_spot, n_vol
    B = kappa.shape[0]
    args, v_grid = _march_inputs(kappa, theta, sigma, rho, r, q, T, K, is_call,
                                 american, n_spot, n_vol, n_time, s_min_mult,
                                 s_max_mult, v_max)
    V = fused_douglas_march_batched(*args, n_spot=nS, n_vol=nv, n_time=n_time,
                                    use_it=use_it)       # (nS, nv, B)
    dx = _dx(nS, s_min_mult, s_max_mult)
    dv = v_max / (nv - 1)

    # price + Greeks per option on its own grid (as the reference's
    # heston_pde.hpp:481-559)
    Vt = V.permute(2, 0, 1)                               # (B, nS, nv)
    sgT = args[1][:, 0, :].T.contiguous()                 # (B, nS)
    price = grids.interp_bilinear(sgT, v_grid, Vt, S0, v0)
    i = torch.clamp(grids.find_index(sgT, S0), 1, nS - 2)
    j = torch.clamp(grids.find_index(v_grid, v0), 1, nv - 2)
    at = lambda di, dj: grids.take2(Vt, i + di, j + dj)  # noqa: E731
    s_at = lambda di: grids.take(sgT, i + di)            # noqa: E731
    delta = (at(1, 0) - at(-1, 0)) / (s_at(1) - s_at(-1))
    davg = 0.5 * (s_at(1) - s_at(-1))
    gamma = (at(1, 0) - 2.0 * at(0, 0) + at(-1, 0)) / (davg * davg)
    dV_dv = (at(0, 1) - at(0, -1)) / (2.0 * dv)
    vega = 2.0 * torch.sqrt(v0) * T * dV_dv
    # theta from the PDE: V_t = -(A0 + A1 + A2) V
    lo_v, di_v, up_v = _a1_diags(v_grid, dx, r[:, None], q[:, None])
    a1l, a1d, a1u = _assemble_a1(nS, nv, lo_v, di_v, up_v)
    a2l, a2d, a2u = _a2_diags(v_grid, dv, kappa[:, None], theta[:, None],
                              sigma[:, None], r[:, None])
    LV = (_apply_a0(Vt, v_grid, dx, dv, rho[:, None, None], sigma[:, None, None])
          + _apply_a1(Vt, a1l, a1d, a1u) + _apply_a2(Vt, a2l, a2d, a2u))
    theta_g = -grids.take2(LV, i, j)
    return HestonPDEResult(price, delta, gamma, vega, theta_g, Vt, sgT,
                           v_grid.expand(B, nv))


def solve_fused_batch(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
    american=False,
    american_method: str = "projection",
    n_spot: int = 100,
    n_vol: int = 50,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    v_max: float = 1.0,
    pcr_v: bool = False,
    pcr_s: bool = False,
    device=None,
) -> HestonPDEResult:
    """Batch PDE pricing through the fused Douglas march.

    Every array argument broadcasts along one leading batch axis, and
    ``is_call`` and ``american`` are per-option: a book may mix strikes,
    maturities, rates, Heston parameters, calls and puts, European and
    American.  ``american_method`` selects the projection or the
    Ikonen-Toivanen treatment for the flagged options.  The book marches on
    ``device`` (default: the CUDA card; ``device="cpu"`` runs the plain
    march) in float32; on a CUDA device the march is one kernel launch.

    Greeks: delta/gamma/vega/theta from the grid (heston_pde.hpp:520-559).
    ``pcr_v``/``pcr_s`` (the reference's parallel-cyclic-reduction sweep
    variants) are not ported yet and raise ``NotImplementedError``.
    """
    if american_method not in ("projection", "it_lcp"):
        raise ValueError(
            "solve_fused_batch supports american_method 'projection' or "
            "'it_lcp'"
        )
    if pcr_v or pcr_s:
        raise NotImplementedError("the PCR sweep variants (pcr_v, pcr_s) are "
                                  "not yet ported")
    device = resolve_device(device)
    # the kernel variant resolves from the CALLER's american argument, so
    # both packages pick the same variant for the same inputs
    use_it = american_method == "it_lcp" and np_any_flag(american)
    args = _broadcast_batch(kappa, theta, sigma, rho, v0, r, q, T, K, is_call,
                            S0, american, device)
    return _fused_batch_impl(
        *args, use_it, n_spot, n_vol, n_time, s_min_mult, s_max_mult, v_max,
    )
