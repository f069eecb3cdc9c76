"""Plain reference of the Heston book: the Douglas ADI march (theta = 1/2)
of each option on its own K-scaled grid, and its price and grid Greeks.

The scheme is the configuration's (In 't Hout & Foulon 2010, the
reference's heston_pde.hpp:56-61 grid): x = ln(S/K) uniform on
[ln s_min, ln s_max], v uniform on [0, v_max]; A1 = 0.5 v V_xx + (r - q -
0.5 v) V_x - 0.5 r V on interior S rows; A2 = 0.5 sigma^2 v V_vv + kappa
(theta - v) V_v - 0.5 r V with central convection where that keeps an
M-matrix and first-order upwind where not, kappa theta times a one-sided
V_v at v = 0, and nothing at v = v_max; A0 = rho sigma v V_xv on interior
nodes.  A step: Y0 = V + dt (A0 + A1 + A2) V, then (I - dt/2 A1) Y1 = Y0 -
dt/2 A1 V and (I - dt/2 A2) V' = Y1 - dt/2 A2 V, then the Dirichlet rows
(S edges, then v = v_max) at the new time to expiry with both discounts.
The readout: price by bilinear interpolation at (S0, v0); delta, gamma,
vega and theta by central differences at the nearest interior node.

Arrays are (nS, nv, B); every operation runs in ``dtype`` (float64 for
the reference, bfloat16 for its control).
"""

from __future__ import annotations

import math

import torch

from .readout import bracket, nearest

TH = 0.5
FIELDS = ("price", "delta", "gamma", "vega", "theta")


def _thomas_factor(lo, di, up):
    """Factors (c, 1/pivot) of tridiagonal systems along axis 0: ``lo[i]``
    multiplies x[i-1], ``up[i]`` x[i+1] (``lo[0]``, ``up[-1]`` unused)."""
    n = di.shape[0]
    c, inv = torch.empty_like(di), torch.empty_like(di)
    inv[0] = 1.0 / di[0]
    c[0] = up[0] * inv[0]
    for i in range(1, n):
        inv[i] = 1.0 / (di[i] - lo[i] * c[i - 1])
        c[i] = up[i] * inv[i]
    return c, inv


def _thomas_solve(lo, c, inv, rhs):
    n = rhs.shape[0]
    d = torch.empty_like(rhs)
    d[0] = rhs[0] * inv[0]
    for i in range(1, n):
        d[i] = (rhs[i] - lo[i] * d[i - 1]) * inv[i]
    x = torch.empty_like(rhs)
    x[n - 1] = d[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = d[i] - c[i] * x[i + 1]
    return x


def solve(book: dict, grid: dict, r: float, q: float, dtype=torch.float64) -> dict:
    """Price and Greeks (B,) of every option of ``book`` (the benchmark's
    (B,) inputs: kappa, theta, sigma, rho, v0, S0, K, T, is_call), on the
    configuration's ``grid`` (n_spot, n_vol, n_time, s_min_mult,
    s_max_mult, v_max), computed in ``dtype``; results as float64."""
    f = dtype
    kappa, theta, sigma, rho, v0, S0, K, T, call = (
        book[k].to(f) for k in ("kappa", "theta", "sigma", "rho", "v0", "S0", "K", "T", "is_call"))
    dev = K.device
    nS, nv, nT = grid["n_spot"], grid["n_vol"], grid["n_time"]
    B = K.shape[0]
    lo_x, hi_x = math.log(grid["s_min_mult"]), math.log(grid["s_max_mult"])
    dx = (hi_x - lo_x) / (nS - 1)
    dv = grid["v_max"] / (nv - 1)
    x = (lo_x + dx * torch.arange(nS, dtype=torch.float64, device=dev)).to(f)
    s = torch.exp(x)[:, None] * K[None, :]                       # (nS, B)
    v = (dv * torch.arange(nv, dtype=torch.float64, device=dev)).to(f)
    dt = T / nT                                                  # (B,)
    is_call = call > 0.5

    # A1 interior coefficients, (nv, B)
    a = (0.5 * v / (dx * dx))[:, None]
    b = (r - q - 0.5 * v[:, None]) / (2.0 * dx)
    l1, d1, u1 = a - b, -2.0 * a - 0.5 * r, a + b
    l1, d1, u1 = (t.expand(nv, B) for t in (l1, d1, u1))
    # A2 coefficients, (nv, B): lower, diagonal, upper of row j
    vj = v[1:-1, None]
    dif = 0.5 * sigma * sigma * vj / (dv * dv)
    adv = kappa * (theta - vj) / (2.0 * dv)
    central = dif >= adv.abs()
    lo_j = torch.where(central, dif - adv, torch.where(adv > 0, dif, dif - 2.0 * adv))
    up_j = torch.where(central, dif + adv, torch.where(adv > 0, dif + 2.0 * adv, dif))
    zero = torch.zeros((1, B), dtype=f, device=dev)
    cv = (kappa * theta / dv)[None, :]
    l2 = torch.cat([zero, lo_j, zero])
    d2 = torch.cat([-cv - 0.5 * r, -(lo_j + up_j) - 0.5 * r, zero])
    u2 = torch.cat([cv, up_j, zero])
    mix = (rho * sigma)[None, :] * v[:, None] / (4.0 * dx * dv)  # (nv, B)

    def A1(V):
        out = torch.zeros_like(V)
        out[1:-1] = l1 * V[:-2] + d1 * V[1:-1] + u1 * V[2:]
        return out

    def A2(V):
        out = d2 * V
        out[:, 1:] += l2[1:] * V[:, :-1]
        out[:, :-1] += u2[:-1] * V[:, 1:]
        return out

    def A0(V):
        out = torch.zeros_like(V)
        out[1:-1, 1:-1] = mix[1:-1] * (V[2:, 2:] - V[2:, :-2] - V[:-2, 2:] + V[:-2, :-2])
        return out

    # implicit systems, both time-independent: factor once
    hdt = TH * dt                                                # (B,)
    ones = torch.ones((1, nv, B), dtype=f, device=dev)
    zs = torch.zeros((1, nv, B), dtype=f, device=dev)
    s_lo = torch.cat([zs, (-hdt * l1).expand(nS - 2, nv, B), zs])
    s_di = torch.cat([ones, (1.0 - hdt * d1).expand(nS - 2, nv, B), ones])
    s_up = torch.cat([zs, (-hdt * u1).expand(nS - 2, nv, B), zs])
    s_c, s_inv = _thomas_factor(s_lo, s_di, s_up)
    v_lo, v_di, v_up = -hdt * l2, 1.0 - hdt * d2, -hdt * u2     # (nv, B)
    v_c, v_inv = _thomas_factor(v_lo, v_di, v_up)

    pay = torch.where(is_call[None, :], torch.clamp_min(s - K, 0.0),
                      torch.clamp_min(K - s, 0.0))               # (nS, B)
    V = pay[:, None, :].expand(nS, nv, B).clone()
    for k in range(nT):
        a0, a1, a2 = A0(V), A1(V), A2(V)
        Y0 = V + dt * (a0 + a1 + a2)
        Y1 = _thomas_solve(s_lo, s_c, s_inv, Y0 - hdt * a1)
        Vn = _thomas_solve(v_lo, v_c, v_inv, (Y1 - hdt * a2).transpose(0, 1)).transpose(0, 1)
        tau = dt * float(k + 1)
        dfr, dfq = torch.exp(-r * tau), torch.exp(-q * tau)
        Vn = Vn.clone()
        Vn[0] = torch.where(is_call, 0.0, K * dfr - s[0] * dfq)[None, :]
        Vn[nS - 1] = torch.where(is_call, s[-1] * dfq - K * dfr, 0.0)[None, :]
        Vn[:, nv - 1] = torch.where(is_call[None, :], s * dfq, (K * dfr)[None, :])
        V = Vn

    LV = A0(V) + A1(V) + A2(V)
    return _readout(V, LV, s, v, dv, S0, v0, T)


def _readout(V, LV, s, v, dv, S0, v0, T) -> dict:
    """Price and Greeks at (S0, v0); each Greek at the nearest node, and at
    the other node of a tie under ``alt_*`` keys."""
    nS, nv, B = V.shape
    b = torch.arange(B, device=V.device)
    sT = s.T.contiguous()                                        # (B, nS)
    hi, tx = bracket(sT, S0)
    hj, ty = bracket(v, v0)
    at = lambda i, j: V[i, j, b]                                 # noqa: E731
    price = ((1 - tx) * (1 - ty) * at(hi - 1, hj - 1) + tx * (1 - ty) * at(hi, hj - 1)
             + (1 - tx) * ty * at(hi - 1, hj) + tx * ty * at(hi, hj))
    out = {"price": price}
    (i, i_alt), (j, j_alt) = nearest(sT, S0), nearest(v, v0)
    for tag, (ii, jj) in (("", (i, j)), ("alt_", (i_alt, j_alt))):
        sa = lambda d: sT[b, ii + d]                             # noqa: E731
        va = lambda di, dj: V[ii + di, jj + dj, b]               # noqa: E731
        davg = 0.5 * (sa(1) - sa(-1))
        out[tag + "delta"] = (va(1, 0) - va(-1, 0)) / (sa(1) - sa(-1))
        out[tag + "gamma"] = (va(1, 0) - 2.0 * va(0, 0) + va(-1, 0)) / (davg * davg)
        out[tag + "vega"] = 2.0 * torch.sqrt(v0) * T * (va(0, 1) - va(0, -1)) / (2.0 * dv)
        out[tag + "theta"] = -LV[ii, jj, b]
    return {k: t.to(torch.float64) for k, t in out.items()}
