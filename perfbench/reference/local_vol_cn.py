"""Plain reference of the local-vol book: the theta-scheme march of each
option on its own K-scaled grid under a surface of node vols, and its
price, delta and gamma.

The surface is bilinear in (ln K, t) between its nodes and flat beyond
them.  The grid: x = ln(S/K) uniform on [ln s_min, ln s_max]; level j of
the lattice is calendar time T - j dt (j = 0 at expiry), with L = 0.5
sigma^2 V_xx + (r - q - 0.5 sigma^2) V_x - r V at each node and level.  Step
k: rhs = V + (1 - w) dt L_k V on interior rows (the edge rows keep V), then
(I - w dt L_{k+1}) V' = rhs with identity edge rows, then the Dirichlet
rows at the new time to expiry with both discounts.  The readout: price by
linear interpolation at S0; delta and gamma by central differences at the
nearest interior node.

Arrays are (n, B); every operation runs in ``dtype`` (float64 for the
reference, bfloat16 for its control).
"""

from __future__ import annotations

import math

import torch

from .readout import bracket, nearest

FIELDS = ("price", "delta", "gamma")


def sigma_lattice(surface: dict, s, T, n_time: int, f):
    """sigma at every node (n, B) and level j = 0..n_time: (n_time + 1, n, B)."""
    log_k = torch.log(torch.as_tensor(surface["strikes"], dtype=torch.float64,
                                      device=s.device)).to(f)
    tt = torch.as_tensor(surface["maturities"], dtype=torch.float64, device=s.device).to(f)
    vols = surface["vols"].to(device=s.device, dtype=f)          # (n_t, n_k)
    n, B = s.shape
    j = torch.arange(n_time + 1, dtype=f, device=s.device)
    t_lv = torch.clamp(T[None, :] - (T / n_time)[None, :] * j[:, None], min=0.0)
    t_lv = torch.minimum(t_lv, T[None, :])                       # (nT+1, B)
    it, wt = bracket(tt, t_lv.reshape(-1))
    it, wt = it.reshape(t_lv.shape), wt.reshape(t_lv.shape)
    x = torch.log(s)                                             # (n, B)
    ix, wx = bracket(log_k, x.reshape(-1))
    ix, wx = ix.reshape(n, B), wx.reshape(n, B)
    v = lambda a, b: vols[a[:, None, :], b[None, :, :]]          # noqa: E731  (nT+1, n, B)
    wt3, wx3 = wt[:, None, :], wx[None, :, :]
    return ((1 - wt3) * ((1 - wx3) * v(it - 1, ix - 1) + wx3 * v(it - 1, ix))
            + wt3 * ((1 - wx3) * v(it, ix - 1) + wx3 * v(it, ix)))


def _thomas(lo, di, up, rhs):
    n = rhs.shape[0]
    c, d = torch.empty_like(rhs), torch.empty_like(rhs)
    inv = 1.0 / di[0]
    c[0], d[0] = up[0] * inv, rhs[0] * inv
    for i in range(1, n):
        inv = 1.0 / (di[i] - lo[i] * c[i - 1])
        c[i] = up[i] * inv
        d[i] = (rhs[i] - lo[i] * d[i - 1]) * inv
    x = torch.empty_like(rhs)
    x[n - 1] = d[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = d[i] - c[i] * x[i + 1]
    return x


def solve(book: dict, surface: dict, grid: dict, r: float, q: float,
          dtype=torch.float64) -> dict:
    """Price, delta and gamma (B,) of every option of ``book`` (S0, K, T,
    is_call) under ``surface`` (strikes, maturities, vols (n_t, n_k)), on
    the configuration's ``grid`` (n_space, n_time, s_min_mult, s_max_mult,
    w), computed in ``dtype``; results as float64."""
    f = dtype
    S0, K, T, call = (book[k].to(f) for k in ("S0", "K", "T", "is_call"))
    dev = K.device
    n, nT, w = grid["n_space"], grid["n_time"], grid["w"]
    lo_x, hi_x = math.log(grid["s_min_mult"]), math.log(grid["s_max_mult"])
    dx = (hi_x - lo_x) / (n - 1)
    x = (lo_x + dx * torch.arange(n, dtype=torch.float64, device=dev)).to(f)
    s = torch.exp(x)[:, None] * K[None, :]                       # (n, B)
    dt = T / nT
    is_call = call > 0.5

    sig = sigma_lattice(surface, s, T, nT, f)
    s2 = sig * sig
    a = 0.5 * s2 / (dx * dx)
    b = (r - q - 0.5 * s2) / (2.0 * dx)
    Lm, Lc, Lp = a - b, -2.0 * a - r, a + b                      # (nT+1, n, B)

    interior = torch.zeros((n, 1), dtype=torch.bool, device=dev)
    interior[1:-1] = True
    V = torch.where(is_call[None, :], torch.clamp_min(s - K, 0.0), torch.clamp_min(K - s, 0.0))
    for k in range(nT):
        LV = torch.zeros_like(V)
        LV[1:-1] = Lm[k, 1:-1] * V[:-2] + Lc[k, 1:-1] * V[1:-1] + Lp[k, 1:-1] * V[2:]
        rhs = V + ((1.0 - w) * dt) * LV
        lo = torch.where(interior, -(w * dt) * Lm[k + 1], 0.0)
        di = torch.where(interior, 1.0 - (w * dt) * Lc[k + 1], 1.0)
        up = torch.where(interior, -(w * dt) * Lp[k + 1], 0.0)
        Vn = _thomas(lo, di, up, rhs)
        tau = dt * float(k + 1)
        dfr, dfq = torch.exp(-r * tau), torch.exp(-q * tau)
        Vn[0] = torch.where(is_call, 0.0, K * dfr - s[0] * dfq)
        Vn[n - 1] = torch.where(is_call, s[-1] * dfq - K * dfr, 0.0)
        V = Vn

    B = K.shape[0]
    bb = torch.arange(B, device=dev)
    sT = s.T.contiguous()
    hi, t = bracket(sT, S0)
    out = {"price": (1 - t) * V[hi - 1, bb] + t * V[hi, bb]}
    i, i_alt = nearest(sT, S0)
    for tag, ii in (("", i), ("alt_", i_alt)):
        sa = lambda d: sT[bb, ii + d]                            # noqa: E731
        va = lambda d: V[ii + d, bb]                             # noqa: E731
        davg = 0.5 * (sa(1) - sa(-1))
        out[tag + "delta"] = (va(1) - va(-1)) / (sa(1) - sa(-1))
        out[tag + "gamma"] = (va(1) - 2.0 * va(0) + va(-1)) / (davg * davg)
    return {k: v.to(torch.float64) for k, v in out.items()}
