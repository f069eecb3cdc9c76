"""Dupire local volatility from Heston prices, in plain float64 PyTorch: the
benchmark's own surface, handed to the port and to the reference alike.

From the Gil-Pelaez form of the Heston call, C = S e^{-qT} P1 - K e^{-rT}
P2, with

    dC/dK    = -e^{-rT} P2
    d2C/dK2  =  e^{-rT} f(K),  f(K) = 1/(pi K) int_0^inf Re(e^{-iu ln K} phi(u)) du

(phi the characteristic function of ln S_T) and dC/dT by a central
difference in T, the local variance is

    sigma^2 = (dC/dT + (r - q) K dC/dK + q C) / (K^2 / 2 d2C/dK2),

clamped to [0.01^2, 4^2]; nodes where the density carries no information
(f below 1e-8, where the sums' own noise is ~1e-10, or a non-positive
numerator) take the nearest informative strike's value at their maturity.
The integrals are midpoint sums.
"""

from __future__ import annotations

import math

import torch

C128, F64 = torch.complex128, torch.float64


def _cf(u, T, p, S0, r, q):
    """E[exp(iu ln S_T)] under Heston, the little-trap form; ``u`` complex
    (M,), ``T`` (..., 1)."""
    kappa, theta, sigma, rho, v0 = (p[k] for k in ("kappa", "theta", "sigma", "rho", "v0"))
    xi = kappa - rho * sigma * 1j * u
    d = torch.sqrt(xi * xi + sigma * sigma * (1j * u + u * u))
    g = (xi - d) / (xi + d)
    e = torch.exp(-d * T)
    C = (kappa * theta / sigma ** 2) * ((xi - d) * T - 2.0 * torch.log((1.0 - g * e) / (1.0 - g)))
    D = ((xi - d) / sigma ** 2) * ((1.0 - e) / (1.0 - g * e))
    return torch.exp(C + D * v0 + 1j * u * (math.log(S0) + (r - q) * T))


def _call_parts(p, K, T, S0, r, q, du, u_max):
    """Call price, dC/dK and d2C/dK2 at strikes ``K`` (nK,) and maturities
    ``T`` (nT,): each (nT, nK)."""
    dev = K.device
    u = ((torch.arange(int(u_max / du), dtype=F64, device=dev) + 0.5) * du).to(C128)
    Tc = T[:, None, None].to(C128)                                   # (nT, 1, 1)
    lk = torch.log(K)[None, :, None].to(C128)                        # (1, nK, 1)
    phase = torch.exp(-1j * u * lk)                                  # (1, nK, M)
    phi = _cf(u, Tc, p, S0, r, q)                                    # (nT, 1, M)
    phi_s = _cf(u - 1j, Tc, p, S0, r, q)
    fwd = S0 * torch.exp((r - q) * T)[:, None]                      # (nT, 1)
    P2 = 0.5 + (phase * phi / (1j * u)).real.sum(-1) * du / math.pi
    P1 = 0.5 + (phase * phi_s / (1j * u)).real.sum(-1) * du / (math.pi * fwd)
    dens = (phase * phi).real.sum(-1) * du / (math.pi * K[None, :])
    disc_r, disc_q = torch.exp(-r * T)[:, None], torch.exp(-q * T)[:, None]
    call = S0 * disc_q * P1 - K[None, :] * disc_r * P2
    return call, -disc_r * P2, disc_r * dens


def _fill_nearest(row):
    """NaNs of each row (along the last axis) take the nearest valid value
    (the left one on a tie)."""
    out = row.clone()
    for t in range(row.shape[0]):
        ok = torch.nonzero(~torch.isnan(row[t])).flatten()
        if ok.numel() == 0:
            raise ValueError("no informative strike at a maturity")
        for k in torch.nonzero(torch.isnan(row[t])).flatten().tolist():
            out[t, k] = row[t, ok[torch.argmin((ok - k).abs())]]
    return out


def local_vol_surface(params: dict, strikes, maturities, S0: float, r: float, q: float,
                      device, du: float = 0.01, u_max: float = 200.0, h: float = 1e-4):
    """sigma_loc at every (maturity, strike) node: (len(maturities),
    len(strikes)) float64 on ``device``."""
    K = torch.as_tensor(strikes, dtype=F64, device=device)
    T = torch.as_tensor(maturities, dtype=F64, device=device)
    p = {k: float(v) for k, v in params.items()}
    C, dCdK, d2CdK2 = _call_parts(p, K, T, S0, r, q, du, u_max)
    Cp, _, _ = _call_parts(p, K, T + h, S0, r, q, du, u_max)
    Cm, _, _ = _call_parts(p, K, T - h, S0, r, q, du, u_max)
    num = (Cp - Cm) / (2.0 * h) + (r - q) * K * dCdK + q * C
    den = 0.5 * K * K * d2CdK2
    var = num / den
    ok = (d2CdK2 * torch.exp(r * T)[:, None] > 1e-8) & (num > 0.0) & torch.isfinite(var)
    sig = torch.sqrt(torch.clamp(var, 0.01 ** 2, 4.0 ** 2))
    return _fill_nearest(torch.where(ok, sig, torch.full_like(sig, float("nan"))))
