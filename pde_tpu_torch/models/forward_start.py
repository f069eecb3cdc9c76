"""Semi-closed-form forward-start (and cliquet-strip) pricing under Heston
(twin of ``pde_tpu/models/forward_start.py``).

A forward-start vanilla pays ``(S_T / S_{t0} - k)^+`` at T.  By iterated
conditioning its log-return CF factorizes exactly:

    E[e^{iu ln(S_T/S_{t0})}] = e^{iu(r-q)tau} e^{C(u,tau)} * M_{v_{t0}}(D(u,tau))

with ``tau = T - t0``, ``C``/``D`` the Heston exponents over tau, and
``M_{v_{t0}}`` the moment generating function of the time-``t0`` CIR
variance, a scaled noncentral chi-square.  The smile is priced by the
Carr-Madan machinery of :mod:`pde_tpu_torch.models.heston` through the
``cf_reduced_extra`` hook, which multiplies the reduced CF ``exp(C + D v0)``
by ``exp(-D v0) * M_{v_{t0}}(D)`` (1 at ``u = -i``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.precision import device_of, result_dtype, to_tensor
from . import heston
from .heston import HestonParams

__all__ = [
    "ForwardStartParams",
    "price_forward_start",
    "price_cliquet_strip",
]


class ForwardStartParams(NamedTuple):
    """Heston params plus the fixing date ``t0``, which the CF pricers take:
    fed to any ``models.heston`` pricer with ``spot=1`` and ``maturity=tau``
    it prices the forward return ``S_{t0+tau}/S_{t0}``."""

    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    rho: torch.Tensor
    v0: torch.Tensor
    t0: torch.Tensor

    def cf_reduced_extra(self, u, T, rdt, cdt):
        """``exp(-D(u,T) v0) * E[exp(D(u,T) v_{t0}) | v_0]``.

        ``v_{t0} | v_0 ~ c * chi'^2(delta, lam)`` with
        ``c = sigma^2 (1-e^{-kappa t0}) / (4 kappa)``,
        ``delta = 4 kappa theta / sigma^2``, ``lam = v0 e^{-kappa t0} / c``;
        ``E[e^{w v_{t0}}] = (1-2cw)^{-delta/2} exp(lam c w / (1-2cw))``,
        written with ``lam*c = v0 e^{-kappa t0}`` so ``t0 -> 0`` (c -> 0)
        tends to the vanilla factor 1 with no 0/0.
        """
        kappa, th, sig, rho_, v0, t0 = (to_tensor(x, rdt, u.device) for x in self)

        # D(u, T) on the same branch as heston._cf_reduced
        sigma2 = sig * sig
        xi = kappa - rho_ * sig * 1j * u
        d = torch.sqrt(xi * xi + sigma2 * (1j * u + u * u))
        g = (xi - d) / (xi + d)
        exp_mdT = torch.exp(-d * T)
        D = ((xi - d) / sigma2) * ((1.0 - exp_mdT) / (1.0 - g * exp_mdT))

        e_kt0 = torch.exp(-kappa * t0)
        c = sigma2 * (1.0 - e_kt0) / (4.0 * kappa)
        delta = 4.0 * kappa * th / sigma2
        lam_c = v0 * e_kt0  # lam * c, finite as t0 -> 0
        one_m2cw = 1.0 - 2.0 * c * D
        # log1p, not log(1 - x): as sigma -> 0, c -> 0 while delta ~ 1/sigma^2
        # grows, so delta * log1p(-2cD) needs the log accurate in ABSOLUTE
        # terms near 0, which log(1 - x) (rounding at eps(1)) is not
        mgf = torch.exp(lam_c * D / one_m2cw - 0.5 * delta * torch.log1p(-2.0 * c * D))
        return torch.exp(-D * v0) * mgf

    def heston(self) -> HestonParams:
        return HestonParams(self.kappa, self.theta, self.sigma, self.rho, self.v0)


def _dtype_device(params, *args):
    return result_dtype(*args, *params), device_of(*args, *params)


def price_forward_start(
    params: HestonParams,
    rel_strikes,
    fixing,
    maturity,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    notional=1.0,
):
    """Analytic forward-start vanilla: ``notional * (S_T/S_{t0} - k)^+``, one
    converged Carr-Madan quadrature on the forward-return CF.  Broadcasts
    over ``rel_strikes``; runs on the inputs' device (the card for plain
    numbers)."""
    rdt, device = _dtype_device(params, rel_strikes, fixing, maturity)
    t0 = to_tensor(fixing, rdt, device)
    tau = to_tensor(maturity, rdt, device) - t0
    fsp = ForwardStartParams(params.kappa, params.theta, params.sigma, params.rho,
                             params.v0, t0)
    p = heston.price_accurate(fsp, to_tensor(rel_strikes, rdt, device), tau, 1.0,
                              rate, dividend, is_call)
    disc_t0 = torch.exp(-to_tensor(rate, rdt, device) * t0)
    return notional * disc_t0 * p


def price_cliquet_strip(
    params: HestonParams,
    maturity,
    *,
    n_periods: int = 12,
    local_floor=0.0,
    local_cap=0.08,
    notional=1.0,
    rate=0.0,
    dividend=0.0,
):
    """Analytic cliquet WITHOUT global floor/cap: a strip of forward-start
    call spreads.

    ``clip(R_j - 1, lf, lc) = lf + (R_j - (1+lf))^+ - (R_j - (1+lc))^+`` and
    expectations add across periods, so the cliquet is 2 * n_periods
    forward-start calls, each coupon discounted from the note's maturity.
    """
    rdt, device = _dtype_device(params, maturity, local_floor, local_cap, rate)
    T = to_tensor(maturity, rdt, device)
    r = to_tensor(rate, rdt, device)
    lf = to_tensor(local_floor, rdt, device)
    lc = to_tensor(local_cap, rdt, device)
    dt = T / n_periods

    total = torch.zeros((), dtype=rdt, device=device)
    for j in range(1, n_periods + 1):
        t_prev, t_j = (j - 1) * dt, j * dt
        spread = (price_forward_start(params, 1.0 + lf, t_prev, t_j, rate=rate,
                                      dividend=dividend)
                  - price_forward_start(params, 1.0 + lc, t_prev, t_j, rate=rate,
                                        dividend=dividend))
        # the coupon fixes at t_j but pays at T: discount e^{-r (T - t_j)}
        total = total + torch.exp(-r * (T - t_j)) * spread
    total = total + torch.exp(-r * T) * lf * n_periods
    return notional * total
