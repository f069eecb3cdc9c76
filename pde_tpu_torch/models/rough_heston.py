"""Rough Heston model: the fractional Riccati characteristic function (twin
of ``pde_tpu/models/rough_heston.py``).

The rough Heston model of El Euch & Rosenbaum (2019): the variance carries
a fractional kernel with Hurst exponent H < 1/2.  With alpha = H + 1/2 the
log-moneyness CF is

    L(u, t) = exp( theta*lam * I^1 h(u, t)  +  v0 * I^{1-alpha} h(u, t) )

where h solves the fractional Riccati equation

    D^alpha h = F(u, h),   h(u, 0) = 0,
    F(u, x) = 1/2 (-u^2 - i u) + (i u rho nu - lam) x + 1/2 nu^2 x^2.

At alpha = 1 (H = 1/2) this is the classic Heston Riccati ODE with
lam = kappa, nu = sigma.

Numerics: an IMPLICIT fractional product-trapezoidal scheme, the history
weights of the fractional Adams corrector (Diethelm-Ford-Freed 2002) with
the current-step term solved in closed form (F is quadratic in h).  Each
step is one contraction of the F-history with a weight row, batched over
all quadrature nodes u at once.  No row of the history is written in
place (each step adds its row to the buffer out of place), so
``torch.func.jacfwd`` (vmap over jvp) differentiates through the loop, as
the calibrator needs.

Pricing reuses the Carr-Madan forward-moneyness epilogue of
models/heston.py on the converged composite-GL rule.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.precision import complex_dtype_for, device_of, result_dtype, to_tensor
from .heston import INTEGRATION_ALPHA, _accurate_gl_rule, _denom, _price_from_integral

__all__ = [
    "RoughHestonParams",
    "cf_reduced_rough",
    "price_rough",
    "implied_vol_rough",
]


class RoughHestonParams(NamedTuple):
    """Rough Heston parameters.

    hurst: Hurst exponent H in (0, 1/2]; H = 1/2 recovers classic Heston
    lam:   mean-reversion speed (kappa of the classic model)
    theta: long-run variance
    nu:    volatility of variance (sigma of the classic model)
    rho:   spot-variance correlation
    v0:    initial variance
    """

    hurst: float
    lam: float
    theta: float
    nu: float
    rho: float
    v0: float

    def validate(self) -> None:
        if not (0.0 < float(self.hurst) <= 0.5):
            raise ValueError(f"hurst must be in (0, 0.5], got {self.hurst}")
        for name in ("lam", "theta", "nu", "v0"):
            if float(getattr(self, name)) <= 0.0:
                raise ValueError(f"{name} must be positive")
        if not (-1.0 < float(self.rho) < 1.0):
            raise ValueError(f"rho must be in (-1, 1), got {self.rho}")


def _gamma(x):
    """Gamma for positive real arguments (weights only)."""
    return torch.exp(torch.special.gammaln(x))


def _riccati_F(u, x, lam, rho, nu, cdt):
    iu = 1j * u.to(cdt)
    return 0.5 * (-u * u - iu) + (iu * rho * nu - lam) * x + 0.5 * (nu * nu) * x * x


def cf_reduced_rough(params: RoughHestonParams, u, maturity, n_steps: int = 192):
    """exp(theta*lam*I^1 h + v0*I^{1-alpha} h), the rough-Heston analog of
    ``heston._cf_reduced`` (no spot/drift phase).  ``u`` may be complex;
    vectorized over a trailing u axis, and over ``maturity`` (shape S gives
    S + (n_u,): one march for every maturity, each on its own grid).  Runs
    on the device of ``u``, ``maturity`` or the params (the card for plain
    numbers)."""
    rdt = result_dtype(maturity, *params)
    cdt = complex_dtype_for(rdt)
    device = device_of(u, maturity, *params)
    u = torch.atleast_1d(to_tensor(u, cdt, device))
    T = to_tensor(maturity, rdt, device)[..., None]     # S + (1,)
    hurst, lam, theta, nu, rho, v0 = (to_tensor(x, rdt, device) for x in params)
    alpha = hurst + 0.5

    N = int(n_steps)
    dt = T / N

    # --- Adams weights, from alpha (which may carry a tangent) ------------
    ks = torch.arange(N, dtype=rdt, device=device)   # step index k = 0..N-1
    m = ks[:, None] - ks[None, :]                      # k - j
    valid = m >= 0.0
    mp = torch.clamp_min(m, 0.0)
    g = alpha + 1.0
    # corrector history weights, interior j = 1..k: (m+2)^g - 2(m+1)^g + m^g
    A = torch.where(valid, (mp + 2.0) ** g - 2.0 * (mp + 1.0) ** g + mp ** g,
                    torch.zeros((), dtype=rdt, device=device))
    # j = 0 column: k^g - (k - alpha)(k+1)^alpha
    a0 = ks ** g - (ks - alpha) * (ks + 1.0) ** alpha
    A = torch.cat([a0[:, None], A[:, 1:]], dim=1).to(cdt)

    c_corr = (dt ** alpha / _gamma(alpha + 2.0)).to(cdt)

    # IMPLICIT product-trapezoidal step: h = K + c F(h) is the quadratic
    #   (c a2) h^2 + (c b1 - 1) h + (K + c f0) = 0,
    #   a2 = nu^2/2,  b1 = i u rho nu - lam,  f0 = (-u^2 - iu)/2,
    # solved with the root continuous at c -> 0 (h -> K + c f0), in the
    # cancellation-free form 2C / (-B + sqrt(disc))
    f0 = 0.5 * (-u * u - 1j * u)
    b1 = 1j * u * (rho * nu) - lam
    a2 = (0.5 * nu * nu).to(cdt)
    A_q = c_corr * a2
    B_q = c_corr * b1 - 1.0
    c_f0, neg_B = c_corr * f0, -B_q
    BB, AA4 = B_q * B_q, 4.0 * A_q

    # _riccati_F's coefficients, formed once (the same expressions, so
    # F(h) rounds as _riccati_F(u, h, ...) does)
    iu = 1j * u
    F0, F1, F2 = 0.5 * (-u * u - iu), iu * rho * nu - lam, 0.5 * (nu * nu)

    def F(h):
        return F0 + F1 * h + F2 * h * h

    # the F-history S + (N, n_u), row j = F(h_j); rows not yet reached are
    # 0, as are their weights.  Each step adds its row out of place (a
    # one-hot column times the new row), so the buffer takes on the tangents
    # and batch dimensions of what is written into it under jacfwd and vmap
    rows = torch.eye(N, dtype=cdt, device=device)[:, :, None]
    zero = torch.zeros_like(B_q)
    fhist = rows[0] * F(zero)[..., None, :]   # F(h_0 = 0)
    hs = [zero]                               # h at t_0..t_N
    for k in range(N):
        C_q = c_corr * (A[k] @ fhist) + c_f0
        h_new = 2.0 * C_q / (neg_B + torch.sqrt(BB - AA4 * C_q))
        hs.append(h_new)
        # the reference's scan writes row k+1 on every step and XLA clamps
        # the last (row N) write; that row is never read, so the last step
        # skips it
        if k + 1 < N:
            fhist = fhist + rows[k + 1] * F(h_new)[..., None, :]
    h = torch.stack(hs, dim=-2)               # S + (N + 1, n_u)

    # --- I^1 h(T): trapezoid over the uniform grid ------------------------
    i1 = dt * (torch.sum(h, dim=-2) - 0.5 * (h[..., 0, :] + h[..., -1, :]))

    # --- I^{1-alpha} h(T): product-trapezoidal Abel integral ---------------
    # piecewise-linear h: weights (m+1)^gg - 2 m^gg + (m-1)^gg, m = N - j,
    # gg = 2 - alpha; the endpoint j = N has weight 1; j = 0 multiplies h_0 = 0
    gg = 2.0 - alpha
    mm = N - torch.arange(1, N, dtype=rdt, device=device)
    w_int = (mm + 1.0) ** gg - 2.0 * mm ** gg + (mm - 1.0) ** gg
    i_frac = (dt ** (1.0 - alpha) / _gamma(3.0 - alpha)) * (
        w_int.to(cdt) @ h[..., 1:N, :] + h[..., N, :])

    cf = torch.exp(theta * lam * i1 + v0 * i_frac)
    # T <= 0: the CF of a point mass at 0 log-moneyness
    return torch.where(T <= 0.0, torch.ones((), dtype=cdt, device=device), cf)


def price_rough(
    params: RoughHestonParams,
    strikes,
    maturity,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_per_panel: int = 40,
    n_steps: int = 192,
    alpha: float = INTEGRATION_ALPHA,
):
    """European vanillas under rough Heston: one maturity (a smile), or a
    surface when ``maturity`` has shape (M,) and ``strikes`` (M, K) (one
    fractional-Riccati march for all M maturities).

    The Carr-Madan forward-moneyness formulation of the classic pricer with
    the CF swapped for the fractional-Riccati one, on the CONVERGED
    composite-GL rule (``heston._accurate_gl_rule``): the reference-parity
    grid truncates at u = 10.24, which loses real mass at short
    maturities.  The CF is evaluated once on the quadrature grid and shared
    across the smile's strikes.
    """
    rdt = result_dtype(strikes, maturity, spot, *params)
    cdt = complex_dtype_for(rdt)
    device = device_of(strikes, maturity, spot, *params)
    strikes = torch.atleast_1d(to_tensor(strikes, rdt, device))
    T = to_tensor(maturity, rdt, device)
    spot = to_tensor(spot, rdt, device)

    v_np, w_np = _accurate_gl_rule(n_per_panel)
    v = to_tensor(v_np, rdt, device)
    w = to_tensor(w_np, rdt, device)

    u = v.to(cdt) - 1j * (alpha + 1.0)
    cf = cf_reduced_rough(params, u, T, n_steps=n_steps)   # S + (n_u,)

    T = T[..., None]   # each maturity against its row of strikes
    log_fk = (torch.log(spot / strikes) + (rate - dividend) * T)[..., None]
    phase = torch.exp(1j * v.to(cdt) * log_fk.to(cdt))
    integrand = (cf[..., None, :] * phase / _denom(v, alpha, cdt)).real
    integral = torch.sum(w * integrand, dim=-1)

    return _price_from_integral(integral, strikes, T, spot, rate, dividend, is_call,
                                alpha, rdt)


def implied_vol_rough(
    params: RoughHestonParams,
    strikes,
    maturity,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_per_panel: int = 40,
    n_steps: int = 192,
):
    """Black-Scholes implied vols of the rough-Heston smile."""
    from .black_scholes import implied_vol as bs_implied_vol

    prices = price_rough(params, strikes, maturity, spot, rate, dividend, is_call,
                         n_per_panel=n_per_panel, n_steps=n_steps)
    return bs_implied_vol(
        prices, to_tensor(spot, prices.dtype, prices.device),
        torch.atleast_1d(to_tensor(strikes, prices.dtype, prices.device)),
        rate, dividend, to_tensor(maturity, prices.dtype, prices.device), is_call)
