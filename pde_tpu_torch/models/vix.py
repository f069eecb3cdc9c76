"""VIX derivatives under affine stochastic volatility: futures and options
(twin of ``pde_tpu/models/vix.py``).

Under Heston/Bates the forward-looking 30-day strip at time ``T`` is affine
in the instantaneous variance,

    VIX_T^2 / 100^2 = a * v_T + b,
    a = (1 - e^{-kappa tau}) / (kappa tau),      tau = 30/365
    b = theta (1 - a) + jump strip rate,

the jump contribution per year being ``2 lam (kbar - mu_j)``.  ``v_T`` is
CIR, so its terminal law is a scaled noncentral chi-square
``c * chi2_d(lam_nc)``.  Two independent routes:

* **Futures** ``E[sqrt(a v_T + b)]`` by the Schuerger sqrt identity on the
  closed-form Laplace transform of ``v_T`` (as
  :func:`pde_tpu_torch.models.varswap.fair_volatility_strike`).
* **Options** ``E[(sqrt(a v_T + b) - K)^+]`` by fixed-shape Gauss-Legendre
  quadrature against the exact terminal density, a Poisson-gamma mixture
  summed with a windowed ``logsumexp``.

The density quadrature substitutes ``v = w^4`` so the ``v^{d/2-1}``
endpoint behaviour stays integrable by polynomials when the Feller
condition fails.  Levels, futures and strikes are in VIX points (100 x
annualized vol); options settle at ``T`` and invert through Black-76 on
the future.  Functions run on their inputs' device (the card for plain
numbers).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.precision import device_of, result_dtype, to_tensor
from . import black_scholes as bs

__all__ = [
    "VIX_TENOR",
    "cir_terminal_law",
    "cir_terminal_logpdf",
    "vix_squared_coeffs",
    "vix_spot",
    "vix_futures",
    "vix_futures_density",
    "vix_option",
    "vix_implied_vol",
    "vix_futures_term",
]

VIX_TENOR = 30.0 / 365.0


def cir_terminal_law(params, maturity):
    """(c, d, lam_nc) of the exact CIR terminal law v_T ~ c * chi2_d(lam_nc):
    c = sigma^2 (1 - e^{-kappa T}) / (4 kappa), d = 4 kappa theta / sigma^2,
    lam_nc = v0 e^{-kappa T} / c.  Any params with (kappa, theta, sigma, v0)."""
    dt = result_dtype(maturity, *params)
    device = device_of(maturity, *params)
    T = to_tensor(maturity, dt, device)
    kappa, theta, sigma, v0 = (to_tensor(getattr(params, k), dt, device)
                               for k in ("kappa", "theta", "sigma", "v0"))
    emkt = torch.exp(-kappa * T)
    c = sigma * sigma * (1.0 - emkt) / (4.0 * kappa)
    d = 4.0 * kappa * theta / (sigma * sigma)
    lam_nc = v0 * emkt / c
    return c, d, lam_nc


def cir_terminal_logpdf(params, maturity, v, *, n_terms: int = 160):
    """log density of v_T: the Poisson-gamma mixture over a window of
    ``n_terms`` consecutive Poisson indices centred on the mode (mass
    outside < 1e-12 for lam_nc up to ~1e3), by ``logsumexp``."""
    c, d, lam = cir_terminal_law(params, maturity)
    dt = c.dtype
    v = to_tensor(v, dt, c.device)
    half = 0.5 * lam
    n0 = torch.clamp_min(torch.floor(half) - n_terms // 2, 0.0)
    ns = n0[..., None] + torch.arange(n_terms, dtype=dt, device=c.device)
    # Poisson log mass at ns; the lam == 0 guard of xlogy
    tiny = torch.finfo(dt).tiny
    log_half = torch.log(torch.clamp_min(half, tiny))[..., None]
    zero = torch.zeros((), dtype=dt, device=c.device)
    log_pois = torch.where(half[..., None] > 0.0, ns * log_half - half[..., None],
                           torch.where(ns == 0.0, zero, -math.inf))
    log_pois = log_pois - torch.special.gammaln(ns + 1.0)
    # gamma(k = d/2 + n, scale = 2) density of y = v / c
    y = torch.clamp_min(v / c, tiny)[..., None]
    k = 0.5 * d + ns
    log_gamma = ((k - 1.0) * torch.log(y) - 0.5 * y - k * math.log(2.0)
                 - torch.special.gammaln(k))
    return torch.logsumexp(log_pois + log_gamma, dim=-1) - torch.log(c)


def _jump_strip_rate(params, dt, device):
    """Per-year jump contribution to the forward strip, 2 lam (kbar - mu_j):
    the ``qv_rate_extra`` hook plus ``varswap.strip_jump_bias``.  Zero for
    pure-diffusion params."""
    lam = getattr(params, "lam", None)
    if lam is None:
        return torch.zeros((), dtype=dt, device=device)
    lam, mu_j, sj = (to_tensor(x, dt, device) for x in (lam, params.mu_j, params.sigma_j))
    kbar = torch.exp(mu_j + 0.5 * sj * sj) - 1.0
    return 2.0 * lam * (kbar - mu_j)


def vix_squared_coeffs(params, tenor=VIX_TENOR):
    """(a, b) with VIX_T^2 (variance units) = a * v_T + b."""
    dt = result_dtype(tenor, *params)
    device = device_of(tenor, *params)
    tau = to_tensor(tenor, dt, device)
    kappa = to_tensor(params.kappa, dt, device)
    theta = to_tensor(params.theta, dt, device)
    a = (1.0 - torch.exp(-kappa * tau)) / (kappa * tau)
    b = theta * (1.0 - a) + _jump_strip_rate(params, dt, device)
    return a, b


def vix_spot(params, tenor=VIX_TENOR):
    """Time-0 model VIX level (VIX points): 100 sqrt(a v0 + b)."""
    a, b = vix_squared_coeffs(params, tenor)
    return 100.0 * torch.sqrt(a * to_tensor(params.v0, a.dtype, a.device) + b)


def _terminal_log_laplace(params, maturity, s):
    """log E[exp(-s v_T)], closed form for the noncentral chi-square law,
    broadcast over a trailing node axis of ``s`` (maturity-shaped c, d,
    lam_nc gain one); log form so ``1 - L`` is built with ``expm1``."""
    c, d, lam = (x[..., None] for x in cir_terminal_law(params, maturity))
    q = 2.0 * c * s
    return -lam * c * s / (1.0 + q) - 0.5 * d * torch.log1p(q)


@functools.lru_cache(maxsize=8)
def _gl01(n: int):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _coeffs_on(params, maturity, tenor):
    """vix_squared_coeffs on the device and dtype of maturity, tenor and
    params together."""
    dt = result_dtype(maturity, tenor, *params)
    return vix_squared_coeffs(params, to_tensor(tenor, dt,
                                                device_of(maturity, tenor, *params)))


def vix_futures(params, maturity, tenor=VIX_TENOR, *, n_nodes: int = 192):
    """VIX futures price E[VIX_T] (VIX points), the Schuerger route:
    sqrt(y) = 1/(2 sqrt(pi)) int_0^inf (1 - e^{-s y}) s^{-3/2} ds applied to
    Y = a v_T + b, whose Laplace transform is e^{-s b} L_{v_T}(a s), on the
    t/(1-t) squared substitution.  Broadcasts over ``maturity``."""
    a, b = _coeffs_on(params, maturity, tenor)
    dt, device = a.dtype, a.device
    t_np, w_np = _gl01(int(n_nodes))
    t = to_tensor(t_np, dt, device)
    w = to_tensor(w_np, dt, device)
    u = t / (1.0 - t)
    s = u * u
    log_lap_y = -s * b + _terminal_log_laplace(params, to_tensor(maturity, dt, device),
                                               a * s)
    integrand = -2.0 * torch.expm1(log_lap_y) / (t * t)
    ev = torch.sum(w * integrand, dim=-1) / (2.0 * math.sqrt(math.pi))
    return 100.0 * ev


def _density_nodes(params, maturity, n_nodes: int):
    """Quadrature nodes and probability weights for E[f(v_T)]: Gauss-Legendre
    in w with v = w^4 on [0, v_max^{1/4}], v_max = mean + 14 std + 72 c
    (e^{-36} of mass missed).  Returns (v, prob); prob is normalized by the
    callers."""
    c, d, lam = cir_terminal_law(params, maturity)
    dt = c.dtype
    mean = c * (d + lam)
    std = c * torch.sqrt(2.0 * d + 4.0 * lam)
    v_max = mean + 14.0 * std + 72.0 * c
    w_hi = v_max ** 0.25
    x_np, wt_np = _gl01(int(n_nodes))
    x = to_tensor(x_np, dt, c.device) * w_hi
    wt = to_tensor(wt_np, dt, c.device) * w_hi
    v = x ** 4
    dv_dw = 4.0 * x ** 3
    logpdf = cir_terminal_logpdf(params, maturity, v)
    prob = wt * torch.exp(logpdf) * dv_dw
    return v, prob


def vix_futures_density(params, maturity, tenor=VIX_TENOR, *, n_nodes: int = 320):
    """VIX futures by the terminal-density quadrature (the independent
    cross-check of :func:`vix_futures`, and the route options use)."""
    a, b = _coeffs_on(params, maturity, tenor)
    v, prob = _density_nodes(params, to_tensor(maturity, a.dtype, a.device), n_nodes)
    z = torch.sum(prob)
    return 100.0 * torch.sum(prob * torch.sqrt(a * v + b)) / z


def vix_option(params, strike, maturity, rate=0.0, tenor=VIX_TENOR, *,
               is_call: bool = True, n_nodes: int = 320):
    """European VIX option price (VIX points), e^{-rT} E[(VIX_T - K)^+],
    ``strike`` in VIX points (broadcasts over a strike array), from the
    exact terminal law."""
    a, b = _coeffs_on(params, maturity, tenor)
    dt, device = a.dtype, a.device
    T = to_tensor(maturity, dt, device)
    v, prob = _density_nodes(params, T, n_nodes)
    z = torch.sum(prob)
    strike = to_tensor(strike, dt, device)
    vix_t = 100.0 * torch.sqrt(a * v + b)
    diff = vix_t - strike[..., None]
    payoff = torch.clamp_min(diff, 0.0) if is_call else torch.clamp_min(-diff, 0.0)
    df = torch.exp(-to_tensor(rate, dt, device) * T)
    return df * torch.sum(prob * payoff, dim=-1) / z


def vix_implied_vol(price, futures, strike, maturity, rate=0.0, is_call=True):
    """Black-76 implied vol of a VIX option quote (market convention):
    Black-Scholes with spot = F and dividend = rate."""
    return bs.implied_vol(price, futures, strike, rate, rate, maturity, is_call=is_call)


def vix_futures_term(params, maturities, tenor=VIX_TENOR, *, n_nodes: int = 192):
    """Futures term structure: :func:`vix_futures` on a vector of
    maturities, in one broadcast call."""
    dt = result_dtype(maturities, tenor, *params)
    device = device_of(maturities, tenor, *params)
    return vix_futures(params, torch.atleast_1d(to_tensor(maturities, dt, device)),
                       tenor, n_nodes=n_nodes)
