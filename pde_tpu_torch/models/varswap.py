"""Volatility derivatives: variance swaps, volatility swaps, VIX-style
strips (twin of ``pde_tpu/models/varswap.py``).

Under Heston the integrated variance I_T = (1/T) int_0^T v_t dt has
closed-form moments and a closed-form Laplace transform (the CIR bond-price
formula), so

* the **variance-swap fair strike** E[I_T] is exact,
* the **volatility-swap fair strike** E[sqrt(I_T)] is exact through one
  Gauss-Legendre quadrature of the Laplace transform (Schuerger's identity
  sqrt(x) = 1/(2 sqrt(pi)) * int_0^inf (1 - e^{-s x}) s^{-3/2} ds),
* the **VIX-style model-free strip** replicates variance from an OTM
  option chain (CBOE 2003 discretization).

Jump models compose through hooks on their params, as pricing does
through ``cf_reduced_extra``: ``qv_rate_extra`` / ``qv_mean_extra`` add to
the variance strike, ``qv_log_laplace_extra`` / ``qv_laplace_extra`` to the
Laplace transform.  The strip's bias under jumps is :func:`strip_jump_bias`.

Functions run on their inputs' device (the card for plain numbers).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.precision import device_of, result_dtype, to_tensor

__all__ = [
    "integrated_variance_laplace",
    "integrated_variance_log_laplace",
    "fair_variance_strike",
    "forward_variance",
    "fair_volatility_strike",
    "volatility_convexity_approx",
    "strip_variance",
    "strip_jump_bias",
    "vix_index",
]


def _heston_fields(params, dt, device):
    return tuple(to_tensor(getattr(params, k), dt, device)
                 for k in ("kappa", "theta", "sigma", "v0"))


def integrated_variance_laplace(params, s, maturity):
    """E[exp(-s * int_0^T v_t dt)], the closed-form CIR transform

        gamma = sqrt(kappa^2 + 2 sigma^2 s)
        L(s)  = A(s)^{2 kappa theta / sigma^2} * exp(-B(s) v0)

    in decaying exponentials, so a large ``gamma*T`` cannot overflow.  A
    ``qv_laplace_extra(s, T)`` hook on ``params`` multiplies in.
    """
    return torch.exp(integrated_variance_log_laplace(params, s, maturity))


def integrated_variance_log_laplace(params, s, maturity):
    """log E[exp(-s * int_0^T v_t dt)]: the exponent of
    :func:`integrated_variance_laplace`, so small-``s`` callers can form
    ``1 - L`` without cancellation as ``-expm1(log L)``."""
    dt = result_dtype(s, maturity, *params)
    device = device_of(s, maturity, *params)
    s = to_tensor(s, dt, device)
    T = to_tensor(maturity, dt, device)
    kappa, theta, sigma, v0 = _heston_fields(params, dt, device)

    gamma = torch.sqrt(kappa * kappa + 2.0 * sigma * sigma * s)
    one_m_e = -torch.expm1(-gamma * T)
    denom = (gamma + kappa) * one_m_e + 2.0 * gamma * (1.0 - one_m_e)
    # A = [2 gamma e^{(kappa-gamma)T/2} / denom]^{2 kappa theta / sigma^2},
    # with kappa - gamma = -2 sigma^2 s / (kappa + gamma) and
    # 2 gamma / denom = 1 / (1 + (kappa - gamma)(1 - e) / (2 gamma)): both
    # terms of log A are then O(s) without cancellation.  The reference's
    # log(2 gamma / denom) rounds at eps(1) while log A is O(s), which costs
    # the float32 vol-swap strike ~1.5e-4 of its value
    k_m_g = -2.0 * sigma * sigma * s / (kappa + gamma)
    log_a = -torch.log1p(k_m_g * one_m_e / (2.0 * gamma)) + 0.5 * k_m_g * T
    b = 2.0 * s * one_m_e / denom
    out = (2.0 * kappa * theta / (sigma * sigma)) * log_a - b * v0
    extra = getattr(params, "qv_log_laplace_extra", None)
    if extra is not None:
        out = out + extra(s, T)
    else:
        extra_lin = getattr(params, "qv_laplace_extra", None)
        if extra_lin is not None:
            out = out + torch.log(extra_lin(s, T))
    return out


def fair_variance_strike(params, maturity):
    """Variance-swap fair strike E[(1/T) int_0^T v dt] (+ jump QV).

    Heston: theta + (v0 - theta)(1 - e^{-kappa T})/(kappa T), exact.  The
    maturity-aware hook ``qv_mean_extra(T)`` (SVCJ) adds in, else the
    constant rate ``qv_rate_extra()`` (Bates).
    """
    dt = result_dtype(maturity, *params)
    device = device_of(maturity, *params)
    T = to_tensor(maturity, dt, device)
    kappa, theta, _, v0 = _heston_fields(params, dt, device)
    ev = theta + (v0 - theta) * (1.0 - torch.exp(-kappa * T)) / (kappa * T)
    extra_t = getattr(params, "qv_mean_extra", None)
    extra = getattr(params, "qv_rate_extra", None)
    if extra_t is not None:
        ev = ev + extra_t(T)
    elif extra is not None:
        ev = ev + extra()
    return ev


def forward_variance(params, t1, t2):
    """Forward variance-swap strike over [t1, t2] from the term structure:
    (E[I_{t2}] t2 - E[I_{t1}] t1) / (t2 - t1)."""
    dt = result_dtype(t1, t2, *params)
    device = device_of(t1, t2, *params)
    t1 = to_tensor(t1, dt, device)
    t2 = to_tensor(t2, dt, device)
    k2 = fair_variance_strike(params, t2)
    k1 = fair_variance_strike(params, t1)
    return (k2 * t2 - k1 * t1) / (t2 - t1)


@functools.lru_cache(maxsize=8)
def _gl01(n: int):
    """Gauss-Legendre nodes and weights on (0, 1), numpy on the host (cached)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def fair_volatility_strike(params, maturity, *, n_nodes: int = 128):
    """Volatility-swap fair strike E[sqrt((1/T) int v dt)], exact to the
    quadrature.

    Schuerger's identity turns the expectation into a Laplace-transform
    integral; s = (t/(1-t))^2 maps it to a smooth bounded integrand on
    (0, 1), which ``n_nodes`` Gauss-Legendre points resolve to ~1e-6:

        E[sqrt(I)] = 1/(2 sqrt(pi)) * int_0^1 2 (1 - L((t/(1-t))^2)) / t^2 dt
    """
    dt = result_dtype(maturity, *params)
    device = device_of(maturity, *params)
    t_np, w_np = _gl01(int(n_nodes))
    t = to_tensor(t_np, dt, device)
    w = to_tensor(w_np, dt, device)
    u = t / (1.0 - t)
    s = u * u
    # L is the transform of T*I; rescale to the annualized I at s/T
    T = to_tensor(maturity, dt, device)
    log_lap = integrated_variance_log_laplace(params, s / T, T)
    # 1 - L as -expm1(log L): at the dominant s -> 0 end 1 - exp(-s E[I])
    # is pure cancellation in float32
    integrand = -2.0 * torch.expm1(log_lap) / (t * t)
    return torch.sum(w * integrand) / (2.0 * math.sqrt(math.pi))


def volatility_convexity_approx(params, maturity):
    """Second-order convexity approximation sqrt(E[I]) (1 - Var(I)/(8 E[I]^2))
    (Brockhaus-Long 2000), the desk rule of thumb.  E[I] and Var(I) are the
    first two derivatives of the log-Laplace transform at s = 0, by nested
    ``torch.func.grad``."""
    dt = result_dtype(maturity, *params)
    T = to_tensor(maturity, dt, device_of(maturity, *params))

    def log_lap(s):
        return torch.log(integrated_variance_laplace(params, s / T, T))

    zero = torch.zeros_like(T)
    mean = -torch.func.grad(log_lap)(zero)                     # = E[I]
    var = torch.func.grad(torch.func.grad(log_lap))(zero)      # cumulant: Var[I]
    mean = torch.clamp_min(mean, 1e-12)
    return torch.sqrt(mean) * (1.0 - var / (8.0 * mean * mean))


def strip_variance(strikes, otm_prices, forward, maturity, rate):
    """Model-free variance from an OTM option strip, the CBOE VIX (2003)
    discretization of the Demeterfi et al. (1999) log-contract replication:

        sigma^2 = (2 e^{rT} / T) sum_i (dK_i / K_i^2) Q(K_i)
                  - (1/T) (F/K0 - 1)^2

    ``strikes`` ascending; ``otm_prices`` present-value OTM mids (puts below
    the forward, calls above); K0 is the largest strike at or below F,
    picked by a mask (K[0] when F is below every strike).
    """
    dt = result_dtype(strikes, otm_prices, forward, maturity, rate)
    device = device_of(strikes, otm_prices, forward, maturity, rate)
    K = to_tensor(strikes, dt, device)
    Q = to_tensor(otm_prices, dt, device)
    F = to_tensor(forward, dt, device)
    T = to_tensor(maturity, dt, device)
    r = to_tensor(rate, dt, device)

    # central strike spacing, one-sided at the ends (CBOE rule)
    dK = torch.cat([K[1:2] - K[0:1], 0.5 * (K[2:] - K[:-2]), K[-1:] - K[-2:-1]])
    total = torch.sum(dK / (K * K) * Q)
    K0 = torch.max(torch.where(K <= F, K, K[0]))
    return (2.0 * torch.exp(r * T) / T) * total - ((F / K0 - 1.0) ** 2) / T


def strip_jump_bias(params):
    """Closed-form bias of the log-contract strip under jumps, per year:
    each jump contributes 2(e^J - 1 - J) instead of J^2, so

        strip - fair_variance = 2 lam (kbar - mu_j) - lam (mu_j^2 + sigma_j^2)

    Zero when the params carry no jump fields.
    """
    dt, device = result_dtype(*params), device_of(*params)
    lam = getattr(params, "lam", None)
    if lam is None:
        return torch.zeros((), dtype=dt, device=device)
    lam, mu_j, sj = (to_tensor(x, dt, device) for x in (lam, params.mu_j, params.sigma_j))
    kbar = torch.exp(mu_j + 0.5 * sj * sj) - 1.0
    return 2.0 * lam * (kbar - mu_j) - lam * (mu_j * mu_j + sj * sj)


def vix_index(strikes, otm_prices, forward, maturity, rate):
    """VIX-style index: 100 * sqrt(strip variance) at the given tenor
    (single tenor; callers with two chains interpolate the squares in T)."""
    var = strip_variance(strikes, otm_prices, forward, maturity, rate)
    return 100.0 * torch.sqrt(torch.clamp_min(var, 0.0))
