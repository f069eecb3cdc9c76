"""Multi-asset options: baskets, spreads, exchanges and two-asset rainbows
(twin of ``pde_tpu/models/multi_asset.py``).

* Closed forms: the geometric basket (exactly lognormal), Margrabe's
  exchange option, Kirk's spread approximation, Stulz's two-asset rainbows.
* Quadrature: spread options by conditioning on one asset (1D
  Gauss-Legendre over its normal factor, the inner expectation in closed
  form); the bivariate normal CDF by Genz's arcsin-integral form on a fixed
  Gauss-Legendre panel.

* Monte Carlo by exact terminal sampling: ``S_T = S_0 exp((r - q -
  sigma^2/2) T + sqrt(T) sigma L z)`` with ``L`` the correlation's Cholesky
  factor, one ``(paths, n) @ (n, n)`` product and no time stepping; the
  geometric basket (exact closed form) and Margrabe's exchange option are
  the control variates.  As in the reference, the Monte Carlo names work
  in float32 whatever their inputs' dtype, their products in full float32
  (TF32 off).  Where the reference takes a PRNG key they take a
  ``torch.Generator`` on the path's device or a replay
  (:mod:`pde_tpu_torch.models.heston_mc`); the normals are drawn from it
  unsplit, as the reference draws them from its key.

Every closed form and quadrature broadcasts over its quote arguments
(strike, rho, spots, vols, maturity): one call prices a whole book, a
quadrature gaining a trailing node axis that it sums away.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.precision import cholesky_nan, device_of, result_dtype, to_tensor, where_flag
from ..utils.stats import norm_cdf, norm_pdf
from .heston_mc import _draws, _sign

__all__ = [
    "bivariate_norm_cdf",
    "geometric_basket_price",
    "margrabe_price",
    "kirk_spread_price",
    "spread_price_quad",
    "rainbow_two_asset_price",
    "sample_terminal_gbm",
    "price_basket_mc",
    "price_spread_mc",
    "price_rainbow_mc",
    "implied_correlation",
]

_BVN_NODES = 48  # GL nodes for the arcsin integral; ~1e-12 for |rho| <= 0.95


@functools.lru_cache(maxsize=8)
def _leggauss(n: int):
    """Gauss-Legendre nodes and weights on [-1, 1], numpy on the host (cached)."""
    return np.polynomial.legendre.leggauss(n)


def _tensors(*args):
    """``args`` as tensors of one floating dtype on one device (the card
    when none is a tensor)."""
    dt, device = result_dtype(*args), device_of(*args)
    return tuple(to_tensor(a, dt, device) for a in args)


def bivariate_norm_cdf(h, k, rho, n_nodes: int = _BVN_NODES):
    """P(X <= h, Y <= k) for the standard bivariate normal with correlation rho.

    Genz's single-integral form: Phi2(h, k, rho) = Phi(h) Phi(k) +
    (1/2pi) * int_0^{arcsin rho} exp(-(h^2 - 2 h k sin t + k^2) /
    (2 cos^2 t)) dt on a fixed ``n_nodes`` Gauss-Legendre panel: ~1e-12 for
    |rho| <= 0.95, ~1e-7 at |rho| = 0.999.  rho is clipped to
    +-(1 - 1e-7).  Broadcasts over h, k, rho.
    """
    h, k, rho = torch.broadcast_tensors(*_tensors(h, k, rho))
    rho = torch.clamp(rho, -1.0 + 1e-7, 1.0 - 1e-7)
    x_np, w_np = _leggauss(n_nodes)
    x = to_tensor(x_np, h.dtype, h.device)
    w = to_tensor(w_np, h.dtype, h.device)
    a = torch.asin(rho)  # the integral's upper limit
    t = 0.5 * a[..., None] * (x + 1.0)  # [-1, 1] -> [0, a]
    ct2 = torch.cos(t) ** 2
    h_ = h[..., None]
    k_ = k[..., None]
    integrand = torch.exp(-(h_ * h_ - 2.0 * h_ * k_ * torch.sin(t) + k_ * k_) / (2.0 * ct2))
    integral = 0.5 * a * torch.sum(w * integrand, dim=-1)
    out = norm_cdf(h) * norm_cdf(k) + integral / (2.0 * math.pi)
    return torch.clamp(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# closed forms
# ---------------------------------------------------------------------------


def _log_basket_moments(spots, weights, vols, corr, rate, dividends, maturity):
    """Mean and variance of log(geometric basket) = sum_i w_i log S_i(T)."""
    spots, weights, vols, corr, maturity = _tensors(spots, weights, vols, corr, maturity)
    dividends = to_tensor(dividends, spots.dtype, spots.device).expand(spots.shape)
    mu_i = torch.log(spots) + (rate - dividends - 0.5 * vols**2) * maturity
    mean = torch.sum(weights * mu_i)
    cov = corr * vols[:, None] * vols[None, :] * maturity
    var = weights @ cov @ weights
    return mean, var


def geometric_basket_price(
    spots, weights, strike, maturity, vols, corr,
    rate=0.0, dividends=0.0, is_call=True,
):
    """Exact price of a European option on the geometric basket
    prod_i S_i(T)^{w_i} (weights summing to 1): Black-76 on
    F = exp(m + s2/2) with the log-basket's normal mean m and variance s2.
    Broadcasts over ``strike``."""
    m, s2 = _log_basket_moments(spots, weights, vols, corr, rate, dividends, maturity)
    strike = to_tensor(strike, m.dtype, m.device)
    maturity = to_tensor(maturity, m.dtype, m.device)
    s = torch.sqrt(torch.clamp_min(s2, 1e-300))
    fwd = torch.exp(m + 0.5 * s2)
    d1 = (m + s2 - torch.log(strike)) / s
    d2 = d1 - s
    df = torch.exp(-rate * maturity)
    call = df * (fwd * norm_cdf(d1) - strike * norm_cdf(d2))
    put = df * (strike * norm_cdf(-d2) - fwd * norm_cdf(-d1))
    return where_flag(is_call, call, put)


def margrabe_price(spot1, spot2, maturity, vol1, vol2, rho, rate=0.0, div1=0.0, div2=0.0):
    """Margrabe (1978) exchange option E[e^{-rT} (S1_T - S2_T)^+], exact:
    the ratio S1/S2 is GBM with vol sqrt(v1^2 - 2 rho v1 v2 + v2^2), and the
    rate cancels under the S2 numeraire."""
    spot1, spot2, maturity, vol1, vol2, rho = _tensors(spot1, spot2, maturity, vol1,
                                                       vol2, rho)
    sig = torch.sqrt(vol1**2 - 2.0 * rho * vol1 * vol2 + vol2**2)
    st = torch.clamp_min(sig * torch.sqrt(maturity), 1e-12)
    f1 = spot1 * torch.exp(-div1 * maturity)
    f2 = spot2 * torch.exp(-div2 * maturity)
    d1 = torch.log(f1 / f2) / st + 0.5 * st
    d2 = d1 - st
    del rate  # cancels under the S2 numeraire
    return f1 * norm_cdf(d1) - f2 * norm_cdf(d2)


def kirk_spread_price(
    spot1, spot2, strike, maturity, vol1, vol2, rho,
    rate=0.0, div1=0.0, div2=0.0, is_call=True,
):
    """Kirk (1995) approximation of the spread option
    E[e^{-rT} (S1_T - S2_T - K)^+]: S2 + K e^{-rT} treated as lognormal with
    its vol scaled by F2/(F2 + K); exact at K = 0 (Margrabe)."""
    spot1, spot2, strike, maturity, vol1, vol2, rho = _tensors(
        spot1, spot2, strike, maturity, vol1, vol2, rho)
    df = torch.exp(-rate * maturity)
    f1 = spot1 * torch.exp((rate - div1) * maturity)
    f2 = spot2 * torch.exp((rate - div2) * maturity)
    a = f2 + strike
    b = f2 / a
    sig = torch.sqrt(vol1**2 - 2.0 * rho * vol1 * vol2 * b + (vol2 * b) ** 2)
    st = torch.clamp_min(sig * torch.sqrt(maturity), 1e-12)
    d1 = torch.log(f1 / a) / st + 0.5 * st
    d2 = d1 - st
    call = df * (f1 * norm_cdf(d1) - a * norm_cdf(d2))
    # parity: call - put = df (F1 - F2 - K)
    put = call - df * (f1 - f2 - strike)
    return where_flag(is_call, call, put)


def spread_price_quad(
    spot1, spot2, strike, maturity, vol1, vol2, rho,
    rate=0.0, div1=0.0, div2=0.0, is_call=True, n_nodes: int = 128,
):
    """Near-exact spread option price by conditioning on S2's driver.

    With Z1 = rho Z2 + sqrt(1-rho^2) W, given Z2 = z the inner expectation
    E[(S1 - S2(z) - K)^+ | z] is a Black call with strike S2(z) + K, so the
    price is a 1D Gaussian integral on a fixed Gauss-Legendre panel over
    z in [-8, 8]; 128 nodes give ~1e-10 of forward.  Supports K < 0 (puts
    by parity stay exact).  Broadcasts over the spots, strike, maturity,
    vols and rho, the nodes on a trailing axis.
    """
    spot1, spot2, strike, maturity, vol1, vol2, rho = (
        x[..., None] for x in _tensors(spot1, spot2, strike, maturity, vol1, vol2, rho))
    x_np, w_np = _leggauss(n_nodes)
    z = to_tensor(x_np, spot1.dtype, spot1.device) * 8.0
    wz = to_tensor(w_np, spot1.dtype, spot1.device) * 8.0 * norm_pdf(z)

    rT = torch.sqrt(maturity)
    s2_z = spot2 * torch.exp((rate - div2 - 0.5 * vol2**2) * maturity + vol2 * rT * z)
    rbar = torch.sqrt(torch.clamp_min(1.0 - rho**2, 1e-14))
    # the conditional S1 forward given z: E[S1_T | Z2 = z]
    f1_z = spot1 * torch.exp((rate - div1 - 0.5 * vol1**2) * maturity
                             + vol1 * rT * rho * z + 0.5 * (vol1 * rbar) ** 2 * maturity)
    sig1 = torch.clamp_min(vol1 * rbar * rT, 1e-12)
    kk = s2_z + strike
    # the inner Black call on f1_z with strike kk; kk <= 0 -> always exercised
    safe_kk = torch.clamp_min(kk, 1e-300)
    d1 = torch.log(f1_z / safe_kk) / sig1 + 0.5 * sig1
    d2 = d1 - sig1
    inner = torch.where(kk > 0.0, f1_z * norm_cdf(d1) - kk * norm_cdf(d2), f1_z - kk)
    df = torch.exp(-rate * maturity[..., 0])
    call = df * torch.sum(wz * inner, dim=-1)
    spot1, spot2, strike, maturity = (x[..., 0] for x in (spot1, spot2, strike, maturity))
    f1 = spot1 * torch.exp((rate - div1) * maturity)
    f2 = spot2 * torch.exp((rate - div2) * maturity)
    put = call - df * (f1 - f2 - strike)
    return where_flag(is_call, call, put)


def rainbow_two_asset_price(
    spot1, spot2, strike, maturity, vol1, vol2, rho,
    rate=0.0, div1=0.0, div2=0.0, kind: str = "call_on_max",
):
    """Stulz (1982) two-asset rainbow options, exact by the bivariate CDF.

    ``kind``: ``call_on_max`` E[(max(S1,S2) - K)^+], ``call_on_min``
    E[(min(S1,S2) - K)^+], ``put_on_max``/``put_on_min`` by the parity
    put = call - (rainbow forward) + K e^{-rT}, the forwards of min/max
    from the K -> 0 calls.  Broadcasts over the spots, strike, maturity,
    vols and rho.
    """
    if kind not in ("call_on_max", "call_on_min", "put_on_max", "put_on_min"):
        raise ValueError(f"unknown rainbow kind {kind!r}")
    spot1, spot2, strike, maturity, vol1, vol2, rho = _tensors(
        spot1, spot2, strike, maturity, vol1, vol2, rho)

    def _call_on_min(k):
        st1 = torch.clamp_min(vol1 * torch.sqrt(maturity), 1e-12)
        st2 = torch.clamp_min(vol2 * torch.sqrt(maturity), 1e-12)
        sig2 = vol1**2 - 2.0 * rho * vol1 * vol2 + vol2**2
        st = torch.clamp_min(torch.sqrt(sig2 * maturity), 1e-12)
        f1 = spot1 * torch.exp((rate - div1) * maturity)
        f2 = spot2 * torch.exp((rate - div2) * maturity)
        k = torch.clamp_min(to_tensor(k, spot1.dtype, spot1.device), 1e-300)
        g1 = torch.log(f1 / k) / st1 + 0.5 * st1
        g2 = torch.log(f2 / k) / st2 + 0.5 * st2
        # Stulz arguments: d = ln(F1/F2)/st + st/2; the asset-measure tilts
        # shift it to -d (asset 1) and d - st (asset 2)
        d = torch.log(f1 / f2) / st + 0.5 * st
        r1 = (rho * vol2 - vol1) / torch.sqrt(sig2)   # = -rho1
        r2 = (rho * vol1 - vol2) / torch.sqrt(sig2)   # = -rho2
        df = torch.exp(-rate * maturity)
        return (df * f1 * bivariate_norm_cdf(g1, -d, r1)
                + df * f2 * bivariate_norm_cdf(g2, d - st, r2)
                - df * k * bivariate_norm_cdf(g1 - st1, g2 - st2, rho))

    from . import black_scholes as bs

    c1 = bs.price(spot1, strike, rate, div1, maturity, vol1, is_call=True)
    c2 = bs.price(spot2, strike, rate, div2, maturity, vol2, is_call=True)
    cmin = _call_on_min(strike)
    cmax = c1 + c2 - cmin
    if kind == "call_on_min":
        return cmin
    if kind == "call_on_max":
        return cmax
    df = torch.exp(-rate * maturity)
    fwd_min = _call_on_min(1e-300)          # E[e^{-rT} min(S1,S2)]
    f1 = spot1 * torch.exp(-div1 * maturity)
    f2 = spot2 * torch.exp(-div2 * maturity)
    fwd_max = f1 + f2 - fwd_min
    if kind == "put_on_min":
        return cmin - fwd_min + df * strike
    return cmax - fwd_max + df * strike


# ---------------------------------------------------------------------------
# Monte Carlo (exact terminal sampling: one product, no time stepping)


def _exp(x):
    """exp of a tensor, or of a plain number in float64 (the reference's
    weakly typed scalars), which rounds to float32 where it meets a path."""
    return torch.exp(x) if isinstance(x, torch.Tensor) else math.exp(x)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _chol_corr(corr):
    """Cholesky factor of a correlation matrix with the reference's 1e-12
    jitter, so a numerically semidefinite input (a rho = 1 pair) still
    factorizes in float64.  In float32 the jitter vanishes and such a pair
    is not positive definite: the factor is then NaN below the diagonal,
    as ``jnp.linalg.cholesky`` returns it, not an error."""
    n = corr.shape[-1]
    eye = torch.eye(n, dtype=corr.dtype, device=corr.device)
    return cholesky_nan(corr + 1e-12 * eye)


def sample_terminal_gbm(
    generator, spots, vols, corr, maturity, rate=0.0, dividends=0.0,
    n_paths: int = 131072, antithetic: bool = True, device=None,
):
    """Draw S_T for n correlated GBM assets: exact in distribution, no
    time-stepping bias, float32.

    Returns ``(s_t, z)`` with ``s_t`` of shape (n_paths, n_assets).  The
    correlation is applied as ``z @ L.T`` in full float32, and the same
    ``z`` is returned so control-variate payoffs reuse identical draws.
    With ``antithetic`` the second half of the paths is the negation of
    the first.  Runs on the first tensor's device among the inputs, else
    on ``device``, else on the card.
    """
    from ..calibrate.lm import _full_fp32_matmul  # calibrate imports the models

    device = device_of(spots, vols, corr, maturity, default=device)
    source = _draws(generator, device)
    f32 = torch.float32
    spots = to_tensor(spots, f32, device)
    vols = to_tensor(vols, f32, device)
    dividends = to_tensor(dividends, f32, device).expand(spots.shape)
    n_assets = spots.shape[0]
    if antithetic:
        z0 = source.normal((n_paths // 2, n_assets), f32, device)
        z = torch.cat([z0, -z0])
    else:
        z = source.normal((n_paths, n_assets), f32, device)
    L = _chol_corr(to_tensor(corr, f32, device))
    with _full_fp32_matmul():
        zc = z @ L.T
    drift = (rate - dividends - 0.5 * vols**2) * maturity
    s_t = spots[None, :] * torch.exp(drift[None, :] + _sqrt(maturity) * vols[None, :] * zc)
    return s_t, z


def _mc_mean_stderr(x, antithetic):
    """Mean and standard error; antithetic pairs averaged first so the
    stderr reflects the actual (paired) sampling distribution."""
    n = x.shape[0]
    if antithetic:
        half = n // 2
        x = 0.5 * (x[:half] + x[half:])
        n = half
    m = torch.mean(x, dim=0)
    se = torch.std(x, dim=0, correction=1) / math.sqrt(n)
    return m, se


def _squeezed(strikes, price, se):
    """``(price, se)`` shaped like ``strikes``."""
    if np.ndim(strikes) == 0:
        return price[0], se[0]
    return price, se


def price_basket_mc(
    generator, spots, weights, strikes, maturity, vols, corr,
    rate=0.0, dividends=0.0, is_call=True,
    n_paths: int = 131072, antithetic: bool = True,
    control_variate: bool = True, device=None,
):
    """Arithmetic-basket European option by exact terminal sampling.

    With ``control_variate`` two controls on the SAME draws are regressed
    out per strike (a 2x2 regression, vectorized over the ladder): the
    geometric basket, moment-matched so its forward equals the arithmetic
    forward (``(c G - K)^+ = c (G - K/c)^+``, so its exact expectation is
    :func:`geometric_basket_price` at the scaled strike), and the
    discounted basket level (exact expectation: the discounted arithmetic
    forward).  Returns ``(price, stderr)``, float32, shaped like
    ``strikes``.  The closed forms of the controls run in the inputs'
    precision (float64 for float64 tensors), as in the reference.
    """
    from ..calibrate.lm import _full_fp32_matmul

    device = device_of(spots, weights, strikes, maturity, vols, corr, default=device)
    generator = _draws(generator, device)
    f32 = torch.float32
    strikes_a = torch.atleast_1d(to_tensor(strikes, f32, device))
    weights = to_tensor(weights, f32, device)
    sign = _sign(is_call, (), torch.float32, device)
    s_t, _ = sample_terminal_gbm(generator, spots, vols, corr, maturity, rate, dividends,
                                 n_paths=n_paths, antithetic=antithetic, device=device)
    df = _exp(-rate * maturity)
    with _full_fp32_matmul():
        basket = s_t @ weights  # (paths,)
        pay = df * torch.clamp_min(sign * (basket[:, None] - strikes_a[None, :]), 0.0)
        if control_variate:
            dt = result_dtype(spots, vols, corr)
            spots_m, vols_m, corr_m = (to_tensor(a, dt, device) for a in (spots, vols, corr))
            m, s2 = _log_basket_moments(spots_m, weights, vols_m, corr_m, rate, dividends,
                                        maturity)
            divs_b = to_tensor(dividends, dt, device).expand(spots_m.shape)
            fwd_arith = torch.sum(weights * spots_m * torch.exp((rate - divs_b) * maturity))
            scale = (fwd_arith / torch.exp(m + 0.5 * s2)).to(f32)
            geo = scale * torch.exp(torch.log(torch.clamp_min(s_t, 1e-300)) @ weights)
            cv_pay = df * torch.clamp_min(sign * (geo[:, None] - strikes_a[None, :]), 0.0)
            cv_exact = scale * geometric_basket_price(
                spots_m, weights, strikes_a / scale, maturity, vols_m, corr_m, rate,
                dividends, is_call).to(pay.dtype)
            lvl = df * basket
            lvl_exact = df * fwd_arith.to(pay.dtype)
            c1 = cv_pay - cv_pay.mean(0)  # (paths, K)
            c2 = (lvl - lvl.mean())[:, None]  # (paths, 1)
            p0 = pay - pay.mean(0)
            v11 = torch.clamp_min(torch.mean(c1 * c1, dim=0), 1e-30)
            v12 = torch.mean(c1 * c2, dim=0)
            v22 = torch.clamp_min(torch.mean(c2 * c2), 1e-30)
            b1 = torch.mean(p0 * c1, dim=0)
            b2 = torch.mean(p0 * c2, dim=0)
            det = torch.clamp_min(v11 * v22 - v12 * v12, 1e-30)
            beta1 = (b1 * v22 - b2 * v12) / det
            beta2 = (v11 * b2 - v12 * b1) / det
            pay = (pay - beta1[None, :] * (cv_pay - cv_exact[None, :])
                   - beta2[None, :] * (lvl - lvl_exact)[:, None])
    return _squeezed(strikes, *_mc_mean_stderr(pay, antithetic))


def _pair(spot1, spot2, vol1, vol2, div1, div2, rho, device):
    """The two assets' spots, vols, dividends and correlation for
    :func:`sample_terminal_gbm` (float32, as there)."""
    f32 = torch.float32
    stack = lambda a, b: torch.stack([to_tensor(a, f32, device),  # noqa: E731
                                      to_tensor(b, f32, device)])
    rho = to_tensor(rho, f32, device)
    one = torch.ones_like(rho)
    corr = torch.stack([torch.stack([one, rho]), torch.stack([rho, one])])
    return stack(spot1, spot2), stack(vol1, vol2), stack(div1, div2), corr


def price_spread_mc(
    generator, spot1, spot2, strikes, maturity, vol1, vol2, rho,
    rate=0.0, div1=0.0, div2=0.0, is_call=True,
    n_paths: int = 131072, antithetic: bool = True,
    control_variate: bool = True, device=None,
):
    """Spread option E[e^{-rT}(S1 - S2 - K)^+] by exact terminal sampling,
    with the Margrabe exchange payoff (exact expectation, in the inputs'
    precision) as control variate.  Returns ``(price, stderr)``, float32,
    shaped like ``strikes``; cross-checks :func:`spread_price_quad`."""
    device = device_of(spot1, spot2, strikes, maturity, vol1, vol2, rho, default=device)
    generator = _draws(generator, device)
    strikes_a = torch.atleast_1d(to_tensor(strikes, torch.float32, device))
    sign = _sign(is_call, (), torch.float32, device)
    spots, vols, divs, corr = _pair(spot1, spot2, vol1, vol2, div1, div2, rho, device)
    s_t, _ = sample_terminal_gbm(generator, spots, vols, corr, maturity, rate, divs,
                                 n_paths=n_paths, antithetic=antithetic, device=device)
    df = _exp(-rate * maturity)
    spread = s_t[:, 0] - s_t[:, 1]
    pay = df * torch.clamp_min(sign * (spread[:, None] - strikes_a[None, :]), 0.0)
    if control_variate:
        cv_pay = df * torch.clamp_min(spread, 0.0)
        dt = result_dtype(spot1, spot2, maturity, vol1, vol2, rho)
        cv_exact = margrabe_price(*(to_tensor(a, dt, device) for a in (
            spot1, spot2, maturity, vol1, vol2, rho)), rate, div1, div2).to(pay.dtype)
        cov = torch.mean((pay - pay.mean(0)) * (cv_pay - cv_pay.mean())[:, None], dim=0)
        var = torch.clamp_min(torch.var(cv_pay, correction=0), 1e-30)
        beta = cov / var
        pay = pay - beta[None, :] * (cv_pay - cv_exact)[:, None]
    return _squeezed(strikes, *_mc_mean_stderr(pay, antithetic))


def price_rainbow_mc(
    generator, spot1, spot2, strikes, maturity, vol1, vol2, rho,
    rate=0.0, div1=0.0, div2=0.0, kind: str = "call_on_max",
    n_paths: int = 131072, antithetic: bool = True, device=None,
):
    """Two-asset rainbow by exact terminal sampling, the Monte Carlo twin
    of :func:`rainbow_two_asset_price`.  Returns ``(price, stderr)``,
    float32, shaped like ``strikes``."""
    device = device_of(spot1, spot2, strikes, maturity, vol1, vol2, rho, default=device)
    generator = _draws(generator, device)
    strikes_a = torch.atleast_1d(to_tensor(strikes, torch.float32, device))
    spots, vols, divs, corr = _pair(spot1, spot2, vol1, vol2, div1, div2, rho, device)
    s_t, _ = sample_terminal_gbm(generator, spots, vols, corr, maturity, rate, divs,
                                 n_paths=n_paths, antithetic=antithetic, device=device)
    sel = torch.amax(s_t, dim=1) if "max" in kind else torch.amin(s_t, dim=1)
    sign = 1.0 if kind.startswith("call") else -1.0
    df = _exp(-rate * maturity)
    pay = df * torch.clamp_min(sign * (sel[:, None] - strikes_a[None, :]), 0.0)
    return _squeezed(strikes, *_mc_mean_stderr(pay, antithetic))


# ---------------------------------------------------------------------------
# implied correlation
# ---------------------------------------------------------------------------


def implied_correlation(
    target_price, spot1, spot2, strike, maturity, vol1, vol2,
    rate=0.0, div1=0.0, div2=0.0, is_call=True, n_iter: int = 40,
):
    """Invert :func:`kirk_spread_price` for the flat correlation matching a
    quoted spread-option price.

    Spread prices DECREASE in rho, so a fixed-iteration bisection on
    [-0.999, 0.999] converges in 40 steps, masked arithmetic only, over a
    whole quote ladder at once.  The bracket is float32 whatever the
    inputs' precision (the reference's ``jnp.full_like`` on a float32
    view of the target), so the answer is good to float32's resolution.
    """
    device = device_of(target_price, spot1, spot2, strike, maturity, vol1, vol2)
    lo = torch.full_like(to_tensor(target_price, torch.float32, device), -0.999)
    hi = torch.full_like(lo, 0.999)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        p = kirk_spread_price(spot1, spot2, strike, maturity, vol1, vol2, mid,
                              rate, div1, div2, is_call)
        too_high = p > target_price  # price too high -> rho too low
        lo = torch.where(too_high, mid, lo)
        hi = torch.where(too_high, hi, mid)
    return 0.5 * (lo + hi)
