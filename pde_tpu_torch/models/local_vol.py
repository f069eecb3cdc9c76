"""Dupire local volatility, extracted by automatic differentiation, and
Monte Carlo under a local-vol surface (twin of
``pde_tpu/models/local_vol.py``).

The Dupire (1994) local variance

    sigma_loc^2(K, T) = (dC/dT + (r - q) K dC/dK + q C) / (K^2/2 d2C/dK2)

needs first and second derivatives of the call surface.  They come from
forward-mode AD through the pricer (``torch.func.jvp``, nested for the
second derivative), through its complex characteristic function.  The
pricers are elementwise in (K, T), so one jvp with a ones tangent gives
every point's own derivative: a whole (maturities x strikes) surface is
differentiated in one call, with no ``vmap``.

:func:`simulate_local_vol` marches log-Euler paths under a surface and
returns the Heston engine's :class:`~pde_tpu_torch.models.heston_mc.MCPaths`,
so every path-payoff estimator there prices under smile-consistent
dynamics through :func:`lv_simulate_fn`.
"""

from __future__ import annotations

import torch

from ..core.precision import EPS, device_of, resolve_device, result_dtype, to_tensor
from . import heston as heston_model

__all__ = [
    "local_vol_from_price_fn",
    "dupire_surface",
    "local_vol_from_implied_fn",
    "simulate_local_vol",
    "lv_simulate_fn",
    "SurfaceInterpolator",
]


def _d(fn, x):
    """Elementwise derivative of an elementwise ``fn`` at ``x`` (forward
    mode, ones tangent)."""
    return torch.func.jvp(fn, (x,), (torch.ones_like(x),))[1]


def _points(strike, maturity):
    rdt = result_dtype(strike, maturity)
    device = device_of(strike, maturity)
    # materialised: a dual tensor cannot be an expanded view
    return tuple(a.contiguous() for a in torch.broadcast_tensors(
        to_tensor(strike, rdt, device), to_tensor(maturity, rdt, device)))


def local_vol_from_price_fn(price_fn, strike, maturity, rate=0.0,
                            dividend=0.0, *, floor=1e-2, cap=4.0):
    """Dupire local vol at (K, T) from a differentiable, elementwise CALL
    price ``price_fn(K, T)``; ``strike`` and ``maturity`` broadcast.  The
    variance ratio is clamped to [floor^2, cap^2], and points where the
    surface carries no information (d2C/dK2 under the pricer's AD noise
    floor in the far wings) return **NaN**, which :func:`dupire_surface`
    fills from the nearest valid strike."""
    K, T = _points(strike, maturity)
    c = price_fn(K, T)
    dc_dt = _d(lambda t: price_fn(K, t), T)
    dc_dk = _d(lambda k: price_fn(k, T), K)
    d2c_dk2 = _d(lambda k: _d(lambda kk: price_fn(kk, T), k), K)
    num = dc_dt + (rate - dividend) * K * dc_dk + dividend * c
    den = 0.5 * K * K * d2c_dk2
    # information threshold: the second derivative must stand clear of the
    # pricer's own AD noise floor (quadrature round-off scales with eps)
    tiny = 200.0 * EPS(c.dtype)
    var = num / torch.clamp_min(den, 1e-300)
    ok = (den > tiny) & (num > 0.0) & torch.isfinite(var)
    var = torch.clamp(var, floor * floor, cap * cap)
    return torch.where(ok, torch.sqrt(var), torch.full_like(var, float("nan")))


def _fill_nan_nearest(row):
    """Replace NaNs with the nearest valid value along the last (strike)
    axis — flat wing extrapolation, from a running max of the last valid
    index and a running min of the next one."""
    n = row.shape[-1]
    idx = torch.arange(n, device=row.device).expand(row.shape)
    valid = ~torch.isnan(row)
    last = torch.cummax(torch.where(valid, idx, -1), dim=-1).values
    nxt = torch.cummin(torch.where(valid, idx, n).flip(-1), dim=-1).values.flip(-1)
    d_f = torch.where(last >= 0, idx - last, n + 1)
    d_b = torch.where(nxt < n, nxt - idx, n + 1)
    pick = torch.where(d_f <= d_b, last.clamp(0, n - 1), nxt.clamp(0, n - 1))
    return torch.where(valid, row, torch.gather(row, -1, pick))


def dupire_surface(params, strikes, maturities, spot, rate=0.0, dividend=0.0,
                   *, n_per_panel: int = 40, device=None, dtype=None):
    """Local-vol surface ``(len(maturities), len(strikes))`` from Heston
    parameters, priced through the CONVERGED composite-GL rule
    (:func:`~pde_tpu_torch.models.heston.price_accurate_gl`): differentiating
    twice in strike amplifies the reference grid's truncation bias into a
    visible density error.

    Runs on ``device`` (default: the CUDA card) in ``dtype`` (default: the
    inputs' tensor dtype, else torch's default float)."""
    device = resolve_device(device)
    dt = dtype or result_dtype(strikes, maturities, spot, params.kappa)
    Ks = to_tensor(strikes, dt, device)
    Ts = to_tensor(maturities, dt, device)
    K, T = (a.contiguous() for a in torch.broadcast_tensors(Ks[None, :], Ts[:, None]))

    def price_fn(k, t):
        return heston_model.price_accurate_gl(
            params, k, t, spot, rate, dividend, is_call=True,
            n_per_panel=n_per_panel)

    raw = local_vol_from_price_fn(price_fn, K, T, rate, dividend)
    # wings where the density underflowed come back NaN: flat-extrapolate
    # from the nearest informative strike, per maturity
    return _fill_nan_nearest(raw)


def local_vol_from_implied_fn(iv_fn, strike, maturity, spot, rate=0.0,
                              dividend=0.0, *, floor=1e-4, cap=4.0):
    """Dupire in implied-total-variance form (Gatheral 2006, Eq. 1.10) for
    a smooth, elementwise IV fit ``iv_fn(K, T)``.  With w(y, T) = iv^2 T at
    log-forward-moneyness y = ln(K/F(T)):

        sigma_loc^2 = dw/dT / [1 - y/w dw/dy
                               + 1/4 (-1/4 - 1/w + y^2/w^2) (dw/dy)^2
                               + 1/2 d2w/dy2]

    The T-derivative is at FIXED y.  NaN where the fit is
    arbitrage-inconsistent (denominator <= 0)."""
    K, T0 = _points(strike, maturity)
    spot = to_tensor(spot, K.dtype, K.device)

    def w_of(y, T):
        F = spot * torch.exp((rate - dividend) * T)
        iv = iv_fn(F * torch.exp(y), T)
        return iv * iv * T

    y0 = torch.log(K / (spot * torch.exp((rate - dividend) * T0)))
    w = w_of(y0, T0)
    dw_dt = _d(lambda t: w_of(y0, t), T0)
    dw_dy = _d(lambda y: w_of(y, T0), y0)
    d2w_dy2 = _d(lambda y: _d(lambda yy: w_of(yy, T0), y), y0)
    denom = (
        1.0
        - y0 / w * dw_dy
        + 0.25 * (-0.25 - 1.0 / w + (y0 * y0) / (w * w)) * dw_dy * dw_dy
        + 0.5 * d2w_dy2
    )
    var = dw_dt / torch.where(torch.abs(denom) > 1e-12, denom,
                              torch.full_like(denom, 1e-12))
    ok = (denom > 1e-6) & (dw_dt > 0.0) & torch.isfinite(var)
    var = torch.clamp(var, floor * floor, cap * cap)
    return torch.where(ok, torch.sqrt(var), torch.full_like(var, float("nan")))


def simulate_local_vol(vol_fn, spot, maturity, generator, *, n_steps: int = 64,
                       n_paths: int = 65536, rate=0.0, dividend=0.0,
                       antithetic: bool = True, device=None):
    """Log-Euler Monte Carlo under a local-vol surface: per step

        ln S += (r - q - 0.5 sigma^2(S, t)) dt + sigma(S, t) sqrt(dt) Z

    with ``vol_fn(s, t)`` (a :class:`SurfaceInterpolator` or any closure)
    evaluated at the left point of each step.  Returns
    :class:`~pde_tpu_torch.models.heston_mc.MCPaths` (the terminal
    ``variance`` field is sigma^2 at the terminal spot), so the exotic
    estimators and the delta-one control variate apply.

    ``generator`` is a ``torch.Generator`` on the path's device or a replay
    (:mod:`pde_tpu_torch.models.heston_mc`), split into ``n_steps`` step
    sources with one normal draw each, as the reference splits its key.
    Runs on the first tensor's device among ``spot`` and ``maturity``,
    else on ``device``, else on the card.
    """
    from .heston_mc import MCPaths, _draws

    dtype = result_dtype(spot, maturity)
    device = device_of(spot, maturity, default=device)
    source = _draws(generator, device)
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths

    T = to_tensor(maturity, dtype, device)
    dt_step = T / n_steps
    sq_dt = torch.sqrt(dt_step)
    drift_rq = to_tensor(rate, dtype, device) - to_tensor(dividend, dtype, device)
    s0 = to_tensor(spot, dtype, device)
    ln_s = torch.log(s0).expand(n_paths)
    s_sum = torch.zeros(n_paths, dtype=dtype, device=device)
    s_max = s_min = s0.expand(n_paths)
    ts = dt_step * torch.arange(n_steps, dtype=dtype, device=device)  # left points
    for t, k_t in zip(ts, source.split(n_steps)):
        z = k_t.normal((n_draw,), dtype, device)
        z = torch.cat([z, -z]) if antithetic else z
        sig = vol_fn(torch.exp(ln_s), t)
        ln_s = ln_s + (drift_rq - 0.5 * sig * sig) * dt_step + sig * sq_dt * z
        s = torch.exp(ln_s)
        s_sum = s_sum + s
        s_max = torch.maximum(s_max, s)
        s_min = torch.minimum(s_min, s)
    spot_T = torch.exp(ln_s)
    sig_T = vol_fn(spot_T, T)
    return MCPaths(spot_T, sig_T * sig_T, s_sum / n_steps, s_max, s_min)


def lv_simulate_fn(vol_fn):
    """Adapter making :func:`simulate_local_vol` a drop-in ``simulate_fn``
    for the :mod:`pde_tpu_torch.models.heston_mc` estimators, which pass a
    parameter record first (ignored here: the surface is the model; the
    estimators take ``params=None``) and ``device=``."""
    def fn(params, spot, maturity, generator, **kwargs):
        del params
        return simulate_local_vol(vol_fn, spot, maturity, generator, **kwargs)
    return fn


class SurfaceInterpolator:
    """Bilinear interpolation of a precomputed local-vol grid in (ln K, T),
    clamped outside the grid (flat extrapolation).

    The grid's tensors live on ``device`` (default: the device of the first
    tensor among ``vol_grid``, ``strikes``, ``maturities``, else the CUDA
    card) in ``dtype`` (default: ``vol_grid``'s if it is a tensor, else
    torch's default float)."""

    def __init__(self, strikes, maturities, vol_grid, device=None, dtype=None):
        if device is None:
            tensors = [a for a in (vol_grid, strikes, maturities)
                       if isinstance(a, torch.Tensor)]
            device = tensors[0].device if tensors else resolve_device(None)
        dtype = dtype or result_dtype(vol_grid)
        self.log_k = torch.log(to_tensor(strikes, dtype, device))
        self.t = to_tensor(maturities, dtype, device)
        self.vols = to_tensor(vol_grid, dtype, device)  # (n_T, n_K)

    def __call__(self, s, t):
        """sigma_loc at spot level(s) ``s`` and scalar time ``t``
        (``searchsorted`` left, as the reference)."""
        xk, tt = self.log_k, self.t
        x = torch.log(to_tensor(s, xk.dtype, xk.device))
        t = to_tensor(t, tt.dtype, tt.device)
        ix = torch.clamp(torch.searchsorted(xk, x.reshape(-1)).reshape(x.shape) - 1,
                         0, xk.shape[0] - 2)
        it = torch.clamp(torch.searchsorted(tt, t.reshape(-1)).reshape(t.shape) - 1,
                         0, tt.shape[0] - 2)
        wx = torch.clamp((x - xk[ix]) / (xk[ix + 1] - xk[ix]), 0.0, 1.0)
        wt = torch.clamp((t - tt[it]) / (tt[it + 1] - tt[it]), 0.0, 1.0)
        v00 = self.vols[it, ix]
        v01 = self.vols[it, ix + 1]
        v10 = self.vols[it + 1, ix]
        v11 = self.vols[it + 1, ix + 1]
        return ((1 - wt) * ((1 - wx) * v00 + wx * v01)
                + wt * ((1 - wx) * v10 + wx * v11))
